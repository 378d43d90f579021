"""The LLM half of the port: layers, attention, the Mamba2 block, the
unified stack (`transformer.forward`), the model entry points (`model`)
and the weight carry-over from the JAX package's parameter tree
(`convert`).  Every family is ported for serving: ``hybrid`` (zamba2),
``ssm`` (mamba2), ``dense`` (gemma3, qwen1.5, glm4, starcoder2, and
qwen2-vl with its vision prefix), ``moe`` (mixtral, deepseek-v2-lite)
and ``encdec`` (whisper).  Training (`model.loss_fn`,
`model.make_train_step`) runs on every family on the CPU; on the card
the ``moe`` family and attention past 4096^2 (query, key) pairs raise
until their backward kernels exist (ROADMAP Queue 2)."""
