"""The LLM half of the port: layers, attention, the Mamba2 block, the
unified stack (`transformer.forward`), the model entry points (`model`)
and the weight carry-over from the JAX package's parameter tree
(`convert`).  Every family is ported for serving: ``hybrid`` (zamba2),
``ssm`` (mamba2), ``dense`` (gemma3, qwen1.5, glm4, starcoder2, and
qwen2-vl with its vision prefix), ``moe`` (mixtral, deepseek-v2-lite)
and ``encdec`` (whisper).  Training (`model.loss_fn`,
`model.make_train_step`) runs on every family, on the CPU and on the
card, where the SSD scan, the MoE's grouped products and flash
attention (past 4096^2 (query, key) pairs) run hand-written backward
kernels under autograd."""
