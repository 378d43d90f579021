"""The LLM half of the port: layers, attention, the Mamba2 block, the
unified stack (`transformer.forward`), the model entry points (`model`)
and the weight carry-over from the JAX package's parameter tree
(`convert`).  The ``hybrid`` (zamba2), ``ssm`` (mamba2) and ``dense``
(gemma3, qwen1.5, glm4, starcoder2) families are ported, for serving;
the others, and training, raise `NotImplementedError`."""
