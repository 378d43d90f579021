"""The LLM half of the port: layers, attention, the Mamba2 block, the
unified stack (`transformer.forward`), the model entry points (`model`)
and the weight carry-over from the JAX package's parameter tree
(`convert`).  Only the ``hybrid`` family (zamba2) is ported; the others
raise `NotImplementedError`."""
