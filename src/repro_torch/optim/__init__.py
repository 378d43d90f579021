"""The optimizer of the training path: AdamW with global-norm clipping
and a cosine schedule (`adamw`), and int8 block compression of
gradients with error feedback (`compression`), as the JAX package's
``repro.optim`` computes them, over dicts of tensors keyed by the
model's parameter names."""

from .adamw import AdamW, cosine_schedule  # noqa: F401
from .compression import (compress_grads, decompress_grads,  # noqa: F401
                          error_feedback_update)
