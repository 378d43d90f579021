"""Forward flash attention (GQA, causal from ``q_offset``, sliding
window) — see `csrc/flash_attention.cu` (the CUDA kernel), `ref` (its
plain torch version) and `ops` (the wrapper)."""

from . import ops, ref  # noqa: F401
from .ops import flash_attention

__all__ = ["flash_attention"]
