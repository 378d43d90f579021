"""The grouped (ragged) matrix product of the MoE FFN — see
`csrc/ragged_dot.cu` (the CUDA kernel), `ref` (its plain torch
version) and `ops` (the wrapper)."""

from . import ops, ref  # noqa: F401
from .ops import ragged_dot

__all__ = ["ragged_dot"]
