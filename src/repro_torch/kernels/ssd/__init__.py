"""The Mamba2 SSD chunked scan — see `csrc/ssd.cu` (the CUDA kernel),
`ref` (its plain torch version and the decode step) and `ops` (the
wrapper)."""

from . import ops, ref  # noqa: F401
from .ops import ssd

__all__ = ["ssd"]
