"""Device SBTS step primitive — see `csrc/selection_counts.cu` (the CUDA
kernel), `ref` (its plain torch version) and `ops` (the wrapper)."""

from .ops import selection_counts

__all__ = ["selection_counts"]
