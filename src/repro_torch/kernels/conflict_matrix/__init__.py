"""The conflict graph's occupancy/clique predicate over every vertex
pair — see `csrc/conflict_matrix.cu` (the CUDA kernels, dense and
packed), `ref` (the numpy oracle and the plain torch versions) and
`ops` (the wrappers and the vertex-level entry points)."""

from . import ops, ref  # noqa: F401
from .ops import (conflict_matrix, conflict_matrix_dense,
                  conflict_matrix_packed, conflict_matrix_words)

__all__ = ["conflict_matrix", "conflict_matrix_dense",
           "conflict_matrix_packed", "conflict_matrix_words"]
