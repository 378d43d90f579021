"""The plain torch version of the grouped (ragged) matrix product.

`ragged_dot_ref(x, w, group_offsets)` computes what
``jax.lax.ragged_dot(x, w, group_sizes)`` computes for the MoE FFN
(`repro/models/moe.py:67-73`): rows of x sorted by group, group g the
rows ``[offsets[g], offsets[g + 1])`` times ``w[g]`` rounded to x's
type (the reference casts the weights to the compute type before the
call; float32 weights with bfloat16 x are rounded here, as the kernel
rounds them on load); each group's product in float32, rounded once to
x's type; rows outside
``[offsets[0], offsets[G])`` zero.  It reads the offsets on the host
(one sync a call), which is what the CUDA kernel avoids.
"""

from __future__ import annotations

import torch


def ragged_dot_ref(x: torch.Tensor, w: torch.Tensor,
                   group_offsets: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (G, K, N), group_offsets (G + 1,) int -> (M, N) in
    x's type."""
    m, n = x.shape[0], w.shape[2]
    out = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    offs = group_offsets.tolist()
    prev = 0
    for g in range(w.shape[0]):
        lo = min(max(offs[g], prev), m)
        hi = min(max(offs[g + 1], lo), m)
        prev = hi
        if hi > lo:
            out[lo:hi] = (x[lo:hi].float() @ w[g].to(x.dtype).float()) \
                .to(x.dtype)
    return out
