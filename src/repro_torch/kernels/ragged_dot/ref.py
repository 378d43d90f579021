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

from repro_torch.kernels import row_blocks


def group_rows(group_offsets: torch.Tensor, m: int):
    """Each group's rows ``(g, lo, hi)``, clamped as the kernels clamp
    them: a group starts where the one before it ended, and no row past
    M (offsets that go down make empty groups)."""
    offs = group_offsets.tolist()
    prev = 0
    for g in range(len(offs) - 1):
        lo = min(max(offs[g], prev), m)
        hi = min(max(offs[g + 1], lo), m)
        prev = hi
        yield g, lo, hi


def ragged_dot_ref(x: torch.Tensor, w: torch.Tensor,
                   group_offsets: torch.Tensor, *,
                   acc: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K), w (G, K, N), group_offsets (G + 1,) int -> (M, N) in
    x's type, each product summed in ``acc`` (float64: the exact sums
    rounded once, which the card's fp32 checks hold the kernels to).
    Each group's rows are taken by `kernels.row_blocks`, so on the CPU a
    row's sum does not depend on its group's size."""
    m, n = x.shape[0], w.shape[2]
    out = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    for g, lo, hi in group_rows(group_offsets, m):
        if hi > lo:
            wg = w[g].to(x.dtype).to(acc)
            out[lo:hi] = row_blocks(lambda u: (u.to(acc) @ wg).to(x.dtype),
                                    x[lo:hi])
    return out


def ragged_dot_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                       group_offsets: torch.Tensor, dy: torch.Tensor, *,
                       acc: torch.dtype = torch.float32):
    """The gradients of `ragged_dot_ref` given dy (M, N): (dx (M, K) in
    x's type, zero outside the groups; dw (G, K, N) in w's type, each
    group's sum rounded to x's type first, zero for an empty group),
    summed in ``acc``."""
    return (ragged_dot_dx_ref(x, w, group_offsets, dy, acc=acc),
            ragged_dot_dw_ref(x, w, group_offsets, dy, acc=acc))


def ragged_dot_dx_ref(x, w, group_offsets, dy, *,
                      acc: torch.dtype = torch.float32) -> torch.Tensor:
    """dx alone: dy w[g]^T for each row's group (`ragged_dot_bwd_ref`)."""
    dx = torch.zeros_like(x)
    dya = dy.to(acc)
    for g, lo, hi in group_rows(group_offsets, x.shape[0]):
        if hi > lo:
            dx[lo:hi] = (dya[lo:hi] @ w[g].to(x.dtype).to(acc).T) \
                .to(x.dtype)
    return dx


def ragged_dot_dw_ref(x, w, group_offsets, dy, *,
                      acc: torch.dtype = torch.float32) -> torch.Tensor:
    """dw alone: x[rows_g]^T dy[rows_g] for each group
    (`ragged_dot_bwd_ref`)."""
    dw = torch.zeros_like(w)
    dya = dy.to(acc)
    for g, lo, hi in group_rows(group_offsets, x.shape[0]):
        if hi > lo:
            dw[g] = (x[lo:hi].to(acc).T @ dya[lo:hi]).to(x.dtype)
    return dw
