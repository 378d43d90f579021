"""Plain torch version of the sbts_step conflict-count kernel.

Torch has no popcount and no uint32 shift on the CPU, so the words stay
bit-reinterpreted ``int32`` and the popcount is SWAR arithmetic in
which every term stays non-negative and below 2**31: the word is split
into its even and odd bits first, so no addition can overflow, and each
arithmetic right shift is masked before it is used.
"""

from __future__ import annotations

import torch

# Bound on the [kc, n, W] intermediate (elements), so a large K is
# processed in slices instead of one multi-GB temporary: small enough
# to stay in a CPU's caches, large enough on a GPU that the slices do
# not turn into a storm of tiny launches.
_CHUNK_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 26}


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (0..32), computed in place: ``x`` is
    overwritten and returned."""
    m1, m2, m4 = 0x55555555, 0x33333333, 0x0F0F0F0F
    b = x >> 1
    b &= m1                          # odd bits, moved to even places
    x &= m1                          # even bits
    y = x >> 2
    y &= m2
    x &= m2
    y += x                           # nibble sums <= 2
    x = b >> 2
    x &= m2
    b &= m2
    y += x
    y += b                           # nibble sums <= 4: y <= 0x44444444
    x = y >> 4
    x &= m4
    y &= m4
    y += x                           # byte sums <= 8
    y += y >> 8
    y += y >> 16
    y &= 0x3F
    return y


def selection_counts_plain(rows32: torch.Tensor,
                           sel32: torch.Tensor) -> torch.Tensor:
    """``int32 [K, n]`` of ``sum_w popcount(rows32[v, w] & sel32[k, w])``
    — |N(v) ∩ S_k| for every (trajectory, vertex) pair."""
    n, w = rows32.shape
    k = sel32.shape[0]
    out = torch.empty((k, n), dtype=torch.int32, device=rows32.device)
    step = max(1, _CHUNK_ELEMS.get(rows32.device.type, 1 << 20)
               // max(1, n * w))
    for k0 in range(0, k, step):
        hits = sel32[k0:k0 + step, None, :] & rows32[None, :, :]
        out[k0:k0 + step] = popcount32(hits).sum(dim=-1,
                                                 dtype=torch.int32)
    return out
