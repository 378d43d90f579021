"""TF32 rounding and split products, as the port's fp32 kernels take
them on the tensor cores (``src/repro_torch/kernels/csrc/tf32_mma.cuh``):
the emulations in tests/test_torch_flash_attention.py and
tests/test_torch_ssd.py are built from these."""

from __future__ import annotations

import torch


def tf32(x):
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits): round to
    nearest, ties to even, on the 13 dropped bits (held in fp32)."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """``x`` as two TF32 values hi + lo: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_mm(eq, a, b, passes=3):
    """``einsum(eq, a, b)`` of fp32 operands as the kernels take it on
    TF32 tensor cores: hi hi (exact products, fp32 sums), plus, summed
    apart and added last, hi lo (``passes`` >= 2) and lo hi (3)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    big = torch.einsum(eq, ah, bh)
    if passes == 1:
        return big
    small = torch.einsum(eq, ah, bl)
    if passes == 3:
        small = small + torch.einsum(eq, al, bh)
    return big + small
