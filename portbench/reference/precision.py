"""The products of the plain reference, in one of two precisions.

- ``float32``: every product in float32, TF32 off (`fp32_products`
  turns it off for the card's matmuls).
- ``float8``: the correctness check's control.  The configurations state
  bfloat16 products (bf16 operands, float32 sums); the nearest precision
  below is float8.  Each operand of each product, in the forward and in
  both gradient products of the backward, is rounded to float8 e4m3 under
  a per-tensor scale (its largest magnitude onto e4m3's 448), and the
  product of the rounded operands is taken in float32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_products():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_e4m3(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _F8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_e4m3(a), to_e4m3(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = to_e4m3(g)
        return (torch.matmul(g8, to_e4m3(b).transpose(-1, -2)),
                torch.matmul(to_e4m3(a).transpose(-1, -2), g8))


class Products:
    """``mm`` (`torch.matmul`: 2-D, or batched over matching leading
    dims) in the named precision: "float32" or "float8"."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def mm(self, a, b):
        if self.precision == "float8":
            return _F8Matmul.apply(a, b)
        return a @ b
