"""Shared neural-net primitives for the architecture pool.

Each layer is an `nn.Module` whose parameters carry the JAX package's
names (``w``, ``b``, ``scale``, ``bias``, ``table``), so a module path
such as ``layers.3.mamba.in_x.w`` names the reference's leaf
``["layers"]["mamba"]["in_x"]["w"][3]`` (see `convert`).  The
arithmetic lives in plain functions on tensors (`dense`, `rmsnorm`,
...), which the modules call.

Initialisation takes an explicit ``device`` and ``torch.Generator``.
It draws from the reference's distributions (a truncated normal in
[-2, 2] times ``d_in ** -0.5``), not its numbers: `convert` carries the
reference's own weights over where numbers must agree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import row_blocks


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for (device=None "
                           "means cuda) and no GPU is available; pass "
                           "device='cpu' to run on the host")
    return dev


def truncnorm(shape, scale: float, device, generator) -> torch.Tensor:
    """Truncated-normal fan-in init (MaxText-style): a standard normal
    cut to [-2, 2], times ``scale``.  On the meta device only the shape
    is made (`count_params`, `convert`)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.is_meta:
        return t
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# -------------------------------------------------------------- functions
def product(fn, a, b, *, rows=None):
    """``fn(a, b)``, a product of two operands of one type, with its
    products summed in float32 and the result rounded once to that type,
    as the reference's bf16 dots compute.  cuBLAS sums bf16 products in
    fp32; torch's bf16 product on the CPU (oneDNN) sums in an order of
    its own that parts from an fp32 sum by an ulp now and then (enough to
    move a tied unembedding's logits by ~0.1), so there the operands are
    cast to float32 first, and with ``rows`` (the dim of ``a`` whose
    entries are independent rows, and the result's dim they become) the
    product takes them by `kernels.row_blocks`, so that a row's value
    does not depend on the rows beside it."""
    if a.device.type == "cpu" and a.dtype in (torch.bfloat16, torch.float16):
        b32 = b.float()
        if rows is None:
            return fn(a.float(), b32).to(a.dtype)
        return row_blocks(lambda u: fn(u, b32), a.float(), *rows) \
            .to(a.dtype)
    return fn(a, b)


def scores(eq: str, a, b, *, rows: str):
    """``torch.einsum(eq, a, b)`` on float32 copies of both operands, the
    result in float32: the reference's fp32 products of bf16 values
    (attention logits, the router's, a tied unembedding's), on the CPU
    by `kernels.row_blocks` along ``rows`` (a letter of ``a``'s)."""
    b = b.float()
    return row_blocks(lambda u: torch.einsum(eq, u, b), a.float(),
                      *_row_dims(eq, rows))


def einsum(eq: str, a, b, *, rows: str):
    """``torch.einsum(eq, a, b)`` summed as `product` sums; ``rows``: the
    letter of ``a``'s independent rows."""
    return product(lambda u, v: torch.einsum(eq, u, v), a, b,
                   rows=_row_dims(eq, rows))


def _row_dims(eq: str, letter: str) -> tuple[int, int]:
    """(``letter``'s dim in the first operand, its dim in the result)."""
    ins, out = eq.split("->")
    return ins.split(",")[0].index(letter), out.index(letter)


def dense(w, b, x, *, compute_dtype=torch.bfloat16):
    """x: (..., d_in) @ w: (d_in, *out) -> (..., *out), computed in
    ``compute_dtype`` (both operands cast, the result in that type)."""
    w = w.to(compute_dtype)
    y = product(lambda u, v: torch.tensordot(u, v, dims=([1], [0])),
                x.to(compute_dtype).reshape(-1, x.shape[-1]), w,
                rows=(0, 0)).reshape(*x.shape[:-1], *w.shape[1:])
    if b is not None:
        y = y + b.to(compute_dtype)
    return y


def rmsnorm(scale, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * scale
    return y.to(dt)


def layernorm(scale, bias, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim))


def apply_rope(x, positions, *, theta: float = 10000.0,
               mrope_sections: tuple[int, ...] | None = None):
    """Rotary embedding.

    x: (B, S, H, D); positions: (B, S) int, or (3, B, S) for M-RoPE
    (temporal/height/width position streams, qwen2-vl §2.1).  With
    ``mrope_sections=(t, h, w)`` (pairs, summing to D/2) frequency bands
    are split across the three streams.
    """
    d = x.shape[-1]
    inv = torch.from_numpy(rope_freqs(d, theta)).to(x.device)   # (D/2,)
    if mrope_sections is None:
        ang = positions[..., None].float() * inv                 # (B,S,D/2)
    else:
        if positions.dim() != 3 or sum(mrope_sections) != d // 2:
            raise ValueError("M-RoPE takes (3, B, S) positions and "
                             "sections summing to D/2")
        ang3 = positions[..., None].float() * inv                # (3,B,S,D/2)
        sec = np.cumsum((0,) + tuple(mrope_sections))
        ang = torch.cat([ang3[i, ..., sec[i]:sec[i + 1]] for i in range(3)],
                        dim=-1)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x):
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), op by op in
    x's type: the reference's ``jax.nn.silu`` rounds so on the CPU (a
    fused sigmoid differs from it in the last bf16 bit for a third of
    the inputs, and the difference grows through the layers)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x):
    """log(1 + e^x) as ``jnp.logaddexp(x, 0)`` computes it, op by op in
    x's type: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def gelu(x):
    """``jax.nn.gelu``'s default tanh form, x * 0.5 (1 + tanh(sqrt(2/pi)
    (x + 0.044715 x^3))), op by op in x's type with both constants
    rounded to it first, as the reference rounds on the CPU: this equals
    it bit for bit in bf16 but for denormal inputs (which the reference's
    CPU flushes to zero), where ``F.gelu`` (rounded once) differs in the
    last bit for 43% of the inputs."""
    c = torch.tensor(np.sqrt(2 / np.pi)).to(x.dtype)
    k = torch.tensor(0.044715).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def embed(table, tokens, compute_dtype=torch.bfloat16):
    return table[tokens].to(compute_dtype)


def unembed(table, x, compute_dtype=torch.bfloat16,
            logits_dtype=torch.float32):
    """Logits against the (possibly tied) embedding table, with
    products in ``logits_dtype`` after casting to ``compute_dtype`` (on
    the CPU as `scores` and `einsum` take them)."""
    x, table = x.to(compute_dtype), table.to(compute_dtype)
    if logits_dtype == torch.float32:
        return scores("bsd,vd->bsv", x, table, rows="s")
    return einsum("bsd,vd->bsv", x.to(logits_dtype), table.to(logits_dtype),
                  rows="s")


def causal_conv1d(w, b, x):
    """Depthwise causal conv over sequence. x: (B, S, C); w: (W, C)."""
    w = w.to(x.dtype)
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:x.shape[1], :] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b.to(x.dtype)


def causal_conv1d_step(w, b, x_t, conv_state):
    """Single decode step. x_t: (B, C); conv_state: (B, W-1, C)."""
    w = w.to(x_t.dtype)
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B,W,C)
    ct = torch.promote_types(window.dtype, w.dtype)
    y = torch.einsum("bwc,wc->bc", window.to(ct), w.to(ct)) + b.to(x_t.dtype)
    return y, window[:, 1:, :]


# ---------------------------------------------------------------- modules
class Dense(nn.Module):
    """``d_out`` may be an int or a tuple (e.g. (heads, head_dim))."""

    def __init__(self, d_in: int, d_out, *, bias: bool = False,
                 device=None, generator=None):
        super().__init__()
        out_shape = (d_out,) if isinstance(d_out, int) else tuple(d_out)
        self.w = _param(truncnorm((d_in, *out_shape), d_in ** -0.5, device,
                                  generator))
        self.b = _param(torch.zeros(out_shape, device=device)) \
            if bias else None

    def forward(self, x):
        return dense(self.w, self.b, x)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device))
        self.bias = _param(torch.zeros(d, device=device))

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, gated: bool = True,
                 bias: bool = False, device=None, generator=None):
        super().__init__()
        kw = dict(bias=bias, device=device, generator=generator)
        self.up = Dense(d_model, d_ff, **kw)
        self.down = Dense(d_ff, d_model, **kw)
        self.gate = Dense(d_model, d_ff, **kw) if gated else None

    def forward(self, x, act=silu):
        up = self.up(x)
        up = act(self.gate(x)) * up if self.gate is not None else act(up)
        return self.down(up)


class Embed(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, device=None,
                 generator=None):
        super().__init__()
        self.table = _param(truncnorm((vocab, d_model), 1.0, device,
                                      generator))

    def forward(self, tokens):
        return embed(self.table, tokens)


class CausalConv1d(nn.Module):
    def __init__(self, channels: int, width: int, *, device=None,
                 generator=None):
        super().__init__()
        self.w = _param(truncnorm((width, channels), width ** -0.5, device,
                                  generator))
        self.b = _param(torch.zeros(channels, device=device))

    def forward(self, x):
        return causal_conv1d(self.w, self.b, x)

    def step(self, x_t, conv_state):
        return causal_conv1d_step(self.w, self.b, x_t, conv_state)
