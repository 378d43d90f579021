"""Plain float32 PyTorch models of the benchmark's configurations: the
layer functions that the families share, and the next-token loss.  Each
family's parameters and forward pass are in
``reference/families/<family>.py``, found by the configuration's
``family``: `ssm` (Mamba2 layers, attention-free, by the Mamba2 paper,
arXiv:2405.21060) and `dense` (pre-norm GQA blocks and an MLP).

It imports no part of the program under test.  Weights are a dict of
name -> float32 tensor under the program's parameter names (`param_specs`
lists them), made by the benchmark (`bench.weights`).  Every product goes
through a `Products` object: float32 with TF32 off, or the control's
float8 (`reference.precision`).

Memory: each layer runs under a non-reentrant activation checkpoint
(``remat=True``), and attention runs in blocks of queries, each under its
own checkpoint, so that a step at 8192 tokens fits beside the weights,
gradients and AdamW's state.
"""

from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Products

#: Queries an attention block takes at once.
ATTN_BLOCK = 1024
#: z-loss weight of the loss (the program's `loss_fn` default).
Z_WEIGHT = 1e-4


# -------------------------------------------------------------- functions
def rmsnorm(scale, x, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def layernorm(scale, bias, x, eps: float):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """GELU's tanh form: x/2 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) *
                                       (x + 0.044715 * x ** 3)))


def dense(pr: Products, x, w):
    """x (..., d_in) times w (d_in, *out)."""
    y = pr.mm(x.reshape(-1, x.shape[-1]), w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def causal_conv(w, b, x):
    """Depthwise causal convolution over the sequence: x (B, S, C), w
    (W, C): out_t = sum_i w_i x_{t - W + 1 + i} + b."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = b
    for i in range(width):
        out = out + pad[:, i:i + s] * w[i]
    return out


def ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """The SSD scan, y_t = C_t h_t with h_t = exp(dt_t A) h_{t-1} + dt_t
    x_t B_t^T and A = -exp(a_log), in its chunked form: within a chunk
    the decay-weighted scores C B^T (per group, over the chunk's causal
    pairs) times x, across chunks the carried states.  x (B, S, H, P), dt
    (B, S, H), b and c (B, S, G, N); S a multiple of ``chunk``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, h // g
    a = -torch.exp(a_log)
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, g, n)
    cc = c.reshape(bsz, nc, chunk, g, n)
    cum = torch.cumsum(dtc * a, dim=2)                       # (B,nc,L,H)
    cum_h = cum.movedim(-1, -2)                              # (B,nc,H,L)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    decay = torch.exp(torch.where(
        tril, cum_h[..., :, None] - cum_h[..., None, :], -math.inf))
    scores = torch.einsum("bzign,bzjgn->bzgij", cc, bc)       # per group
    scores = torch.repeat_interleave(scores, rep, dim=2)      # (B,nc,H,L,L)
    gates = scores * decay * dtc.movedim(-1, -2)[..., None, :]
    y = torch.einsum("bzhij,bzjhp->bzihp", gates, xc)
    total = cum[:, :, -1:, :]
    w = dtc * torch.exp(total - cum)                         # (B,nc,L,H)
    bh = torch.repeat_interleave(bc, rep, dim=3)              # (B,nc,L,H,N)
    ch = torch.repeat_interleave(cc, rep, dim=3)
    states = torch.einsum("bzjhn,bzjhp->bzhpn", bh * w[..., None], xc)
    chunk_decay = torch.exp(total[:, :, 0, :])               # (B,nc,H)
    carry = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev = torch.stack(prev, dim=1)                          # (B,nc,H,P,N)
    y = y + torch.einsum("bzihn,bzhpn->bzihp", ch, prev) * \
        torch.exp(cum)[..., None]
    return y.reshape(bsz, s, h, p)


def rope(x, positions, theta: float):
    """Rotary embedding on the two halves of the head: x (B, S, H, D)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[:, None] * inv                   # (S, D/2)
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(pr: Products, q, k, v, *, window: int | None = None,
                     remat: bool):
    """softmax(Q K^T / sqrt(D)) V over the causal pairs, Q (B, S, H, D),
    K and V (B, S, Hkv, D), each query head on key head h // (H / Hkv).
    With a ``window``, query i sees the keys j with 0 <= i - j < window.
    In blocks of `ATTN_BLOCK` queries, each over the keys from the
    block's first visible one to its last query (the pairs in that range
    that the mask hides are computed and thrown away)."""
    bsz, s, h, d = q.shape
    rep = h // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2).transpose(1, 2)  # (B,H,S,D)
    v = torch.repeat_interleave(v, rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    scale = d ** -0.5

    def block(qb, kb, vb, q0: int, k0: int):
        logits = pr.mm(qb, kb.transpose(-1, -2)) * scale     # (B,H,q,k)
        qpos = q0 + torch.arange(qb.shape[2], device=qb.device)
        kpos = k0 + torch.arange(kb.shape[2], device=qb.device)
        seen = qpos[:, None] >= kpos[None, :]
        if window:
            seen = seen & (qpos[:, None] - kpos[None, :] < window)
        logits = torch.where(seen, logits, -math.inf)
        return pr.mm(torch.softmax(logits, dim=-1), vb)

    outs = []
    for q0 in range(0, s, ATTN_BLOCK):
        q1 = min(q0 + ATTN_BLOCK, s)
        k0 = max(0, q0 - window + 1) if window else 0
        args = (q[:, :, q0:q1], k[:, :, k0:q1], v[:, :, k0:q1], q0, k0)
        outs.append(checkpoint(block, *args, use_reentrant=False)
                    if remat else block(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)            # (B,S,H,D)


# ---------------------------------------------------------------- families
def family(cfg: dict):
    """The module ``reference/families/<family>.py`` of ``cfg``'s family:
    ``param_specs(cfg)`` and ``forward(cfg, pr, w, tokens, remat=)``."""
    try:
        return importlib.import_module(
            f"{__package__}.families.{cfg['family']}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no reference for family {cfg['family']!r}") \
            from e


def param_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init kind) of every parameter, in the program's
    order and under its names.  Kinds: ``fan_in`` (a truncated normal
    times shape[0] ** -0.5), ``table`` (a truncated normal times 0.02),
    ``ones``, ``zeros``, ``a_log``, ``dt_bias`` (`bench.weights`)."""
    return family(cfg).param_specs(cfg)


def forward(cfg: dict, pr: Products, w: dict, tokens, *, remat: bool = True):
    """Logits (B, S, vocab) float32 of ``tokens`` (B, S)."""
    return family(cfg).forward(cfg, pr, w, tokens, remat=remat)


def run(fn, *args, remat: bool):
    """``fn(*args)``, under a non-reentrant checkpoint with ``remat``."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def unembed(cfg: dict, pr: Products, w: dict, x):
    """The logits' product against the unembedding, or the embedding
    table where the two are tied."""
    table = w["embed.table"].t() if cfg["tie_embeddings"] else w["unembed.w"]
    return dense(pr, x, table)


def loss(cfg: dict, pr: Products, w: dict, batch: dict, *,
         remat: bool = True):
    """Mean next-token cross entropy over the labels >= 0, plus
    `Z_WEIGHT` times the mean squared log-partition."""
    logits = forward(cfg, pr, w, batch["tokens"], remat=remat)
    labels = batch["labels"].long()
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    count = valid.sum().clamp(min=1)
    ce = ((logz - ll) * valid).sum() / count
    return ce + Z_WEIGHT * ((logz * valid) ** 2).sum() / count
