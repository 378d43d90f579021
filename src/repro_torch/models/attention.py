"""Attention for the architecture pool:

- GQA (grouped-query) with optional QKV bias, RoPE / M-RoPE, causal and
  sliding-window masks — zamba2's shared attention block and the dense
  and moe families' layers (mixtral: a 4096 window on every layer);
- MLA (multi-head latent attention, DeepSeek-V2): a low-rank compressed
  KV cache (c_kv, k_pe), with both the naive decode path (materialise K
  and V) and the *absorbed* one (attention in the latent space);
- cross-attention (whisper's decoder) over the encoder's keys and values,
  computed once per layer (`CrossAttention.encode`).

GQA's long sequences go to the flash-attention kernel
(`repro_torch.kernels.flash_attention`: the CUDA kernel for tensors on
the card, its plain torch version on the CPU), at the reference's
thresholds; short ones and every cached step take the plain masked
product `sdpa`, as the reference does.  MLA always takes `sdpa`, as the
reference does (V's width is not Q's and K's), and so does
cross-attention, unmasked, at any length.

Shapes follow (B, S, H, D); KV caches are (B, S_max, H_kv, D).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops

from .layers import Dense, apply_rope, einsum, scores


# ------------------------------------------------------------------ masking
def causal_window_mask(q_pos, k_pos, window):
    """(..., S_q, S_k) bool mask.  window: None or an int; values <= 0
    mean plain causal."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None and window > 0:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def sdpa(q, k, v, mask, *, scale=None, logit_cap: float | None = None):
    """Masked softmax(QK^T)V with GQA head broadcasting.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); mask: (B or 1, 1, Sq, Sk).
    Logits and softmax in fp32; the weights take v's type for the
    product with v, as in the reference.  Memory O(Sq*Sk).
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qh = q.reshape(b, sq, hkv, g, d)
    logits = scores("bqhgd,bkhd->bhgqk", qh, k, rows="q") * scale
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if mask.dim() != 4 or mask.shape[1] != 1:
        raise ValueError(f"mask must be (B, 1, Sq, Sk), got "
                         f"{tuple(mask.shape)}")
    logits = torch.where(mask[:, :, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bhgqk,bkhd->bqhgd", w, v, rows="q")
    return out.reshape(b, sq, hq, v.shape[-1])


def _flash_or_sdpa(q, k, v, *, q_offset: int, window, flash_block: int):
    """Dispatch: flash attention for long sequences, plain SDPA for short
    ones (and for decode where Sq is tiny)."""
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk > 4096 * 4096 or (sq == 1 and sk > 8192):
        return fa_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            q_offset=q_offset, window=window, block_k=flash_block)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = causal_window_mask(q_pos, k_pos, window)[None, None]
    return sdpa(q, k, v, mask)


# ---------------------------------------------------------------------- GQA
class GQA(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, qkv_bias: bool = False, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.q = Dense(d_model, (n_heads, head_dim), bias=qkv_bias, **kw)
        self.k = Dense(d_model, (n_kv, head_dim), bias=qkv_bias, **kw)
        self.v = Dense(d_model, (n_kv, head_dim), bias=qkv_bias, **kw)
        self.o = Dense(n_heads * head_dim, d_model, **kw)

    def forward(self, x, positions, *, n_heads: int, n_kv: int,
                head_dim: int, rope_theta: float = 10000.0,
                window: int | None = None,
                mrope_sections: tuple[int, ...] | None = None,
                cache: dict | None = None, flash_block: int = 512):
        """Returns (out, new_cache).  cache = {"k", "v": (B, S_max, Hkv,
        D), "pos": int} for decode and cached prefill, updated in place
        (the returned cache holds the same tensors and the new ``pos``);
        None for the no-cache forward (full causal self-attention)."""
        q = self.q(x)                              # (B,S,H,D)
        k = self.k(x)
        v = self.v(x)
        q = apply_rope(q, positions, theta=rope_theta,
                       mrope_sections=mrope_sections)
        k = apply_rope(k, positions, theta=rope_theta,
                       mrope_sections=mrope_sections)

        if cache is None:
            out = _flash_or_sdpa(q, k, v, q_offset=0, window=window,
                                 flash_block=flash_block)
            new_cache = None
        else:
            pos, s = int(cache["pos"]), q.shape[1]
            k_all, v_all = cache["k"], cache["v"]
            s_max = k_all.shape[1]
            if pos + s > s_max:
                raise ValueError(f"the KV cache holds {s_max} positions; "
                                 f"{pos} + {s} do not fit")
            k_all[:, pos:pos + s] = k.to(k_all.dtype)
            v_all[:, pos:pos + s] = v.to(v_all.dtype)
            q_pos = pos + torch.arange(s, device=q.device)
            k_pos = torch.arange(s_max, device=q.device)
            mask = causal_window_mask(q_pos, k_pos, window)[None, None]
            out = sdpa(q, k_all, v_all, mask)
            new_cache = {"k": k_all, "v": v_all, "pos": pos + s}

        b, s = x.shape[:2]
        out = out.reshape(b, s, n_heads * head_dim)
        return self.o(out), new_cache


# ---------------------------------------------------------------------- MLA
class MLA(nn.Module):
    """Multi-head latent attention's projections (the reference's
    ``mla_init``): the query, the KV compression ``dkv``, the shared rope
    key ``kpe``, the latent up-projections ``uk`` and ``uv``, and the
    output."""

    def __init__(self, d_model: int, n_heads: int, *, kv_lora: int,
                 qk_nope_dim: int = 128, qk_rope_dim: int = 64,
                 v_dim: int = 128, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.q = Dense(d_model, (n_heads, qk_nope_dim + qk_rope_dim), **kw)
        self.dkv = Dense(d_model, kv_lora, **kw)
        self.kpe = Dense(d_model, qk_rope_dim, **kw)
        self.uk = Dense(kv_lora, (n_heads, qk_nope_dim), **kw)
        self.uv = Dense(kv_lora, (n_heads, v_dim), **kw)
        self.o = Dense(n_heads * v_dim, d_model, **kw)

    def forward(self, x, positions, *, n_heads: int, kv_lora: int,
                qk_nope_dim: int = 128, qk_rope_dim: int = 64,
                v_dim: int = 128, rope_theta: float = 10000.0,
                cache: dict | None = None, absorbed: bool = True):
        """Returns (out, new_cache).  cache = {"c_kv": (B, S_max,
        kv_lora), "k_pe": (B, S_max, rope), "pos": int}, updated in place
        as GQA's; None for the no-cache forward.  ``absorbed`` computes a
        cached step in the latent space (the latent query q_nope W_uk
        with fp32 logits; the context re-expanded through W_uv)."""
        b, s, _ = x.shape
        q = self.q(x)                                 # (B,S,H,nope+rope)
        q_nope, q_pe = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
        q_pe = apply_rope(q_pe, positions, theta=rope_theta)
        c_kv = self.dkv(x)                            # (B,S,L)
        k_pe = self.kpe(x)[:, :, None, :]             # (B,S,1,R)
        k_pe = apply_rope(k_pe, positions, theta=rope_theta)[:, :, 0, :]
        scale = (qk_nope_dim + qk_rope_dim) ** -0.5

        if cache is not None:
            pos = int(cache["pos"])
            c_all, kpe_all = cache["c_kv"], cache["k_pe"]
            s_max = c_all.shape[1]
            if pos + s > s_max:
                raise ValueError(f"the KV cache holds {s_max} positions; "
                                 f"{pos} + {s} do not fit")
            c_all[:, pos:pos + s] = c_kv.to(c_all.dtype)
            kpe_all[:, pos:pos + s] = k_pe.to(kpe_all.dtype)
            new_cache = {"c_kv": c_all, "k_pe": kpe_all, "pos": pos + s}
            q_pos = pos + torch.arange(s, device=x.device)
            mask = (q_pos[:, None] >= torch.arange(
                s_max, device=x.device)[None, :])[None, None]
            if absorbed:
                q_lat = einsum("bshn,lhn->bshl", q_nope,
                               self.uk.w.to(q_nope.dtype), rows="s")
                logits = (scores("bshl,bkl->bhsk", q_lat, c_all, rows="s")
                          + scores("bshr,bkr->bhsk", q_pe, kpe_all,
                                   rows="s"))
                w = torch.softmax(torch.where(mask, logits * scale, -1e30),
                                  dim=-1)
                ctx_lat = einsum("bhsk,bkl->bshl", w.to(c_all.dtype), c_all,
                                 rows="s")
                out = einsum("bshl,lhv->bshv", ctx_lat,
                             self.uv.w.to(ctx_lat.dtype), rows="s")
            else:
                out = self._naive(q_nope, q_pe, c_all, kpe_all, mask,
                                  n_heads, scale)
        else:
            new_cache = None
            q_pos = torch.arange(s, device=x.device)
            mask = (q_pos[:, None] >= q_pos[None, :])[None, None]
            out = self._naive(q_nope, q_pe, c_kv, k_pe, mask, n_heads,
                              scale)

        out = out.reshape(b, s, -1)
        return self.o(out), new_cache

    def _naive(self, q_nope, q_pe, c_kv, k_pe, mask, n_heads, scale):
        """K and V materialised from the latent (B, S_k, kv_lora), the
        rope key shared by the heads, and the masked `sdpa`."""
        k_nope = einsum("bkl,lhn->bkhn", c_kv, self.uk.w.to(c_kv.dtype),
                        rows="k")
        val = einsum("bkl,lhv->bkhv", c_kv, self.uv.w.to(c_kv.dtype),
                     rows="k")
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            *k_pe.shape[:2], n_heads, k_pe.shape[-1])], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        return sdpa(q_full, k_full, val, mask, scale=scale)


# ------------------------------------------------------------- cross-attn
class CrossAttention(nn.Module):
    """The reference's ``cross_attention_init``: q, v and o with biases,
    k without."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.q = Dense(d_model, (n_heads, head_dim), bias=True, **kw)
        self.k = Dense(d_model, (n_heads, head_dim), **kw)
        self.v = Dense(d_model, (n_heads, head_dim), bias=True, **kw)
        self.o = Dense(n_heads * head_dim, d_model, bias=True, **kw)

    def encode(self, enc_out):
        """The reference's ``encode_cross_kv``: {"k", "v": (B, S_enc, H,
        D)}, computed once and reused by every decode step."""
        return {"k": self.k(enc_out), "v": self.v(enc_out)}

    def forward(self, x, enc_kv, *, n_heads: int, head_dim: int):
        """x: (B, S, d_model) attends to every position of ``enc_kv``
        (the all-True mask of the reference's ``cross_attention``)."""
        b, s, _ = x.shape
        q = self.q(x)
        mask = torch.ones((1, 1, s, enc_kv["k"].shape[1]), dtype=torch.bool,
                          device=x.device)
        out = sdpa(q, enc_kv["k"], enc_kv["v"], mask)
        return self.o(out.reshape(b, s, n_heads * head_dim))
