"""The `dense` family (starcoder2): pre-norm blocks of grouped-query
attention (RoPE on both halves of each head, a causal mask, optionally a
sliding window) and an MLP (GELU's tanh form or SiLU, gated or not),
then the final norm and the (possibly tied) unembedding.  Norms are
LayerNorm (scale and bias) or RMSNorm (scale), by ``norm``; with
``qkv_bias`` the Q, K and V projections add a bias, and with LayerNorm
the MLP's products do; the output projection adds none."""

from __future__ import annotations

import torch

from ..model import (causal_attention, dense, gelu, layernorm, rmsnorm,
                     rope, run, silu, unembed)

#: Options of the program's `dense` configurations this reference does
#: not model; a configuration that sets one is refused.
UNMODELLED = ("embed_scale", "logit_cap", "mrope_sections",
              "swa_global_every", "n_vision_tokens")


def _norm_specs(cfg: dict, name: str) -> list:
    d = cfg["d_model"]
    specs = [(name + ".scale", (d,), "ones")]
    if cfg["norm"] == "layernorm":
        specs.append((name + ".bias", (d,), "zeros"))
    return specs


def _dense_specs(name: str, d_in: int, out: tuple, bias: bool) -> list:
    specs = [(name + ".w", (d_in, *out), "fan_in")]
    if bias:
        specs.append((name + ".b", out, "zeros"))
    return specs


def param_specs(cfg: dict) -> list:
    wrong = [k for k in UNMODELLED if cfg.get(k)]
    if wrong or cfg["norm"] not in ("layernorm", "rmsnorm"):
        raise ValueError(f"the dense reference does not model {wrong} "
                         f"or norm {cfg['norm']!r}")
    d, v = cfg["d_model"], cfg["vocab"]
    h, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    ff, qkv_b = cfg["d_ff"], cfg["qkv_bias"]
    mlp_b = cfg["norm"] == "layernorm"
    specs = [("embed.table", (v, d), "table")] + \
        _norm_specs(cfg, "final_norm")
    if not cfg["tie_embeddings"]:
        specs.append(("unembed.w", (d, v), "fan_in"))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        specs += _norm_specs(cfg, p + "ln1")
        specs += _dense_specs(p + "attn.q", d, (h, hd), qkv_b)
        specs += _dense_specs(p + "attn.k", d, (hkv, hd), qkv_b)
        specs += _dense_specs(p + "attn.v", d, (hkv, hd), qkv_b)
        specs += _dense_specs(p + "attn.o", h * hd, (d,), False)
        specs += _norm_specs(cfg, p + "ln2")
        specs += _dense_specs(p + "ffn.up", d, (ff,), mlp_b)
        specs += _dense_specs(p + "ffn.down", ff, (d,), mlp_b)
        if cfg["gated_mlp"]:
            specs += _dense_specs(p + "ffn.gate", d, (ff,), mlp_b)
    return specs


def norm(cfg: dict, w: dict, name: str, x):
    if cfg["norm"] == "layernorm":
        return layernorm(w[name + ".scale"], w[name + ".bias"], x,
                         cfg["norm_eps"])
    return rmsnorm(w[name + ".scale"], x, cfg["norm_eps"])


def linear(pr, w: dict, name: str, x):
    y = dense(pr, x, w[name + ".w"])
    return y + w[name + ".b"] if name + ".b" in w else y


def block(cfg: dict, pr, w: dict, i: int, x, remat: bool):
    p = f"layers.{i}."
    bsz, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    theta = cfg["rope_theta"]
    u = norm(cfg, w, p + "ln1", x)
    q = rope(linear(pr, w, p + "attn.q", u), pos, theta)
    k = rope(linear(pr, w, p + "attn.k", u), pos, theta)
    v = linear(pr, w, p + "attn.v", u)
    o = causal_attention(pr, q, k, v, window=cfg.get("sliding_window"),
                         remat=remat).reshape(bsz, s, -1)
    x = x + linear(pr, w, p + "attn.o", o)
    u = norm(cfg, w, p + "ln2", x)
    act = gelu if cfg["act"] == "gelu" else silu
    hid = act(linear(pr, w, p + "ffn.gate", u)) * \
        linear(pr, w, p + "ffn.up", u) if cfg["gated_mlp"] else \
        act(linear(pr, w, p + "ffn.up", u))
    return x + linear(pr, w, p + "ffn.down", hid)


def forward(cfg: dict, pr, w: dict, tokens, *, remat: bool = True):
    x = w["embed.table"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = run(lambda x, i=i: block(cfg, pr, w, i, x, remat), x,
                remat=remat)
    x = norm(cfg, w, "final_norm", x)
    return unembed(cfg, pr, w, x)
