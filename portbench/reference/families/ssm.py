"""The `ssm` family (mamba2): Mamba2 layers, each a pre-norm residual
block (input projections, a depthwise causal convolution, the SSD scan,
a gated norm and the output projection, by the Mamba2 paper,
arXiv:2405.21060), then the final norm and the (possibly tied)
unembedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..model import (causal_conv, dense, rmsnorm, run, silu, ssd_chunked,
                     unembed)


def mamba_dims(cfg: dict) -> dict:
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    g, n = cfg["ssm_groups"], cfg["d_state"]
    return dict(d_inner=d_inner, heads=d_inner // cfg["ssm_head_dim"],
                conv_dim=d_inner + 2 * g * n, bc=g * n)


def embedding_specs(cfg: dict) -> list:
    d = cfg["d_model"]
    specs = [("embed.table", (cfg["vocab"], d), "table"),
             ("final_norm.scale", (d,), "ones")]
    if not cfg["tie_embeddings"]:
        specs.append(("unembed.w", (d, cfg["vocab"]), "fan_in"))
    return specs


def param_specs(cfg: dict) -> list:
    d, md = cfg["d_model"], mamba_dims(cfg)
    specs = embedding_specs(cfg)
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        specs += [
            (p + "ln.scale", (d,), "ones"),
            (p + "mamba.a_log", (md["heads"],), "a_log"),
            (p + "mamba.dt_bias", (md["heads"],), "dt_bias"),
            (p + "mamba.d_skip", (md["heads"],), "ones"),
            (p + "mamba.in_x.w", (d, md["d_inner"]), "fan_in"),
            (p + "mamba.in_z.w", (d, md["d_inner"]), "fan_in"),
            (p + "mamba.in_b.w", (d, md["bc"]), "fan_in"),
            (p + "mamba.in_c.w", (d, md["bc"]), "fan_in"),
            (p + "mamba.in_dt.w", (d, md["heads"]), "fan_in"),
            (p + "mamba.conv.w", (cfg["conv_width"], md["conv_dim"]),
             "fan_in"),
            (p + "mamba.conv.b", (md["conv_dim"],), "zeros"),
            (p + "mamba.norm.scale", (md["d_inner"],), "ones"),
            (p + "mamba.out.w", (md["d_inner"], d), "fan_in")]
    return specs


def mamba_layer(cfg: dict, pr, w: dict, i: int, x):
    p = f"layers.{i}."
    eps, md = cfg["norm_eps"], mamba_dims(cfg)
    bsz, s, _ = x.shape
    h, hp = md["heads"], cfg["ssm_head_dim"]
    g, n = cfg["ssm_groups"], cfg["d_state"]
    u = rmsnorm(w[p + "ln.scale"], x, eps)
    z = dense(pr, u, w[p + "mamba.in_z.w"])
    xbc = torch.cat([dense(pr, u, w[p + "mamba.in_x.w"]),
                     dense(pr, u, w[p + "mamba.in_b.w"]),
                     dense(pr, u, w[p + "mamba.in_c.w"])], dim=-1)
    dt = F.softplus(dense(pr, u, w[p + "mamba.in_dt.w"]) +
                    w[p + "mamba.dt_bias"])
    xbc = silu(causal_conv(w[p + "mamba.conv.w"], w[p + "mamba.conv.b"],
                           xbc))
    xs, b, c = torch.split(xbc, [md["d_inner"], md["bc"], md["bc"]], dim=-1)
    xh = xs.reshape(bsz, s, h, hp)
    y = ssd_chunked(xh, dt, w[p + "mamba.a_log"], b.reshape(bsz, s, g, n),
                    c.reshape(bsz, s, g, n), cfg["ssm_chunk"])
    y = (y + w[p + "mamba.d_skip"][:, None] * xh).reshape(bsz, s, -1)
    y = rmsnorm(w[p + "mamba.norm.scale"], y * silu(z), eps)
    return x + dense(pr, y, w[p + "mamba.out.w"])


def forward(cfg: dict, pr, w: dict, tokens, *, remat: bool = True):
    x = w["embed.table"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = run(lambda x, i=i: mamba_layer(cfg, pr, w, i, x), x, remat=remat)
    x = rmsnorm(w["final_norm.scale"], x, cfg["norm_eps"])
    return unembed(cfg, pr, w, x)
