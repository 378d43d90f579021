"""Forward FLOPs of the `dense` family (starcoder2): each block's Q, K,
V and O projections, attention over its visible pairs (in the window,
where the configuration has one) and the MLP's products (three where it
is gated, else two), then the (possibly tied) unembedding.  Biases and
norms are not products and are not counted."""

from __future__ import annotations

from .. import flash
from .ssm import unembed


def block(config: dict, b: int, s: int) -> dict:
    d, hd = config["d_model"], config["head_dim"]
    h, hkv, ff = config["n_heads"], config["n_kv_heads"], config["d_ff"]
    tokens = b * s
    proj = 2.0 * tokens * d * hd * (2 * h + 2 * hkv)
    mlp = (3 if config["gated_mlp"] else 2) * 2.0 * tokens * d * ff
    return {"matmul": proj + mlp,
            "attention": flash.forward_flops(
                b, s, s, h, hd, config.get("sliding_window"))}


def forward_flops(config: dict, b: int, s: int) -> dict:
    one = block(config, b, s)
    n = config["n_layers"]
    return {"matmul": n * one["matmul"] + unembed(config, b, s),
            "attention": n * one["attention"], "ssd": 0.0}
