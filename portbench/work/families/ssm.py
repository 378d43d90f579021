"""Forward FLOPs of the `ssm` family (mamba2): Mamba2 layers, then the
(possibly tied) unembedding."""

from __future__ import annotations

from .. import ssd


def mamba_layer(config: dict, b: int, s: int) -> dict:
    """One Mamba2 layer: its five input projections and the output
    projection (2 m n k each), and the SSD scan's products
    (`work.ssd`).  The depthwise convolution and the norms are not
    products and are not counted."""
    d = config["d_model"]
    d_inner = config["ssm_expand"] * d
    h = d_inner // config["ssm_head_dim"]
    gn = config["ssm_groups"] * config["d_state"]
    tokens = b * s
    dense = 2.0 * tokens * d * (2 * d_inner + 2 * gn + h) + \
        2.0 * tokens * d_inner * d
    scan = ssd.forward_flops(b, s, h, config["ssm_head_dim"],
                             config["d_state"], config["ssm_groups"],
                             config["ssm_chunk"])
    return {"matmul": dense, "ssd": scan}


def unembed(config: dict, b: int, s: int) -> float:
    """The logits' product, 2 B S D V; the embedding is a lookup."""
    return 2.0 * b * s * config["d_model"] * config["vocab"]


def forward_flops(config: dict, b: int, s: int) -> dict:
    one = mamba_layer(config, b, s)
    n = config["n_layers"]
    return {"matmul": n * one["matmul"] + unembed(config, b, s),
            "ssd": n * one["ssd"], "attention": 0.0}
