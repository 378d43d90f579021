"""Model entry points: parameter init, parameter count, the decode cache,
`prefill_step` and `serve_step` — the functions `launch.serve` drives.

Everything takes an explicit ``device`` (None means ``cuda``; with no
GPU that raises).  The model is inference-only in this slice: its
parameters do not require gradients, and `loss_fn` and
`make_train_step` wait for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from . import transformer as T
from .layers import resolve_device
from .ssm import mamba2_cache_shapes
from .transformer import ModelConfig

_TRAIN_TODO = ("training is not ported yet (ROADMAP Queue 1, item 11: "
               "training with backward kernels)")


# ------------------------------------------------------------------ params
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> nn.Module:
    """The port's seeded init of ``cfg``'s model, on ``device``.  It draws
    from the reference's distributions with a `torch.Generator` seeded by
    ``seed``; the numbers differ from the reference's
    (`convert.from_reference` carries those over)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return T.build_model(cfg, device=dev, generator=gen)


def count_params(cfg: ModelConfig) -> int:
    model = T.build_model(cfg, device=torch.device("meta"))
    return int(sum(p.numel() for p in model.parameters()))


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """The zeroed decode cache of ``batch`` sequences with capacity
    ``s_max``, as the reference's pytree (`cache_specs`):

    - dense and moe: {"layers": {"k", "v": (L, B, s_max, Hkv, D), "pos":
      [int] * L}, "pos": int}; with MLA {"layers": {"c_kv": (L, B,
      s_max, kv_lora), "k_pe": (L, B, s_max, qk_rope_dim), "pos": [int]
      * L}, "pos": int};
    - ssm: {"layers": {"conv": (L, B, W-1, conv_dim), "ssm": (L, B, H, P,
      N) float32}, "pos": int};
    - hybrid: {"layers": {"mamba": the ssm family's layers, "attn":
      {"k", "v": (n_inv, B, s_max, Hkv, D), "pos": [int] * n_inv}},
      "pos": int};
    - encdec: {"layers": the dense family's, "cross_kv": {"k", "v": (L,
      B, enc_seq, H, D)}, "pos": int}.  The cross keys and values are
      zeros, as the reference's are, and a forward with this cache uses
      them as they are: the served decoder never runs the encoder
      (`transformer._encdec_apply`).

    Positions are Python ints (the loop is eager), where the reference
    holds int32 arrays of the same shapes."""
    dev = resolve_device(device)

    def zeros(lead, shape, dt):
        return torch.zeros((lead, *shape), dtype=dt, device=dev)

    def kv(lead):
        shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(lead, shape, dtype), "v": zeros(lead, shape, dtype),
                "pos": [0] * lead}

    if cfg.family in ("dense", "moe"):
        if cfg.attn_kind == "mla":
            n = cfg.n_layers
            return {"layers": {
                "c_kv": zeros(n, (batch, s_max, cfg.kv_lora), dtype),
                "k_pe": zeros(n, (batch, s_max, cfg.qk_rope_dim), dtype),
                "pos": [0] * n}, "pos": 0}
        return {"layers": kv(cfg.n_layers), "pos": 0}
    if cfg.family == "encdec":
        shape = (batch, cfg.enc_seq, cfg.n_heads, cfg.head_dim)
        return {"layers": kv(cfg.n_layers),
                "cross_kv": {"k": zeros(cfg.n_layers, shape, dtype),
                             "v": zeros(cfg.n_layers, shape, dtype)},
                "pos": 0}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    one = mamba2_cache_shapes(batch, d_model=cfg.d_model,
                              d_state=cfg.d_state, expand=cfg.ssm_expand,
                              n_groups=cfg.ssm_groups,
                              head_dim=cfg.ssm_head_dim, dtype=dtype)
    mamba = {name: zeros(cfg.n_layers, shape, dt)
             for name, (shape, dt) in one.items()}
    if cfg.family == "ssm":
        return {"layers": mamba, "pos": 0}
    return {"layers": {"mamba": mamba,
                       "attn": kv(T.n_hybrid_attn_invocations(cfg))},
            "pos": 0}


# -------------------------------------------------------------------- loss
def loss_fn(*args, **kwargs):
    raise NotImplementedError(_TRAIN_TODO)


def make_train_step(*args, **kwargs):
    raise NotImplementedError(_TRAIN_TODO)


# ------------------------------------------------------------- serve step
@torch.inference_mode()
def prefill_step(cfg: ModelConfig, model, batch, cache):
    """Run the prompt through the model, filling the cache; returns
    (last-token logits, cache)."""
    logits, _, cache = T.forward(cfg, model, batch, caches=cache)
    return logits[:, -1:], cache


@torch.inference_mode()
def serve_step(cfg: ModelConfig, model, batch, cache):
    """One decode step: batch["tokens"]: (B, 1).  Greedy next token.
    Returns (next_tokens (B, 1) int32, logits, cache)."""
    logits, _, cache = T.forward(cfg, model, batch, caches=cache)
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return nxt[:, None], logits, cache
