"""Model entry points: parameter init, specs and count, the decode cache
and its specs, the optimizer state's specs, the loss and the train step
(`launch.train`), and `prefill_step` and `serve_step` (`launch.serve`).

A spec is a tensor on the ``meta`` device: its shape and type, and no
memory (the reference's ``ShapeDtypeStruct``).  The dry run
(`launch.dryrun`) traces the steps on specs.

Everything takes an explicit ``device`` (None means ``cuda``; with no
GPU that raises).  A built model's parameters do not require gradients,
so serving builds no autograd graph; the trainer turns them on for its
own model (``model.requires_grad_()``, `launch.train.build`) before
`make_train_step`'s step takes gradients.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.optim import AdamW

from . import transformer as T
from .layers import resolve_device
from .ssm import mamba2_cache_shapes
from .transformer import ModelConfig


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


def param_specs(cfg: ModelConfig) -> dict:
    """Module path -> meta tensor of every parameter of ``cfg``'s model
    (no allocation).  The reference's tree stacks the layers; the port's
    names are per layer (`models.convert.reference_path` maps them)."""
    model = T.build_model(cfg, device=torch.device("meta"))
    return dict(model.named_parameters())


def count_params(cfg: ModelConfig) -> int:
    return int(sum(p.numel() for p in param_specs(cfg).values()))


def opt_state_specs(params: dict) -> dict:
    """AdamW's state for ``params`` (name -> meta tensor), as
    `optim.AdamW.init` builds it, on meta: fp32 ``mu`` and ``nu`` of
    each parameter's shape and the 0-d int32 ``count``.  The dry run's
    train step starts from it (`launch.dryrun.trace_cell`)."""
    return AdamW().init(params)


# ------------------------------------------------------------------- cache
def cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                dtype=torch.bfloat16) -> dict:
    """`init_cache`'s tree on the meta device (no allocation); its
    positions stay Python ints, where the reference's are int32 arrays
    of the same shapes."""
    return init_cache(cfg, batch, s_max, dtype, device=torch.device("meta"))


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
def loss_fn(cfg: ModelConfig, model, batch, *, aux_weight: float = 0.01,
            z_weight: float = 1e-4):
    """Next-token CE (+ router aux loss + z-loss), as the reference's:
    logits in float32, a vision prefix cut from them, labels -1 masked.
    Returns (total, {"ce", "aux", "zloss", "ntokens"})."""
    logits, aux, _ = T.forward(cfg, model, batch)
    logits = logits.to(torch.float32)   # CE reductions always in fp32
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    if logits.shape[1] != labels.shape[1]:
        # modality prefix (VLM stub): loss over the text suffix only
        logits = logits[:, -labels.shape[1]:]
    valid = labels >= 0
    labels = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = (logz - ll) * valid
    n = torch.clamp(valid.sum(), min=1)
    ce_mean = ce.sum() / n
    zloss = ((logz * valid) ** 2).sum() / n
    total = ce_mean + aux_weight * aux + z_weight * zloss
    return total, {"ce": ce_mean, "aux": aux, "zloss": zloss,
                   "ntokens": n}


# ------------------------------------------------------------- train step
def make_train_step(cfg: ModelConfig, optimizer):
    """``train_step((model, opt_state, step), batch) -> (state,
    metrics)`` with the reference's metrics (ce, aux, zloss, ntokens,
    loss, grad_norm before clipping, step).  ``optimizer`` is a
    `repro_torch.optim` object (``init(params)`` / ``update(g, s, p)``
    over name -> tensor dicts).  Gradients come from `torch.autograd`
    (the model's parameters must require them: ``requires_grad_()``;
    `init_params` and `convert.from_reference` build frozen ones); the
    update
    is added to the parameters in place under `torch.no_grad`, and the
    model object is the new state's."""

    def train_step(state, batch):
        model, opt_state, step = state
        params = dict(model.named_parameters())
        if not all(p.requires_grad for p in params.values()):
            raise ValueError("the model's parameters do not require "
                             "gradients: call model.requires_grad_() "
                             "first")
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(params, grads))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(list(params.values()),
                                [updates[k] for k in params])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=optax_global_norm(grads),
                       step=torch.as_tensor(step).to(torch.float32))
        return (model, opt_state, step + 1), metrics

    return train_step


def optax_global_norm(tree: dict):
    """sqrt of the sum of squares of every tensor of ``tree`` (name ->
    tensor), in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


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
