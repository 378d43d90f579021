"""Unified transformer/SSM/hybrid stack, as the reference's
``models/transformer.py``; the port runs the ``hybrid``, ``ssm``,
``dense`` and ``moe`` families.

Families:
- ``dense``  — GQA attention + (gated) MLP (gemma3, starcoder2, glm4,
               qwen1.5): ported; qwen2-vl's vision inputs are not.
- ``ssm``    — Mamba2 SSD blocks, attention-free (mamba2-2.7b): ported.
- ``hybrid`` — Mamba2 backbone + one *shared* GQA block invoked every k
               layers (zamba2-1.2b): ported.
- ``moe``    — attention (GQA, or MLA for deepseek-v2-lite) + a routed
               mixture-of-experts FFN (mixtral, deepseek-v2-lite):
               ported, both dispatches of ``moe_impl``.
- ``encdec`` and vision inputs — not ported yet; building or running
               them raises `NotImplementedError`.

The model is an `nn.Module` (`DenseModel`, `SSMModel`, `HybridModel`;
the ``moe`` family is a `DenseModel` whose blocks hold `MLA` or `GQA`
and a `MoE` FFN)
whose parameter paths are the reference's pytree keys with the stacked
layer axis split per layer (``layers.<i>.<rest>``).  PyTorch runs
eagerly: the reference's ``lax.scan`` over stacked layers is a loop over
the layer modules, each layer taking its own window (gemma3's 5 local :
1 global) as a Python int, and its activation remat (``cfg.remat``) has
no counterpart in this inference-only port.  The one-device sharding
constraint (``launch/sharding.constrain``) is a no-op and is not copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from . import layers as L
from .attention import GQA, MLA
from .moe import MoE
from .ssm import Mamba2Block

_FAMILIES = ("dense", "ssm", "hybrid", "moe")
_TODO = ("{what} is not ported yet (ROADMAP Queue 1, item 11: the encdec "
         "and vision families)")


# ---------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 32000
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    # attention pattern
    sliding_window: int | None = None
    swa_global_every: int = 0        # k>0: every k-th layer is global
    logit_cap: float | None = None
    mrope_sections: tuple[int, ...] | None = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    # MLA
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    # hybrid
    hybrid_attn_every: int = 0       # shared attn block after every k layers
    # enc-dec / modality stubs
    n_enc_layers: int = 0
    enc_seq: int = 0                 # whisper: 1500 precomputed frames
    n_vision_tokens: int = 0         # qwen2-vl: stub patch embeddings
    # compute
    embed_scale: bool = False        # gemma/whisper style sqrt(d) scaling
    remat: str = "block"             # none | block
    use_pallas: bool = False
    max_decode_len: int = 0          # 0 = use shape cell's seq_len
    # §Perf knobs (baseline values are the paper-faithful defaults)
    moe_impl: str = "ragged"         # ragged | capacity
    logits_dtype: str = "float32"    # float32 | bfloat16 (bf16 backward)
    mla_absorbed: bool = False       # decode MLA in latent space (§Perf)

    @property
    def attn_kind(self) -> str:
        return "mla" if self.kv_lora else "gqa"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid, or SWA on every
        layer — gemma3's global layers bound their window by position)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window is not None and self.swa_global_every == 0)

    def norm_cls(self):
        return L.RMSNorm if self.norm == "rmsnorm" else L.LayerNorm

    def act_fn(self):
        return L.silu if self.act == "silu" else L.gelu


def require_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what the port does not run yet."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            _TODO.format(what=f"the {cfg.family!r} family"))
    if cfg.n_vision_tokens or cfg.mrope_sections is not None:
        raise NotImplementedError(
            _TODO.format(what="vision inputs and M-RoPE positions"))


# --------------------------------------------------------------- modules
class Block(nn.Module):
    """Pre-norm transformer block: attention (GQA, or MLA), then a
    (gated) MLP or, in the ``moe`` family, a mixture of experts."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        norm = cfg.norm_cls()
        kw = dict(device=device, generator=generator)
        self.ln1 = norm(cfg.d_model, device=device)
        if cfg.attn_kind == "mla":
            self.attn = MLA(cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora,
                            qk_nope_dim=cfg.qk_nope_dim,
                            qk_rope_dim=cfg.qk_rope_dim,
                            v_dim=cfg.v_head_dim, **kw)
        else:
            self.attn = GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, qkv_bias=cfg.qkv_bias, **kw)
        self.ln2 = norm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.ffn = MoE(cfg.d_model, n_experts=cfg.n_experts,
                           moe_d_ff=cfg.moe_d_ff,
                           n_shared=cfg.n_shared_experts,
                           shared_d_ff=cfg.moe_d_ff, **kw)
        else:
            self.ffn = L.MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                             bias=cfg.norm == "layernorm", **kw)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        self.ln = cfg.norm_cls()(cfg.d_model, device=device)
        self.mamba = Mamba2Block(
            cfg.d_model, d_state=cfg.d_state, expand=cfg.ssm_expand,
            head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
            device=device, generator=generator)


class _LanguageModel(nn.Module):
    """Embedding, final norm and (unless tied) unembedding; the families'
    models add their layers after these."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embed = L.Embed(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = cfg.norm_cls()(cfg.d_model, device=device)
        self.unembed = None if cfg.tie_embeddings else \
            L.Dense(cfg.d_model, cfg.vocab, **kw)


class DenseModel(_LanguageModel):
    """gemma3, qwen1.5, glm4, starcoder2, and the ``moe`` family's
    mixtral and deepseek-v2-lite: ``n_layers`` `Block`s."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        self.layers = nn.ModuleList(
            Block(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))


class SSMModel(_LanguageModel):
    """mamba2: ``n_layers`` Mamba layers, attention-free."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))


class HybridModel(SSMModel):
    """zamba2: the Mamba layers and ONE shared attention block
    (`shared_attn`, reused by every invocation)."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        self.shared_attn = Block(cfg, device=device, generator=generator)


_MODELS = {"dense": DenseModel, "ssm": SSMModel, "hybrid": HybridModel,
           "moe": DenseModel}


def build_model(cfg: ModelConfig, *, device, generator=None) -> nn.Module:
    """``cfg``'s model (the one way to build one: it refuses what is not
    ported)."""
    require_ported(cfg)
    return _MODELS[cfg.family](cfg, device=device, generator=generator)


# --------------------------------------------------------------- windows
def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full causal).  gemma3: 5 local :
    1 global; mixtral: SWA everywhere."""
    w = np.zeros(cfg.n_layers, np.int32)
    if cfg.sliding_window is not None:
        w[:] = cfg.sliding_window
        if cfg.swa_global_every > 0:
            w[cfg.swa_global_every - 1::cfg.swa_global_every] = 0
    return w


# --------------------------------------------------------------- blocks
def _attn_apply(cfg: ModelConfig, attn, x, positions, window, cache):
    if cfg.attn_kind == "mla":
        return attn(x, positions, n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
                    qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                    v_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
                    cache=cache, absorbed=cfg.mla_absorbed)
    return attn(x, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                window=window, mrope_sections=cfg.mrope_sections,
                cache=cache)


def _block_apply(cfg: ModelConfig, blk: Block, x, positions, window, cache):
    """Pre-norm transformer block.  Returns (x, new_cache, aux)."""
    h, new_cache = _attn_apply(cfg, blk.attn, blk.ln1(x), positions,
                               window, cache)
    x = x + h
    if cfg.family == "moe":
        h, aux = blk.ffn(blk.ln2(x), top_k=cfg.top_k, impl=cfg.moe_impl)
    else:
        h = blk.ffn(blk.ln2(x), act=cfg.act_fn())
        aux = torch.zeros((), device=x.device)
    return x + h, new_cache, aux


def _mamba_apply(cfg: ModelConfig, layer: MambaLayer, x, cache):
    h, new_cache = layer.mamba(
        layer.ln(x), d_state=cfg.d_state, head_dim=cfg.ssm_head_dim,
        n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk, cache=cache)
    return x + h, new_cache


# ----------------------------------------------------------- main stacks
def _scan_blocks(cfg: ModelConfig, blocks, x, positions, windows, caches):
    """The transformer blocks in order, each with its own window (an int,
    0 meaning plain causal; None for every layer without
    ``sliding_window``).  caches: {"k", "v": (L, B, S_max, Hkv, D),
    "pos": [int] * L} (MLA: {"c_kv", "k_pe"} in place of k and v) or
    None; updated in place."""
    aux = torch.zeros((), device=x.device)
    for li, blk in enumerate(blocks):
        cache = ({name: t[li] for name, t in caches.items()}
                 if caches is not None else None)
        window = int(windows[li]) if windows is not None else None
        x, new_cache, a = _block_apply(cfg, blk, x, positions, window, cache)
        aux = aux + a
        if new_cache is not None:
            caches["pos"][li] = new_cache["pos"]
    return x, aux, caches


def _scan_mamba(cfg: ModelConfig, layers, x, caches):
    """The Mamba layers in order.  caches: {"conv", "ssm"} with a leading
    layer axis, or None; updated in place."""
    for li, layer in enumerate(layers):
        cache = ({"conv": caches["conv"][li], "ssm": caches["ssm"][li]}
                 if caches is not None else None)
        x, new_cache = _mamba_apply(cfg, layer, x, cache)
        if new_cache is not None:
            cache["conv"].copy_(new_cache["conv"])
            cache["ssm"].copy_(new_cache["ssm"])
    return x, caches


def _hybrid_apply(cfg: ModelConfig, model: HybridModel, x, positions,
                  caches):
    """zamba2: mamba backbone; ONE shared attention block (weights
    reused) applied after every ``hybrid_attn_every`` full layers.  Each
    shared-attn *invocation* gets its own KV cache — same weights,
    distinct activations.  Caches are updated in place."""
    k = cfg.hybrid_attn_every
    n = cfg.n_layers
    aux = torch.zeros((), device=x.device)
    mc = caches["mamba"] if caches is not None else None
    ac = caches["attn"] if caches is not None else None
    start, inv = 0, 0
    while start < n:
        end = min(start + k, n)
        seg_cache = ({name: t[start:end] for name, t in mc.items()}
                     if mc is not None else None)
        x, _ = _scan_mamba(cfg, model.layers[start:end], x, seg_cache)
        if end - start == k:        # full segment -> shared attn invocation
            cache = ({"k": ac["k"][inv], "v": ac["v"][inv],
                      "pos": ac["pos"][inv]} if ac is not None else None)
            x, nac, a = _block_apply(cfg, model.shared_attn, x, positions,
                                     None, cache)
            aux = aux + a
            if nac is not None:
                ac["pos"][inv] = nac["pos"]
            inv += 1
        start = end
    return x, aux, caches


def n_hybrid_attn_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


# ----------------------------------------------------------------- entry
def forward(cfg: ModelConfig, model: nn.Module, batch: dict, caches=None):
    """Unified forward on the device the model's parameters live on.

    batch: {"tokens": (B, S_text) int (a tensor or a numpy array)}.
    caches: None (the no-cache forward) or the decode cache of
    `model.init_cache`, updated in place (its ``pos`` advanced).
    Returns (logits (B, S, vocab), aux_loss, caches).
    """
    require_ported(cfg)
    dev = model.embed.table.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = model.embed(tokens)
    if cfg.embed_scale:
        # The scale rounded to x's type first, as the reference does:
        # gemma3's sqrt(2560) = 50.596 enters as 50.5 in bf16.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)

    b, s = x.shape[:2]
    pos0 = int(caches["pos"]) if caches is not None else 0
    positions = (pos0 + torch.arange(s, device=dev))[None, :].expand(b, s)

    lc = caches["layers"] if caches is not None else None
    aux = torch.zeros((), device=dev)
    if cfg.family in ("dense", "moe"):
        windows = layer_windows(cfg) if cfg.sliding_window is not None \
            else None
        x, aux, new_lc = _scan_blocks(cfg, model.layers, x, positions,
                                      windows, lc)
    elif cfg.family == "ssm":
        x, new_lc = _scan_mamba(cfg, model.layers, x, lc)
    else:  # hybrid
        x, aux, new_lc = _hybrid_apply(cfg, model, x, positions, lc)
    new_caches = _bump(caches, new_lc, s)

    x = model.final_norm(x)
    ldt = torch.float32 if cfg.logits_dtype == "float32" else torch.bfloat16
    if cfg.tie_embeddings:
        logits = L.unembed(model.embed.table, x, logits_dtype=ldt)
    else:
        logits = model.unembed(x).to(ldt)
    return logits, aux, new_caches


def _bump(caches, new_layer_caches, s):
    if caches is None:
        return None
    caches["layers"] = new_layer_caches
    caches["pos"] = int(caches["pos"]) + s
    return caches
