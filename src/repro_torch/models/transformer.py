"""Unified transformer/SSM/hybrid/encoder-decoder stack, as the
reference's ``models/transformer.py``; the port runs all five families.

Families:
- ``dense``  — GQA attention + (gated) MLP (gemma3, starcoder2, glm4,
               qwen1.5, and qwen2-vl's backbone: its stub patch
               embeddings ``vision_embeds`` go before the tokens, with
               M-RoPE positions, `_mrope_positions`).
- ``ssm``    — Mamba2 SSD blocks, attention-free (mamba2-2.7b).
- ``hybrid`` — Mamba2 backbone + one *shared* GQA block invoked every k
               layers (zamba2-1.2b).
- ``moe``    — attention (GQA, or MLA for deepseek-v2-lite) + a routed
               mixture-of-experts FFN (mixtral, deepseek-v2-lite), both
               dispatches of ``moe_impl``.
- ``encdec`` — an encoder of ordinary blocks over the stub frame
               embeddings ``audio_embeds``, and a decoder of causal self
               + cross-attention blocks (whisper-tiny).  As in the
               reference, the encoder is causal with RoPE on the frame
               index, and runs only when the cache holds no ``cross_kv``:
               the served cache's is zeros (`model.init_cache`).

The model is an `nn.Module` (`DenseModel`, `SSMModel`, `HybridModel`,
`EncDecModel`; the ``moe`` family is a `DenseModel` whose blocks hold
`MLA` or `GQA` and a `MoE` FFN) whose parameter paths are the
reference's pytree keys with the stacked layer axes split per layer
(``layers.<i>.<rest>``, ``enc_layers.<i>.<rest>``).  PyTorch runs
eagerly: the reference's ``lax.scan`` over stacked layers is a loop
over the layer modules, each layer taking its own window (gemma3's 5
local : 1 global) as a Python int.  The reference's activation remat
(``jax.checkpoint`` when ``cfg.remat == "block"``) is `_maybe_remat`:
under autograd each block, Mamba layer, shared-attention invocation and
encoder or decoder layer runs under `torch.utils.checkpoint.checkpoint`
(non-reentrant), so its activations are recomputed in the backward
instead of kept; serving (grad off) takes no checkpoint.  The one-device
sharding constraint (``launch/sharding.constrain``) is a no-op and is
not copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .attention import GQA, MLA, CrossAttention
from .moe import MoE
from .ssm import Mamba2Block


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


# --------------------------------------------------------------- modules
class Block(nn.Module):
    """Pre-norm transformer block: attention (GQA, or MLA), then a
    (gated) MLP or, in the ``moe`` family, a mixture of experts.  The
    ``encdec`` family's encoder layers are these blocks too."""

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


class DecoderBlock(nn.Module):
    """The ``encdec`` family's decoder layer: causal GQA self-attention,
    cross-attention to the encoder (``xattn``, after its own norm
    ``ln_x``), then the MLP."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        norm = cfg.norm_cls()
        kw = dict(device=device, generator=generator)
        self.ln1 = norm(cfg.d_model, device=device)
        self.attn = GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, qkv_bias=cfg.qkv_bias, **kw)
        self.ln_x = norm(cfg.d_model, device=device)
        self.xattn = CrossAttention(cfg.d_model, cfg.n_heads, cfg.head_dim,
                                    **kw)
        self.ln2 = norm(cfg.d_model, device=device)
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


class EncDecModel(_LanguageModel):
    """whisper: ``n_enc_layers`` encoder `Block`s and their final norm
    ``enc_norm``, then ``n_layers`` `DecoderBlock`s."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        kw = dict(device=device, generator=generator)
        self.enc_layers = nn.ModuleList(
            Block(cfg, **kw) for _ in range(cfg.n_enc_layers))
        self.enc_norm = cfg.norm_cls()(cfg.d_model, device=device)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, **kw) for _ in range(cfg.n_layers))


_MODELS = {"dense": DenseModel, "ssm": SSMModel, "hybrid": HybridModel,
           "moe": DenseModel, "encdec": EncDecModel}


def build_model(cfg: ModelConfig, *, device, generator=None) -> nn.Module:
    """``cfg``'s model (the one way to build one)."""
    if cfg.family not in _MODELS:
        raise ValueError(f"unknown family {cfg.family!r}")
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
def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` under a non-reentrant activation checkpoint when
    ``cfg.remat == "block"`` and autograd is recording (the reference
    wraps its scan bodies in ``jax.checkpoint``); ``fn`` itself
    otherwise.  The forward draws no random numbers, so no RNG state is
    kept for the recomputation."""
    if cfg.remat != "block":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def _scan_blocks(cfg: ModelConfig, blocks, x, positions, windows, caches):
    """The transformer blocks in order, each with its own window (an int,
    0 meaning plain causal; None for every layer without
    ``sliding_window``).  caches: {"k", "v": (L, B, S_max, Hkv, D),
    "pos": [int] * L} (MLA: {"c_kv", "k_pe"} in place of k and v) or
    None; updated in place."""
    aux = torch.zeros((), device=x.device)
    body = _maybe_remat(cfg, lambda blk, x, window, cache: _block_apply(
        cfg, blk, x, positions, window, cache))
    for li, blk in enumerate(blocks):
        cache = ({name: t[li] for name, t in caches.items()}
                 if caches is not None else None)
        window = int(windows[li]) if windows is not None else None
        x, new_cache, a = body(blk, x, window, cache)
        aux = aux + a
        if new_cache is not None:
            caches["pos"][li] = new_cache["pos"]
    return x, aux, caches


def _scan_mamba(cfg: ModelConfig, layers, x, caches):
    """The Mamba layers in order.  caches: {"conv", "ssm"} with a leading
    layer axis, or None; updated in place."""
    body = _maybe_remat(cfg, lambda layer, x, cache: _mamba_apply(
        cfg, layer, x, cache))
    for li, layer in enumerate(layers):
        cache = ({"conv": caches["conv"][li], "ssm": caches["ssm"][li]}
                 if caches is not None else None)
        x, new_cache = body(layer, x, cache)
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
    shared = _maybe_remat(cfg, lambda x, cache: _block_apply(
        cfg, model.shared_attn, x, positions, None, cache))
    start, inv = 0, 0
    while start < n:
        end = min(start + k, n)
        seg_cache = ({name: t[start:end] for name, t in mc.items()}
                     if mc is not None else None)
        x, _ = _scan_mamba(cfg, model.layers[start:end], x, seg_cache)
        if end - start == k:        # full segment -> shared attn invocation
            cache = ({"k": ac["k"][inv], "v": ac["v"][inv],
                      "pos": ac["pos"][inv]} if ac is not None else None)
            x, nac, a = shared(x, cache)
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

    batch: {"tokens": (B, S_text) int, optional "vision_embeds" (B, Tv,
    D) and "audio_embeds" (B, S_enc, D)}, each a tensor or a numpy
    array.  caches: None (the no-cache forward) or the decode cache of
    `model.init_cache`, updated in place (its ``pos`` advanced).
    Returns (logits (B, S, vocab), aux_loss, caches); S counts the
    vision prefix.
    """
    dev = model.embed.table.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = model.embed(tokens)
    if cfg.embed_scale:
        # The scale rounded to x's type first, as the reference does:
        # gemma3's sqrt(2560) = 50.596 enters as 50.5 in bf16.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        ve = torch.as_tensor(batch["vision_embeds"], device=dev)
        x = torch.cat([ve.to(x.dtype), x], dim=1)

    b, s = x.shape[:2]
    pos0 = int(caches["pos"]) if caches is not None else 0
    positions = (pos0 + torch.arange(s, device=dev))[None, :].expand(b, s)
    if cfg.mrope_sections is not None:
        positions = _mrope_positions(cfg, b, s, positions)

    lc = caches["layers"] if caches is not None else None
    aux = torch.zeros((), device=dev)
    if cfg.family in ("dense", "moe"):
        windows = layer_windows(cfg) if cfg.sliding_window is not None \
            else None
        x, aux, new_lc = _scan_blocks(cfg, model.layers, x, positions,
                                      windows, lc)
    elif cfg.family == "ssm":
        x, new_lc = _scan_mamba(cfg, model.layers, x, lc)
    elif cfg.family == "hybrid":
        x, aux, new_lc = _hybrid_apply(cfg, model, x, positions, lc)
    else:  # encdec
        x, new_lc = _encdec_apply(cfg, model, batch, x, positions, caches)
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


def _mrope_positions(cfg: ModelConfig, b, s, positions):
    """Qwen2-VL M-RoPE position streams (temporal, height, width), (3, B,
    S), as the reference computes them.

    A forward over more than the Tv = g*g stub patches (the no-cache
    forward and a cached prefill): the patch grid sits at t = 0 with
    (h, w) grid coordinates, and the text continues all three streams
    from g.  Otherwise (a decode step) all three streams are the
    absolute position in ``positions``, which counts the Tv patches:
    the reference's decode positions jump from the prefill's g + S_text
    to Tv + S_text, and the port keeps the jump."""
    tv = cfg.n_vision_tokens
    g = int(np.sqrt(tv)) if tv else 0
    if tv and g * g == tv and s > tv:
        dev = positions.device
        grid = torch.arange(g, device=dev)
        text = torch.arange(s - tv, device=dev) + g
        pos3 = torch.stack([
            torch.cat([torch.zeros(tv, dtype=torch.long, device=dev), text]),
            torch.cat([grid.repeat_interleave(g), text]),
            torch.cat([grid.repeat(g), text])])                   # (3, S)
        return pos3[:, None, :].expand(3, b, s)
    return positions[None].expand(3, b, s)


def _encdec_apply(cfg: ModelConfig, model: EncDecModel, batch, x,
                  positions, caches):
    """whisper's decoder over ``x``.  The encoder runs over
    ``batch["audio_embeds"]`` only when there is no cache or the cache
    holds no ``cross_kv`` (the reference's rule: the served cache's
    zeros are used as they are); its output gives each decoder layer's
    cross keys and values once.  Returns (x, the self-attention caches);
    a cache gets the computed ``cross_kv``."""
    if caches is None or caches.get("cross_kv") is None:
        dev = x.device
        enc = torch.as_tensor(batch["audio_embeds"], device=dev).to(x.dtype)
        enc_pos = torch.arange(enc.shape[1], device=dev)[None].expand(
            enc.shape[:2])
        enc_body = _maybe_remat(cfg, lambda blk, enc: _block_apply(
            cfg, blk, enc, enc_pos, None, None))
        for blk in model.enc_layers:
            enc, _, _ = enc_body(blk, enc)
        enc = model.enc_norm(enc)
        kvs = [blk.xattn.encode(enc) for blk in model.layers]
        cross_kv = {name: torch.stack([kv[name] for kv in kvs])
                    for name in ("k", "v")}
        if caches is not None:
            caches["cross_kv"] = cross_kv
    else:
        cross_kv = caches["cross_kv"]
    lc = caches["layers"] if caches is not None else None
    body = _maybe_remat(cfg, lambda blk, x, kv, cache: _decoder_apply(
        cfg, blk, x, positions, kv, cache))
    for li, blk in enumerate(model.layers):
        cache = ({"k": lc["k"][li], "v": lc["v"][li], "pos": lc["pos"][li]}
                 if lc is not None else None)
        x, new_cache = body(blk, x, {name: t[li] for name, t in
                                     cross_kv.items()}, cache)
        if new_cache is not None:
            lc["pos"][li] = new_cache["pos"]
    return x, lc


def _decoder_apply(cfg: ModelConfig, blk: DecoderBlock, x, positions,
                   cross_kv: dict, cache):
    """One decoder layer: causal self-attention, cross-attention to the
    layer's encoder keys and values, then the MLP.  Returns (x,
    new_cache)."""
    h, new_cache = _attn_apply(cfg, blk.attn, blk.ln1(x), positions, None,
                               cache)
    x = x + h
    x = x + blk.xattn(blk.ln_x(x), cross_kv, n_heads=cfg.n_heads,
                      head_dim=cfg.head_dim)
    x = x + blk.ffn(blk.ln2(x), act=cfg.act_fn())
    return x, new_cache
