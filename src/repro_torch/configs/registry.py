"""Architecture & shape-cell registry.

Every assigned architecture is a module ``configs/<id>.py`` exposing
``CONFIG`` (the exact published configuration) and ``SMOKE_CONFIG`` (a
reduced same-family config for CPU smoke tests).  The port holds every
arch's configuration (`hybrid`: zamba2-1.2b; `ssm`: mamba2-2.7b;
`dense`: gemma3-4b, qwen1.5-4b, glm4-9b, starcoder2-7b and the vision
arch qwen2-vl-72b; `moe`: mixtral-8x7b, deepseek-v2-lite-16b; `encdec`:
whisper-tiny).  ``input_specs`` builds the stand-ins the dry run
(`launch.dryrun`) traces against: tensors on the ``meta`` device, with
no allocation.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.model import cache_specs
from repro_torch.models.transformer import ModelConfig

ARCHS: tuple[str, ...] = (
    "mixtral-8x7b", "deepseek-v2-lite-16b", "gemma3-4b", "starcoder2-7b",
    "glm4-9b", "qwen1.5-4b", "whisper-tiny", "mamba2-2.7b", "qwen2-vl-72b",
    "zamba2-1.2b",
)

# Archs eligible for the long_500k cell (sub-quadratic attention paths:
# SWA everywhere, 5:1 local:global, SSM, hybrid).  Pure full-attention
# archs skip it (assignment rule).
LONG_OK: frozenset = frozenset(
    {"mixtral-8x7b", "gemma3-4b", "mamba2-2.7b", "zamba2-1.2b"})


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch × shape) cell."""
    if shape == "long_500k" and arch not in LONG_OK:
        return False, ("pure full-attention arch: 524k decode needs a "
                       "sub-quadratic path (assignment skip rule)")
    return True, ""


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                cache_dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for every model input of this cell.

    train:   {batch: {tokens, labels[, vision_embeds, audio_embeds]}}
    prefill: {batch: {tokens[, ...]}, cache}
    decode:  {batch: {tokens (B,1)}, cache}

    Tokens and labels are int32 and the stub embeddings bf16, as the
    reference's; a vision arch's text is ``seq_len - n_vision_tokens``
    tokens.  The cache is `models.model.cache_specs` (positions as Python
    ints)."""
    b, s = cell.global_batch, cell.seq_len

    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def batch_specs(seq_tokens: int, with_labels: bool):
        bt: dict = {"tokens": sd((b, seq_tokens), torch.int32)}
        if with_labels:
            bt["labels"] = sd((b, seq_tokens), torch.int32)
        if cfg.n_vision_tokens:
            bt["vision_embeds"] = sd((b, cfg.n_vision_tokens, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "encdec":
            bt["audio_embeds"] = sd((b, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16)
        return bt

    text = s - cfg.n_vision_tokens if cfg.n_vision_tokens else s
    if cell.kind == "train":
        return {"batch": batch_specs(text, True)}
    if cell.kind == "prefill":
        return {"batch": batch_specs(text, False),
                "cache": cache_specs(cfg, b, s, cache_dtype)}
    # decode: one new token against a seq_len-deep cache
    return {"batch": {"tokens": sd((b, 1), torch.int32)},
            "cache": cache_specs(cfg, b, s, cache_dtype)}
