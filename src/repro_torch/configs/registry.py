"""Architecture & shape-cell registry.

Every assigned architecture is a module ``configs/<id>.py`` exposing
``CONFIG`` (the exact published configuration) and ``SMOKE_CONFIG`` (a
reduced same-family config for CPU smoke tests).  The port holds every
arch's configuration (`hybrid`: zamba2-1.2b; `ssm`: mamba2-2.7b;
`dense`: gemma3-4b, qwen1.5-4b, glm4-9b, starcoder2-7b and the vision
arch qwen2-vl-72b; `moe`: mixtral-8x7b, deepseek-v2-lite-16b; `encdec`:
whisper-tiny).  ``input_specs`` (the dry-run's stand-ins) waits for the
dry-run item.
"""

from __future__ import annotations

import dataclasses
import importlib

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


def input_specs(*args, **kwargs):
    raise NotImplementedError("input_specs waits for the dry-run item "
                              "(ROADMAP Queue 1, item 11: launch/dryrun)")
