"""The FLOPs of one training step, by the configuration's layer
equations: 2 m n k for every forward product (the unembedding counted,
the embedding lookup not), attention over its visible causal pairs (in
its window, where the configuration has one) and the SSD's chunked
products at the configuration's chunk (`work.flash`, `work.ssd`), all
times 3 for the forward and the backward.  The recomputed forward of
activation checkpoints is not counted: it is not work the step needs.

Each family's forward is in `work/families/<family>.py`, found by the
configuration's ``family``.
"""

from __future__ import annotations

import importlib


def forward_flops(config: dict, b: int, s: int) -> dict:
    """{"matmul", "attention", "ssd"} forward FLOPs of a (b, s) batch."""
    family = importlib.import_module(
        f"{__package__}.families.{config['family']}")
    return family.forward_flops(config, b, s)


def step_flops(config: dict, traffic: dict) -> float:
    fwd = forward_flops(config, traffic["batch"], traffic["seq_len"])
    return 3.0 * sum(fwd.values())
