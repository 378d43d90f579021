"""The general generator of training batches: the traffic file gives the
batch, the sequence length and the law of the token ids; the seed and
the step's index give the numbers.  Every step's rows are drawn afresh,
so no two steps share a row.
"""

from __future__ import annotations

import torch

from .seeds import substream


class Batches:
    """``batches(i)`` -> {"tokens", "labels"}: int32 (B, S), the labels
    the next token of each position (a row of S + 1 ids is drawn)."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        law = traffic["tokens"]
        if law["law"] != "zipf":
            raise ValueError(f"unknown token law {law['law']!r}")
        self.shape = (traffic["batch"], traffic["seq_len"] + 1)
        self.seed, self.device = seed, torch.device(device)
        rank = torch.arange(1, vocab + 1, dtype=torch.float64,
                            device=self.device)
        cdf = torch.cumsum(rank ** -float(law["exponent"]), 0)
        self.cdf = cdf / cdf[-1]
        self.vocab = vocab

    def __call__(self, step: int) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(
            substream(self.seed, "batch", step))
        u = torch.rand(self.shape, dtype=torch.float64, device=self.device,
                       generator=gen)
        ids = torch.searchsorted(self.cdf, u).clamp_(max=self.vocab - 1)
        ids = ids.to(torch.int32)
        return {"tokens": ids[:, :-1].contiguous(),
                "labels": ids[:, 1:].contiguous()}
