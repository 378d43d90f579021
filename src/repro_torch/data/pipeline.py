"""Deterministic, index-based data pipeline.

Design requirements for the multi-pod runtime:
- **stateless resume**: batch t is a pure function of (seed, t) — restart
  from a checkpoint replays exactly the same stream with no pipeline state
  to save (the checkpoint stores only the step counter);
- **shard-by-host**: each host materialises only its slice of the global
  batch (`host_slice`), so feeding 512 chips never funnels through one
  process;
- **synthetic + file-backed**: the default source is a seeded synthetic
  LM stream (zipfian tokens with locally-coherent repeats, so the CE loss
  has learnable structure); a memory-mapped token file can be dropped in
  with the same interface.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_vision_tokens: int = 0
    d_model: int = 0               # for modality stubs
    enc_seq: int = 0
    kind: str = "synthetic"        # synthetic | file
    path: str = ""


class SyntheticLMData:
    """batch(t) -> dict of numpy arrays; pure function of (seed, t)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        cfg = self.cfg
        lo, hi = (host_slice.start, host_slice.stop) if host_slice \
            else (0, cfg.global_batch)
        rows = []
        for b in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, b]))
            # zipf-ish marginal + local repeats = learnable structure
            base = rng.zipf(1.3, size=cfg.seq_len + 1) % cfg.vocab
            rep = rng.random(cfg.seq_len + 1) < 0.3
            for i in range(1, cfg.seq_len + 1):
                if rep[i]:
                    base[i] = base[i - 1]
            rows.append(base)
        arr = np.stack(rows).astype(np.int32)
        out = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
        if cfg.n_vision_tokens:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, 7]))
            out["vision_embeds"] = rng.standard_normal(
                (hi - lo, cfg.n_vision_tokens, cfg.d_model),
                dtype=np.float32) * 0.02
            out["tokens"] = out["tokens"][:, cfg.n_vision_tokens:]
            out["labels"] = out["labels"][:, cfg.n_vision_tokens:]
        if cfg.enc_seq:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, 11]))
            out["audio_embeds"] = rng.standard_normal(
                (hi - lo, cfg.enc_seq, cfg.d_model),
                dtype=np.float32) * 0.02
        return out


class FileLMData:
    """Memory-mapped flat token file; same (seed, t)-pure interface —
    batch t reads deterministic offsets, so resume needs no state."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        cfg = self.cfg
        lo, hi = (host_slice.start, host_slice.stop) if host_slice \
            else (0, cfg.global_batch)
        n = len(self.tokens) - cfg.seq_len - 1
        rows = []
        for b in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, b]))
            off = int(rng.integers(0, n))
            rows.append(np.asarray(self.tokens[off:off + cfg.seq_len + 1]))
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def make_pipeline(cfg: DataConfig):
    return FileLMData(cfg) if cfg.kind == "file" else SyntheticLMData(cfg)
