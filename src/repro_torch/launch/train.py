"""End-to-end training driver, as the reference's
``repro/launch/train.py``: config registry -> planner (bandwidth-
allocating sharding plan) -> data pipeline -> AdamW -> train step ->
checkpoint manager -> fault-recovery loop.  It trains on one CUDA
device (``device=None`` means ``cuda``; the CPU only when asked for).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
      --smoke --steps 20 --batch 8 --seq 128 --device cpu

``--arch lm100m`` (the default) trains the ~100M-parameter dense model
`LM100M`; ``--layers N`` cuts a config to its first N layers at its
published widths (what fits one card).  It trains on one card: `build`
hands the planner the one-device mesh (`launch.mesh.make_smoke_mesh`),
prints its plan and installs no sharding rules (`launch.dryrun` traces
the production meshes' plans on the ``meta`` device).  Every family
trains on the card through hand-written forward and backward kernels:
the Mamba2 layers' SSD scan (`ssd`, `ssd_bwd`), the moe family's grouped
products (`ragged_dot` and its dx/dw kernels) and attention over more
than 4096^2 (query, key) pairs (flash attention and its dQ and dK/dV
kernels); the rest is plain torch under autograd.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import planner as planner_mod
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import FailureInjector, run_with_recovery

LM100M = ModelConfig(
    name="lm100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, head_dim=64, d_ff=3072, vocab=32000, tie_embeddings=True)


def build(cfg: ModelConfig, *, batch: int, seq: int, lr: float,
          steps: int, mesh=None, seed: int = 0, device=None):
    """(state, train_step, data, plan): the seeded model on ``device``
    with gradients on, AdamW's state and the step counter (int32, as the
    reference's), the step, the pipeline and the planner's plan."""
    dev = resolve_device(device)
    mesh = mesh or make_smoke_mesh()
    plan = planner_mod.plan(cfg, "train", seq, batch, mesh)
    optimizer = AdamW(lr=cosine_schedule(lr, max(steps // 20, 1), steps))
    model = M.init_params(cfg, seed, device=dev).requires_grad_()
    opt_state = optimizer.init(dict(model.named_parameters()))
    state = (model, opt_state, torch.zeros((), dtype=torch.int32,
                                           device=dev))
    train_step = M.make_train_step(cfg, optimizer)
    data = make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model,
        enc_seq=cfg.enc_seq))
    return state, train_step, data, plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced SMOKE_CONFIG")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to train on "
                         "the host)")
    args = ap.parse_args(argv)

    if args.arch == "lm100m":
        cfg = LM100M
    elif args.smoke:
        cfg = get_smoke_config(args.arch)
    else:
        cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    state, train_step, data, plan = build(
        cfg, batch=args.batch, seq=args.seq, lr=args.lr, steps=args.steps,
        device=args.device)
    n = M.count_params(cfg)
    print(f"training {cfg.name}: {n/1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq} steps={args.steps}")
    print(plan.summary())

    ckpt = CheckpointManager(args.ckpt, every=args.ckpt_every)
    injector = None
    if args.inject_failure_at >= 0:
        injector = FailureInjector({args.inject_failure_at: (0, "host")})

    first = [state]

    def init_state():
        """The built state, then (a restart with no checkpoint: the
        step updates the model in place) a fresh one."""
        return first.pop() if first else build(
            cfg, batch=args.batch, seq=args.seq, lr=args.lr,
            steps=args.steps, device=args.device)[0]

    t0 = time.time()
    state, history, restarts = run_with_recovery(
        train_step=train_step, init_state=init_state, data=data,
        ckpt_manager=ckpt, n_steps=args.steps, injector=injector)
    dt = time.time() - t0

    for i, h in enumerate(history):
        if i % args.log_every == 0 or i == len(history) - 1:
            print(f"step {i:5d} loss={h['loss']:.4f} ce={h['ce']:.4f} "
                  f"gnorm={h['grad_norm']:.2f}")
    tok_s = args.batch * args.seq * len(history) / dt
    print(f"done: {len(history)} steps in {dt:.1f}s "
          f"({tok_s:,.0f} tok/s), restarts={restarts}, "
          f"final loss {history[-1]['loss']:.4f} "
          f"(first {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
