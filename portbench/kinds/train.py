"""The runner of the ``train`` kind: training steps of `repro_torch`.

One run:

1. Set-up.  The program's trainer is built as `launch.train.build`
   composes it (`models.model.make_train_step` with `optim.AdamW` on
   `optim.cosine_schedule`), on the configuration the port registers
   (`configs.get_config`, with the file's cut and options), and its
   parameters are
   overwritten with the benchmark's weights (`bench.weights`).  The
   first ``checked_steps`` steps run through the window's own call on
   the window's own feed; what the check compares is read from them:
   each step's loss, each leaf's first gradient as AdamW holds it after
   one step (its first moment over 1 - b1) and each leaf's change over
   the steps.  They warm up every shape the window uses.
2. The window: steps back to back for ``seconds``, each on a new batch,
   its metrics read to the host after it (as `runtime.run_with_recovery`
   reads them).  With ``trace``, ``profiled_steps`` more steps run under
   `torch.profiler`, inside the benchmark's spans.
3. The program's state is freed and the plain reference
   (`portbench.reference`) trains from the same weights on the same
   batches; the gaps between the two (`reference.compare`) are held to
   the cell's limits.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from portbench.bench import tokens, trace as tr, weights
from portbench.reference import compare, model as R
from portbench.reference import train as RT

#: Fields of the port's `ModelConfig` that a configuration file may state,
#: each held to the registered configuration with the cut and the
#: options applied.
PROGRAM_FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "d_state", "ssm_expand",
                  "ssm_head_dim", "ssm_chunk", "ssm_groups", "norm", "act",
                  "gated_mlp", "qkv_bias", "sliding_window",
                  "tie_embeddings", "rope_theta", "remat", "logits_dtype")
#: AdamW's settings, held to the port's defaults.
ADAMW_FIELDS = ("b1", "b2", "eps", "weight_decay", "clip_norm")


def program_config(config: dict):
    """The port's registered configuration with the file's ``cut`` (the
    keys in ``reduced``) and ``options`` (published settings that the
    registered configuration departs from and the port takes as an
    option), checked against every field the file states."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(config["registry"]),
                              **config.get("cut", {}),
                              **config.get("options", {}))
    wrong = {k: (config[k], getattr(cfg, k)) for k in PROGRAM_FIELDS
             if k in config and config[k] != getattr(cfg, k)}
    if wrong:
        raise ValueError(f"the port's {config['registry']} differs from "
                         f"the configuration file (file, port): {wrong}")
    return cfg


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program under test for one seed: the built trainer with the
    benchmark's weights, its state, and the cell's batches.

    ``fault`` plants one of the check's faults: "unchanged" (each step
    returns its state unchanged), "half_batch" (half of each batch's
    tokens left out of the loss, its mean taken over the rest) or
    "bwd_scaled" (`BwdFault`: the gradient that a backward kernel gives
    one input, scaled)."""

    def __init__(self, cell, seed: int, device, fault: str | None = None):
        from repro_torch.launch.train import build
        from repro_torch.optim import AdamW
        traffic, opt = cell.traffic, cell.traffic["optimizer"]
        wrong = {k: (opt[k], getattr(AdamW(), k)) for k in ADAMW_FIELDS
                 if opt[k] != getattr(AdamW(), k)}
        if wrong:
            raise ValueError(f"AdamW's settings differ from the traffic "
                             f"file (file, port): {wrong}")
        self.cfg = program_config(cell.config)
        self.device, self.seed, self.cell = device, seed, cell
        self.specs = R.param_specs(cell.config)
        self.state, self.train_step, _, _ = build(
            self.cfg, batch=traffic["batch"], seq=traffic["seq_len"],
            lr=opt["lr"], steps=opt["total_steps"], device=device)
        params = dict(self.state[0].named_parameters())
        want = {name: tuple(shape) for name, shape, _ in self.specs}
        have = {k: tuple(p.shape) for k, p in params.items()}
        if want != have:
            raise ValueError("the program's parameters differ from the "
                             "reference's: " + str(sorted(
                                 set(want.items()) ^ set(have.items()))))
        flat, views = weights.make(self.specs, seed, device)
        with torch.no_grad():
            torch._foreach_copy_([params[k] for k in want],
                                 [views[k] for k in want])
        del flat, views
        self.batches = tokens.Batches(traffic, cell.config["vocab"], seed,
                                      device)
        self.fault, self.undo = fault, None
        if fault == "unchanged":
            self.train_step = self._unchanged
        elif fault == "bwd_scaled":
            self.undo = BwdFault.plant()
        elif fault not in (None, "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")

    def _unchanged(self, state, batch):
        from repro_torch.models import model as M
        with torch.no_grad():
            loss, metrics = M.loss_fn(self.cfg, state[0], batch)
        return state, dict(metrics, loss=loss,
                           grad_norm=torch.zeros((), device=loss.device))

    def batch(self, i: int) -> dict:
        batch = self.batches(i)
        if self.fault == "half_batch":
            labels = batch["labels"].clone()
            b, s = labels.shape
            if b > 1:
                labels[b // 2:] = -1
            else:
                labels[:, s // 2:] = -1
            batch["labels"] = labels
        return batch

    def step(self, i: int, traced: bool = False) -> dict:
        """Step ``i`` on its batch; its metrics on the host."""
        with tr.span("batch", traced):
            batch = self.batch(i)
        with tr.span("step", traced):
            self.state, metrics = self.train_step(self.state, batch)
        with tr.span("metrics", traced):
            return {k: float(v) for k, v in metrics.items()}

    def first_gradients(self) -> dict:
        """Each leaf's norm of the clipped gradient AdamW took in its one
        step so far: its first moment over 1 - b1."""
        mu = self.state[1]["mu"]
        b1 = self.cell.traffic["optimizer"]["b1"]
        names = [name for name, _, _ in self.specs]
        norms = torch.stack(torch._foreach_norm([mu[k] for k in names]))
        return dict(zip(names, (norms / (1 - b1)).tolist()))

    def changes(self) -> dict:
        """Each leaf's norm of its change from the seed's weights."""
        params = dict(self.state[0].named_parameters())
        names = [name for name, _, _ in self.specs]
        flat, views = weights.make(self.specs, self.seed, self.device)
        with torch.no_grad():
            diff = torch._foreach_sub([params[k] for k in names],
                                      [views[k] for k in names])
            norms = torch.stack(torch._foreach_norm(diff)).tolist()
        del flat, views, diff
        return dict(zip(names, norms))

    def checked_steps(self) -> dict:
        """The first steps, and what the check compares of them."""
        losses, grads, at = [], None, time.perf_counter()
        self.checked_walls = []
        for i in range(self.cell.traffic["checked_steps"]):
            losses.append(self.step(i)["loss"])
            self.checked_walls.append(time.perf_counter() - at)
            if grads is None:
                grads = self.first_gradients()
            at = time.perf_counter()
        return {"losses": losses, "grad_norms": grads,
                "change_norms": self.changes()}

    def close(self) -> None:
        if self.undo is not None:
            self.undo()
            self.undo = None
        self.state = self.train_step = self.batches = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class BwdFault(torch.autograd.Function):
    """A fault in a backward kernel's output: the gradient that flash
    attention's backward gives K, and the one that the SSD's backward
    gives B, times `FACTOR`; the forward is untouched.  Planted at the
    program's calls of the two kernels, so the timed path runs it."""

    FACTOR = 1.5

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * BwdFault.FACTOR

    @staticmethod
    def plant():
        """Plant the fault; returns the call that takes it out."""
        from repro_torch.models import attention, ssm
        attend, scan = attention._flash_or_sdpa, ssm.ssd_ops.ssd

        def faulty_attend(q, k, v, **kw):
            return attend(q, BwdFault.apply(k), v, **kw)

        def faulty_scan(x, dt, a_log, b, c, **kw):
            return scan(x, dt, a_log, BwdFault.apply(b), c, **kw)

        attention._flash_or_sdpa, ssm.ssd_ops.ssd = faulty_attend, \
            faulty_scan

        def undo():
            attention._flash_or_sdpa, ssm.ssd_ops.ssd = attend, scan
        return undo


def reference(cell, seed: int, device, precision: str = "float32") -> dict:
    """The reference's readings over the checked steps, from the seed's
    weights and batches; ``precision`` "float8" is the check's control."""
    specs = R.param_specs(cell.config)
    flat, views = weights.make(specs, seed, device)
    feed = tokens.Batches(cell.traffic, cell.config["vocab"], seed, device)
    batches = [feed(i) for i in range(cell.traffic["checked_steps"])]
    opt = cell.traffic["optimizer"]
    out = RT.readings(cell.config, opt, views, batches, precision=precision)
    del flat, views
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell, seed: int, seconds: float, traced: bool, *, device="cuda",
        t0: float | None = None, fault: str | None = None) -> dict:
    """One run of ``cell``: {"e2e", "correct", "checks", "attempted",
    "failed", "memory_peak_bytes", "record"} (the traced steps' record,
    or None)."""
    t0 = time.perf_counter() if t0 is None else t0
    on_card = torch.device(device).type == "cuda"
    phases = [("start", time.perf_counter())]
    program = Program(cell, seed, device, fault)
    phases.append(("build", time.perf_counter()))
    got = program.checked_steps()
    phases.append(("checked", time.perf_counter()))
    # Python's generation-2 collections pause the host for ~0.2 s every
    # 8-9 s of these steps.  Starting the window on a fresh collection
    # puts them on the same steps in every run; the window still pays
    # each one it holds.
    gc.collect()
    sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    phases.append(("collect", time.perf_counter()))
    note("set-up phases (s): " + ", ".join(
        f"{name} {t - before:.3f}" for (_, before), (name, t) in
        zip([("process", t0)] + phases, phases)) +
        f"; checked steps {[round(w, 3) for w in program.checked_walls]}")

    i, failed, walls = cell.traffic["checked_steps"], 0, []
    start = at = time.perf_counter()
    while True:
        loss = program.step(i)["loss"]
        i, now = i + 1, time.perf_counter()
        walls.append(now - at)
        at = now
        failed += not math.isfinite(loss)
        if now - start >= seconds:
            break
    elapsed, steps = at - start, len(walls)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tokens_per_step = cell.traffic["batch"] * cell.traffic["seq_len"]

    record = None
    if traced:
        gc.collect()
        record = profile_steps(program, i, cell.traffic["profiled_steps"])
        record.update(step_wall_s=elapsed / steps, config=cell.config,
                      traffic=cell.traffic)
    program.close()
    del program
    note(f"set-up {setup_s:.3f} s, window {steps} steps in {elapsed:.3f} s; "
         f"step walls {[round(w, 4) for w in walls]}")

    t_ref = time.perf_counter()
    want = reference(cell, seed, device)
    note(f"reference {time.perf_counter() - t_ref:.3f} s")
    correct, checks = compare.checks(compare.gaps(got, want),
                                     cell.limits["limits"])
    return {"e2e": {"train_tokens_per_s": steps * tokens_per_step / elapsed,
                    "train_peak_gb": peak / 1e9, "setup_s": setup_s},
            "correct": correct and failed == 0, "checks": checks,
            "attempted": steps, "failed": failed,
            "memory_peak_bytes": max(setup_peak, peak), "record": record}


def note(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def profile_steps(program: Program, first: int, n: int) -> dict:
    """Steps ``first`` .. ``first + n - 1`` under `torch.profiler`, each
    inside the benchmark's spans; their record (`bench.trace`), with the
    kernel launches the program counted meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            program.step(i, traced=True)
        sync(program.device)
    t = time.perf_counter()
    record = tr.collect(prof)
    note(f"trace read in {time.perf_counter() - t:.3f} s: "
         f"{len(record['device'])} device, {len(record['host'])} host events")
    record.update(steps=n, launches={
        k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()})
    return record
