"""Fault tolerance: checkpoint-scoped recovery loop with failure
injection.

On a real multi-pod deployment the failure signal comes from the
coordinator (missed heartbeats / ICI timeout); here the same
control flow is exercised through `FailureInjector`, a deterministic
schedule of simulated failures that unit/integration tests drive.

The recovery contract (tested in tests/test_runtime.py and
tests/test_torch_runtime.py):
- a failure at step t never loses more than `ckpt_every` steps;
- the data pipeline replays exactly (batch = f(seed, step) — stateless);
- recovery re-enters through the SAME step function (in the JAX package
  the same jitted step: no recompile when the mesh is unchanged) or
  through an elastic re-plan (runtime/elastic.py) when hosts were
  lost.
"""

from __future__ import annotations

import dataclasses
import logging
import time

log = logging.getLogger("repro_torch.runtime")


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int, host: int, kind: str = "host_down"):
        super().__init__(f"simulated {kind} on host {host} at step {step}")
        self.step = step
        self.host = host
        self.kind = kind


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: (host, kind)}."""
    schedule: dict
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            host, kind = self.schedule[step]
            raise SimulatedFailure(step, host, kind)


def run_with_recovery(*, train_step, init_state, data, ckpt_manager,
                      n_steps: int, injector: FailureInjector | None = None,
                      on_failure=None, max_restarts: int = 8):
    """Run `n_steps`, checkpointing via ckpt_manager, recovering from
    (simulated) failures by restoring the latest checkpoint.

    train_step(state, batch) -> (state, metrics).
    on_failure(failure, state_like) -> (state, start_step) | None —
    hook for elastic re-planning; default restores same-mesh.
    ``init_state`` is the state, or a function that makes it: the port's
    train step updates its model in place, so a restart with no
    checkpoint to restore calls it again for a fresh state (a state
    given as a value is reused, as the JAX package's immutable one is).
    Returns (final_state, history, n_restarts)."""
    fresh = init_state if callable(init_state) else lambda: init_state
    state = fresh()
    step = 0
    history = []
    restarts = 0
    while step < n_steps:
        try:
            while step < n_steps:
                if injector is not None:
                    injector.check(step)
                batch = data.batch(step)
                state, metrics = train_step(state, batch)
                history.append({k: float(v) for k, v in metrics.items()})
                step += 1
                ckpt_manager.maybe_save(state, step)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("failure: %s — restoring", e)
            if on_failure is not None:
                out = on_failure(e, state)
                if out is not None:
                    state, step = out
                    continue
            try:
                state, manifest = ckpt_manager.restore_latest(state)
                step = manifest["step"]
            except FileNotFoundError:
                state, step = fresh(), 0
    return state, history, restarts


@dataclasses.dataclass
class Heartbeat:
    host: int
    step: int
    t: float


class HeartbeatMonitor:
    """Tracks per-host liveness; a host missing for > timeout heartbeats
    is declared failed (drives the coordinator on real deployments)."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.last: dict[int, float] = {}

    def beat(self, host: int, step: int, t: float | None = None) -> None:
        self.last[host] = t if t is not None else time.time()

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        return [h for h in range(self.n_hosts)
                if now - self.last.get(h, 0.0) > self.timeout_s]
