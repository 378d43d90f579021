"""Exact-vs-portfolio race: first *sound* answer wins.

`race_map_dfg` runs the complete prover (`repro_torch.exact.backend`) and the
stochastic portfolio (`bandmap.map_dfg`) on the same problem in two
threads and returns the first answer that is **sound**:

- an ``ok=True`` result (validator-accepted — from either side);
- an ``ok=False`` with ``proved_infeasible`` — the exact backend
  certified every (II, jitter) combination up to ``max_ii``, or the
  portfolio's pre-existing certificate-backed fast-fail covered the
  whole range with ``attempts == 0`` (`map_dfg` folds that judgement
  into the same flag, and clears it when a cancel cut the loop short).

A portfolio budget exhaustion is *not* sound — a different seed might
succeed — so the race holds it and waits for the prover.  The loser is
cancelled through a shared `core.cancel.CancelToken` chain threaded
into `map_dfg`'s harvest rounds, `PortfolioSBTS.run`'s iteration loop
and the CSP's node loop, so losing work stops within a bounded number
of iterations instead of running out its budget.  A crashed prover
degrades the race to portfolio-only (and vice versa); the request only
fails if both sides fail.

The contract is deliberately "first sound answer", not "best answer":
when the portfolio lands a validated II before the prover finishes,
that II is returned even though the prover might later certify a lower
one — the race trades the optimality *claim* (the winner's ``optimal``
flag is only set on exact wins) for latency, never soundness.  Winners
are tagged ``backend="race:exact"`` / ``"race:portfolio"``.

This is the port's copy of `repro.exact.race`.  It takes one more
runtime handle, ``device``, which reaches the portfolio side's
`map_dfg`: with the port's default ``engine="device"`` that side runs
`mis_device.DeviceSBTS` on the card, and the device is resolved on the
calling thread first, so a missing GPU raises here instead of
degrading the race to its exact side.  That engine polls ``cancel``
between chunks of ``chunk_size`` iterations, so a cancelled device
portfolio may run up to one chunk past the cancel request.
"""

from __future__ import annotations

import dataclasses
import time as _time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

from repro_torch.core.bandmap import MappingResult
from repro_torch.core.cancel import CancelToken
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.dfg import DFG
from repro_torch.core.mis_device import resolve_device
from repro_torch.core.options import MapOptions
from repro_torch.obs.flight import recording
from repro_torch.obs.trace import live

from .backend import exact_map_dfg


def _is_sound(res: MappingResult | None) -> bool:
    """A result the race may return without waiting for the rival.

    Deliberately *not* the raw ``attempts == 0 and certificates``
    pattern: a side cancelled mid-II-loop returns certificates that
    only cover a prefix of the range, and `map_dfg` / `exact_map_dfg`
    already fold the "covered everything, uncancelled" judgement into
    ``proved_infeasible``."""
    return res is not None and (res.ok or res.proved_infeasible)


def race_map_dfg(dfg: DFG, cgra: CGRAConfig,
                 options: "MapOptions | dict | None" = None, *,
                 cancel=None, tracer=None, record=None, device=None,
                 **kwargs) -> MappingResult:
    """Race the exact backend against the portfolio (module docstring).

    Accepts the same `MapOptions` / dict / legacy-keyword forms as
    `map_dfg`; ``certify.exact_node_budget`` is the prover's
    per-(II, jitter) node budget (defaults to ``certify.budget``).
    Both sides run under the same ``seed``, so they explore the same
    deterministic schedule family — which is what makes an exact UNSAT
    binding on the portfolio side's schedules too.  ``cancel`` cancels
    the whole race.

    ``tracer`` records a "race" span (attrs: ``winner``,
    ``cancel_latency_s`` = cancel-request→loser-exit wall, and — when
    the loser is the portfolio — ``loser_iters_after_cancel``, the
    portfolio iterations the loser spent *after* the cancel request;
    the numpy engine's poll-at-iteration-top contract bounds it at 1,
    the device engine's poll between chunks at ``chunk_size``) plus
    one "race-side" span per side.  Both sides share the tracer: the
    span records carry thread ids, so the export lays them out as
    separate Perfetto tracks.

    ``record`` (`repro_torch.obs.FlightRecorder`, default None) is shared
    with the portfolio side and additionally receives the race's own
    "race-cancel" / "race-winner" events; when no sound answer lands,
    the returned failure carries the full dump (the same
    ``result.flight`` contract as `map_dfg`).

    ``device`` (default None, meaning ``"cuda"``) is where the
    portfolio side's device engine runs; a runtime handle like
    ``tracer``, never a fingerprinted knob."""
    from repro_torch.core.bandmap import map_dfg

    opts = MapOptions.coerce(options, kwargs)
    # Both sides run the problem directly — neither must re-enter the
    # race dispatch, so the shared option set pins backend explicitly.
    exact_opts = opts.replace(
        backend="exact",
        certify_budget=opts.certify.exact_node_budget
        if opts.certify.exact_node_budget is not None
        else opts.certify.budget)
    port_opts = opts.replace(backend="portfolio")
    if port_opts.portfolio.engine == "device":
        # Resolved here, not in the portfolio's thread: a missing GPU
        # must raise, not crash one side and leave the race to the other.
        device = resolve_device(device)
    trc = live(tracer)
    rec = recording(record)
    tok_exact = CancelToken(parent=cancel)
    tok_port = CancelToken(parent=cancel)

    def run_exact() -> MappingResult:
        with trc.span("race-side", side="exact") as sp:
            res = exact_map_dfg(dfg, cgra, options=exact_opts,
                                cancel=tok_exact, tracer=tracer)
            sp.set(ok=res.ok, wall_s=res.wall_s)
            return res

    def run_portfolio() -> MappingResult:
        with trc.span("race-side", side="portfolio") as sp:
            res = map_dfg(dfg, cgra, options=port_opts,
                          cancel=tok_port, tracer=tracer,
                          record=record, device=device)
            sp.set(ok=res.ok, wall_s=res.wall_s)
            return res

    rsp = trc.span("race", mode=opts.mode)
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = {pool.submit(run_exact): "exact",
                pool.submit(run_portfolio): "portfolio"}
        held: dict[str, MappingResult] = {}
        errors: dict[str, BaseException] = {}
        winner: tuple[str, MappingResult] | None = None
        pending = set(futs)
        while pending and winner is None:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                side = futs[fut]
                try:
                    res = fut.result()
                except Exception as exc:   # crashed worker: degrade to
                    errors[side] = exc     # the surviving side
                    continue
                if _is_sound(res):
                    winner = (side, res)
                    break
                held[side] = res
        # First sound answer in hand (or no side can produce one):
        # stop the rival — it polls the token within a bounded number
        # of iterations/nodes.  Snapshot the portfolio-iteration counter
        # *before* requesting the cancel, so the loser's post-cancel
        # work is the counter delta at its exit.
        iters_at_cancel = trc.counter_value("portfolio.iters")
        rec.emit("race-cancel",
                 winner=winner[0] if winner is not None else "none")
        t_cancel = _time.perf_counter()
        tok_exact.cancel()
        tok_port.cancel()
        # Drain the loser (the original code let pool.shutdown absorb
        # it, which is exactly why its cancel wall was invisible):
        # record cancel-request→exit latency per still-pending side.
        cancel_latency = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            t_exit = _time.perf_counter()
            for fut in done:
                side = futs[fut]
                try:
                    res = fut.result()
                except Exception as exc:
                    errors[side] = exc
                else:
                    held.setdefault(side, res)
                if winner is not None and side != winner[0]:
                    cancel_latency = t_exit - t_cancel
                    rsp.set(loser=side,
                            cancel_latency_s=cancel_latency)
                    if side == "portfolio":
                        rsp.set(loser_iters_after_cancel=int(
                            trc.counter_value("portfolio.iters")
                            - iters_at_cancel))
    finally:
        pool.shutdown(wait=True)
    with rsp:
        if winner is not None:
            side, res = winner
            rsp.set(winner=side)
            rec.emit("race-winner", winner=side,
                     cancel_latency_s=cancel_latency)
            res = dataclasses.replace(res, backend=f"race:{side}")
            if record is not None:
                # A sound negative (proved infeasible) is still a
                # failure worth a postmortem: refresh its dump so the
                # race-cancel/race-winner tail is included.
                if not res.ok:
                    res = dataclasses.replace(res,
                                              flight=record.dump())
            return res
        # No sound answer: prefer the portfolio's best-effort failure
        # (it carries the partial-coverage diagnostics), then the
        # prover's.
        rsp.set(winner="none")
        rec.emit("race-winner", winner="none",
                 cancel_latency_s=cancel_latency)
        for side in ("portfolio", "exact"):
            if side in held:
                res = dataclasses.replace(held[side],
                                          backend=f"race:{side}")
                if record is not None:
                    if not res.ok:
                        res = dataclasses.replace(res,
                                                  flight=record.dump())
                return res
        raise errors["portfolio"] if "portfolio" in errors \
            else errors["exact"]
