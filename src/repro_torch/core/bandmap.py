"""The BandMap pipeline (paper Fig. 3): scheduling with bandwidth allocation
→ routing-resource pre-allocation → binding by MIS on the mixed conflict
graph → incomplete-mapping processing.

`map_dfg(..., mode="busmap")` runs the same pipeline with the BusMap
baseline policy (one port per datum, routing-PE broadcast), which is the
paper's comparison target.

This is the port's copy of `repro.core.bandmap`.  It differs in two
places: ``engine="device"`` (the default here) binds the port's
GPU-resident `mis_device.DeviceSBTS`, and ``device`` picks where that
engine runs (the race passes it on to its portfolio side).
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from repro_torch.obs.flight import recording
from repro_torch.obs.trace import live

from .certify import IICertificate, certify_ii_infeasible
from .cgra import CGRAConfig
from .conflict import (ConflictGraph, Vertex, build_conflict_graph,
                       constructive_init)
from .dfg import DFG
from .mis import (ROW_CACHE_LIMIT, PortfolioSBTS, ejection_repair,
                  mis_indices)
from .mis_device import DeviceSBTS, resolve_device
from .options import MapOptions
from .schedule import ScheduledDFG, mii, schedule_dfg
from .validate import ValidationReport, validate_mapping


@dataclasses.dataclass
class MappingResult:
    ok: bool
    mode: str
    ii: int
    mii: int
    n_routing_pes: int
    ports_per_vio: dict[int, int]
    placement: dict[int, Vertex]
    sched: ScheduledDFG | None
    report: ValidationReport | None
    cg_size: tuple[int, int]      # (|V_C|, |E_C|)
    mis_size: int
    n_ops: int
    attempts: int
    wall_s: float
    # II-infeasibility certificates collected along the way (one per
    # (II, jitter) combination proven unbindable and skipped).
    certificates: list[IICertificate] = dataclasses.field(
        default_factory=list)
    # Set by the exact backend (`repro_torch.exact`).  ``optimal`` marks
    # an ok=True result whose II is proven minimal: every lower
    # (II, jitter) combination from MII up carries a certificate (MII
    # itself is a sound absolute lower bound, so the claim is absolute
    # at II=MII and relative to the engine's deterministic schedule
    # family above it).  ``proved_infeasible`` marks an ok=False result
    # where *every* (II, jitter) combination up to ``max_ii`` was
    # certified unbindable — the sound negative the serve cache admits
    # even when validation attempts were spent along the way.
    # ``backend`` records which engine produced the result
    # ("portfolio" | "exact" | "race:portfolio" | "race:exact").
    optimal: bool = False
    proved_infeasible: bool = False
    backend: str = "portfolio"
    # Flight-recorder dump (JSON-able event dicts, `obs.flight`)
    # attached by `map_dfg` to every ok=False result mapped under a
    # live recorder — the last-N structured events (attempts,
    # certificates, harvest coverage, cancel) a postmortem needs
    # without a traced re-run.  Empty on successes and `record=None`
    # runs, so the common positive path stays lean.
    flight: tuple = ()

    @property
    def ii_ratio(self) -> float:
        """MII / II — the paper's throughput metric (1.0 = best)."""
        return self.mii / self.ii if self.ii else 0.0

    # ------------------------------------------------- serialization
    # Everything a MappingResult holds (ScheduledDFG, Vertex placement,
    # ValidationReport, IICertificate) is plain dataclasses + numpy, so
    # pickle round-trips it exactly; the version tag guards the serving
    # cache's on-disk artifacts (`serve.cache`) against silently loading
    # results written by an incompatible result layout.
    # v2: optimal / proved_infeasible / backend fields (exact backend).
    # v3: flight field (obs flight-recorder dump on failed results).
    SERIAL_VERSION = 3

    def to_bytes(self) -> bytes:
        import pickle
        return pickle.dumps((MappingResult.SERIAL_VERSION, self),
                            protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_bytes(data: bytes) -> "MappingResult":
        import pickle
        version, res = pickle.loads(data)
        if version != MappingResult.SERIAL_VERSION:
            raise ValueError(
                f"MappingResult serial version {version} != "
                f"{MappingResult.SERIAL_VERSION}")
        return res

    def summary(self) -> str:
        return (f"{self.mode}: II={self.ii} (MII={self.mii}, "
                f"ratio={self.ii_ratio:.2f}), routingPEs={self.n_routing_pes}, "
                f"|V_C|={self.cg_size[0]}, |E_C|={self.cg_size[1]}, "
                f"ok={self.ok}")

    def explain(self, *, tracer=None, flight=None):
        """Narrated report of *why* the mapping landed here: the II
        escalation path with per-II cause (static floor / certificate
        stage / portfolio exhaustion), routing-PE accounting, coverage
        curve and race outcome.  Returns `repro_torch.obs.ExplainReport`;
        pass the run's ``tracer`` for the coverage/kick detail (the
        result alone carries certificates and any attached flight
        dump).  Imported lazily — `repro_torch.obs.explain` must not be
        a dependency of constructing results."""
        from repro_torch.obs.explain import explain_result
        return explain_result(self, tracer=tracer, flight=flight)


def map_dfg(dfg: DFG, cgra: CGRAConfig,
            options: "MapOptions | dict | None" = None, *,
            cancel=None, tracer=None, record=None, device=None,
            **kwargs) -> MappingResult:
    """Run the full 4-phase mapping.  Phase 4 (incomplete-mapping
    processing) = MIS restarts with fresh seeds, re-scheduling with jitter
    (ASAP schedules are II-invariant, so jitter supplies the diversity),
    then II escalation — the retry loop of Fig. 3.

    Options — the `MapOptions` migration
    ------------------------------------
    Every mapping knob lives in `core.options.MapOptions` (frozen,
    grouped: ``schedule`` / ``certify`` / ``portfolio``); this is the
    single source engine modules read knobs from (the
    ``options-single-source`` AST lint rule).  Three call styles:

    - structured: ``map_dfg(dfg, cgra, MapOptions(mode="busmap",
      schedule=ScheduleOptions(max_ii=8)))``;
    - a plain option dict (the serve tier's wire format):
      ``map_dfg(dfg, cgra, {"mode": "busmap", "max_ii": 8})``;
    - legacy keywords, bit-identical to the pre-`MapOptions` engine:
      ``map_dfg(dfg, cgra, mode="busmap", max_ii=8)``.

    Dict and keyword forms go through exactly one adapter,
    `MapOptions.from_kwargs` (unknown keys warn and are dropped); the
    legacy->group renaming is `core.options.LEGACY_KNOBS`
    (``mis_restarts`` -> ``portfolio.restarts``, ``certify_budget`` ->
    ``certify.budget``, ...).  ``cancel`` and ``tracer`` stay true
    keyword arguments: they are runtime handles, not reproducible
    mapping knobs, and never enter `MapOptions.fingerprint` (the serve
    cache key).

    Knob highlights (full reference: `core.options` docstrings):
    ``certify`` runs the II-infeasibility certificate stages before the
    portfolio; ``bus_pressure`` folds provable bus-capacity structure
    into the conflict graph; ``static_prepass`` skips statically-doomed
    IIs via the schedule-free demand analysis; ``min_ii`` floors the II
    escalation (the co-mapper's common-II handle); ``row_cache_limit``
    bounds the unpacked-row caches in bytes; ``max_bus_fanout`` caps
    consumers per delivery port; ``group_move`` enables the clustered
    kick neighbourhood (`mis.GroupMoveConfig`); ``backend`` selects
    ``"portfolio"`` | ``"exact"`` | ``"race"`` (`repro.exact`).

    ``engine`` (``portfolio.engine``) selects the portfolio
    implementation: ``"device"`` (the default in this port) — the
    GPU-resident engine (`core.mis_device.DeviceSBTS`, ``device_seeds``
    trajectories through the hand-written `kernels.sbts_step` CUDA
    kernel) — or ``"numpy"``, the lock-step `mis.PortfolioSBTS` oracle
    on the host.  Both feed the same harvest → dedupe → repair →
    validate loop; device rounds trace as "portfolio-device" spans.
    ``device`` (default None, meaning ``"cuda"``) is where the device
    engine runs; like ``tracer`` it is a runtime handle, not a mapping
    knob, and never enters `MapOptions.fingerprint`.  With no GPU
    present a CUDA ``device`` raises: the engine never carries on on
    the CPU unless ``device="cpu"`` asks for it.  ``backend="race"``
    hands ``device`` to its portfolio side; ``backend="exact"`` runs
    on the host and ignores it.

    ``cancel`` (`core.cancel.CancelToken`) makes the run cooperatively
    cancellable: polled between (II, jitter) combinations, between
    harvest rounds, and inside the portfolio's iteration loop; a
    cancelled run returns its best-effort ``ok=False`` result.
    ``tracer`` (`repro_torch.obs.Tracer`, default None) records the run
    as a span tree — "map-dfg" at the root, per-phase children (see
    `repro.obs` for the stable span taxonomy).  ``record``
    (`repro_torch.obs.FlightRecorder`, default None) records the run's
    structured event stream into a bounded ring — cheap enough for
    production serving — and its `dump()` is attached as
    ``result.flight`` to every ``ok=False`` result, so failures carry
    their own postmortem.  All three defaults are bit-identical to the
    flag-less engine (NullTracer / NullFlightRecorder contracts,
    enforced by the ``tracer-default-none`` and
    ``recorder-default-none`` AST lint rules); like ``tracer``,
    ``record`` is a runtime handle, never a fingerprinted knob."""
    opts = MapOptions.coerce(options, kwargs)
    if opts.backend != "portfolio":
        from repro_torch.exact import exact_map_dfg, race_map_dfg
        if opts.backend == "exact":
            return exact_map_dfg(dfg, cgra, options=opts, cancel=cancel,
                                 tracer=tracer)
        if opts.backend == "race":
            # The port's runtime handle reaches the portfolio side.
            return race_map_dfg(dfg, cgra, options=opts, cancel=cancel,
                                tracer=tracer, record=record,
                                device=device)
        raise ValueError(f"unknown mapping backend {opts.backend!r}")
    if opts.portfolio.engine == "device":
        device = resolve_device(device)
    rec = recording(record)
    rec.emit("phase-begin", phase="map-dfg", mode=opts.mode,
             n_ops=len(dfg.ops))
    with live(tracer).span("map-dfg", mode=opts.mode,
                           n_ops=len(dfg.ops)) as sp:
        res = _map_dfg_portfolio(dfg, cgra, opts, cancel=cancel,
                                 tracer=tracer, record=record,
                                 device=device)
        sp.set(ok=res.ok, ii=res.ii, attempts=res.attempts)
    rec.emit("phase-end", phase="map-dfg", ok=res.ok, ii=res.ii,
             attempts=res.attempts)
    if record is not None:
        # Failed results carry their postmortem; successes stay lean.
        if not res.ok:
            res = dataclasses.replace(res, flight=record.dump())
    return res


def _map_dfg_portfolio(dfg: DFG, cgra: CGRAConfig, opts: "MapOptions",
                       *, cancel, tracer=None, record=None,
                       device=None) -> MappingResult:
    trc = live(tracer)
    rec = recording(record)
    t_start = _time.perf_counter()
    mode, seed = opts.mode, opts.seed
    sch, pf, ct = opts.schedule, opts.portfolio, opts.certify
    the_mii = mii(dfg, cgra)
    cache_limit = ROW_CACHE_LIMIT if pf.row_cache_limit is None \
        else pf.row_cache_limit
    device_engine = pf.engine == "device"
    round_span = "portfolio-device" if device_engine else "portfolio"
    static_floor, static_detail = the_mii, ""
    if ct.static_prepass:
        from repro_torch.analysis.demand import implied_demand_bounds
        rec.emit("phase-begin", phase="static-prepass", mii=the_mii)
        with trc.span("static-prepass", mii=the_mii) as ssp:
            for b in implied_demand_bounds(
                    dfg, cgra, max_bus_fanout=sch.max_bus_fanout):
                if b.min_ii > static_floor:
                    static_floor, static_detail = b.min_ii, b.summary()
            ssp.set(floor=static_floor)
        rec.emit("phase-end", phase="static-prepass", floor=static_floor)
    attempts = 0
    certificates: list[IICertificate] = []
    last: tuple = (None, None, None, 0, (0, 0))
    for cur_ii in range(max(the_mii, sch.min_ii or 0), sch.max_ii + 1):
        if cancel is not None and cancel.is_set():
            break
        if cur_ii < static_floor:
            # Schedule-free demand bound: unbindable at every jitter
            # (jitter=-1 marks the whole-slice claim) — skip the
            # schedule, the certificate stages and the portfolio.
            certificates.append(IICertificate(
                ii=cur_ii, jitter=-1, stage="static-demand",
                detail=static_detail, nodes=0, wall_s=0.0))
            rec.emit("static-skip", ii=cur_ii, floor=static_floor)
            continue
        for jitter in (0, 1, 2, 3):
            if cancel is not None and cancel.is_set():
                break
            rec.emit("attempt", ii=cur_ii, jitter=jitter)
            try:
                with trc.span("schedule", ii=cur_ii, jitter=jitter):
                    sched = schedule_dfg(
                        dfg, cgra, mode=mode, ii=cur_ii,
                        max_ii=cur_ii, use_grf=sch.use_grf,
                        jitter=jitter, seed=seed,
                        max_bus_fanout=sch.max_bus_fanout)
            except RuntimeError:
                continue
            cg = build_conflict_graph(sched, cgra,
                                      bus_pressure=opts.bus_pressure,
                                      tracer=tracer)
            n_ops = len(sched.dfg.ops)
            # One unpacked-row cache per conflict graph, shared by the
            # certificate search, the portfolio and the repair retries
            # (memoized on the graph — harvest rounds and repair retries
            # reuse it instead of re-unpacking n² rows each).
            shared_u8 = cg.row_cache(cache_limit)
            if ct.enabled:
                cert, csp_sols = certify_ii_infeasible(
                    cg, sched, cgra, jitter=jitter,
                    node_budget=ct.budget, row_cache=shared_u8,
                    n_placements=ct.n_exact_placements,
                    row_cache_limit=cache_limit, cancel=cancel,
                    tracer=tracer)
                if cert is not None:
                    # Proven unbindable: skip the whole portfolio budget
                    # for this (II, jitter) combination.
                    certificates.append(cert)
                    rec.emit("certificate", ii=cur_ii, jitter=jitter,
                             stage=cert.stage, nodes=cert.nodes)
                    if last[0] is None:
                        last = (sched, None, None, 0, (cg.n, cg.n_edges))
                    continue
                # The exhaustive stage enumerated complete conflict-free
                # placements — try each on the validator before paying
                # for the portfolio (several, because bus packing / LRF
                # residency can reject the first).
                for csp_sol in csp_sols or ():
                    attempts += 1
                    placement = {cg.vertices[i].op: cg.vertices[i]
                                 for i in mis_indices(csp_sol)}
                    with trc.span("validate", ii=cur_ii, source="csp"):
                        report = validate_mapping(sched, cgra, placement)
                    last = (sched, placement, report, n_ops,
                            (cg.n, cg.n_edges))
                    if not report.ok:
                        rec.emit("validate-reject", ii=cur_ii,
                                 source="csp")
                    if report.ok:
                        # The flag comes from the validator's report.
                        return MappingResult(
                            ok=report.ok, mode=mode, ii=cur_ii,
                            mii=the_mii,
                            n_routing_pes=sched.n_routing_ops,
                            ports_per_vio=dict(sched.ports_allocated),
                            placement=placement, sched=sched,
                            report=report, cg_size=(cg.n, cg.n_edges),
                            mis_size=n_ops, n_ops=n_ops,
                            attempts=attempts,
                            wall_s=_time.perf_counter() - t_start,
                            certificates=certificates)
            # Spend extra effort at II = MII: throughput is the top concern
            # (paper §III-A), so a success there dominates any II+1 mapping.
            budget = pf.restarts * (2 if cur_ii == the_mii else 1)
            # Multi-seed SBTS portfolio: K independent trajectories advance
            # in lock-step over the packed adjacency, early-exiting as soon
            # as any seed covers every op.  Most seeds warm-start from the
            # structure-aware constructive placement; some stay cold.
            base = seed * 1001 + cur_ii * 131 + jitter * 31
            with trc.span("portfolio-init", ii=cur_ii, jitter=jitter,
                          seeds=budget, engine=pf.engine):
                inits = [constructive_init(cg, sched, cgra,
                                           seed=base + k)
                         if k % 3 != 2 else None for k in range(budget)]
                attempts += budget
                op_of = cg.op_of
                if device_engine:
                    # GPU-resident engine: the same constructive warm
                    # starts, fanned out to `device_seeds` lock-step
                    # trajectories on ``device``.
                    sbts = DeviceSBTS(cg.bits, inits,
                                      k=pf.device_seeds, seed=base,
                                      device=device)
                else:
                    sbts = PortfolioSBTS(cg.bits, inits, seed=base,
                                         row_cache=shared_u8,
                                         row_cache_limit=cache_limit,
                                         op_of=op_of,
                                         group_move=pf.group_move)
            # Repair retries reuse the same cache; when the graph was too
            # big for it, row_cache() materialises one lazily so the
            # retries don't each re-unpack n² rows.
            row_cache = shared_u8
            seen_sols: set[bytes] = set()
            remaining = pf.iters
            # Harvest rounds: run the portfolio until some seed covers all
            # ops, validate every distinct complete solution, and — when
            # the validator rejects them all (bus congestion / LRF
            # overflow are invisible to the pairwise graph) — re-arm the
            # complete seeds with a diversifying perturbation and resume
            # the same trajectories until the iteration budget is spent.
            fresh = budget
            for rnd in range(4 * budget):
                if cancel is not None and cancel.is_set():
                    break
                start_it = sbts.it
                with trc.span(round_span, ii=cur_ii, jitter=jitter,
                              round=rnd) as psp:
                    bests = sbts.run(remaining, target=n_ops,
                                     cancel=cancel, tracer=tracer)
                    best_cov = int(sbts.best_size.max()) if sbts.k \
                        else 0
                    psp.set(iters=sbts.it - start_it, best=best_cov,
                            coverage=best_cov / n_ops if n_ops else 1.0)
                    trc.gauge("portfolio.best", best_cov)
                    trc.gauge("portfolio.coverage",
                              best_cov / n_ops if n_ops else 1.0)
                rec.emit("harvest-round", ii=cur_ii, jitter=jitter,
                         round=rnd, best=best_cov,
                         coverage=best_cov / n_ops if n_ops else 1.0)
                remaining -= sbts.it - start_it
                order = np.argsort(-bests.sum(axis=1), kind="stable")
                for k in order:
                    sol = bests[k].copy()
                    key = sol.tobytes()
                    if key in seen_sols:
                        # Seeds often converge to the same best set;
                        # repairing duplicates wastes the ejection budget.
                        continue
                    seen_sols.add(key)
                    size = int(sol.sum())
                    if 0 < n_ops - size <= 4:
                        # Ejection-chain repair of small shortfalls
                        # (multi-seed: candidate order is randomised, so
                        # retries differ).
                        rs = base + rnd * 97 + int(k)
                        with trc.span("repair", ii=cur_ii,
                                      shortfall=n_ops - size):
                            if row_cache is None:
                                # Lazy n² unpack — on 16x16 graphs this
                                # dominates the first repair's wall.
                                row_cache = sbts.row_cache()
                            for rk in range(6):
                                fixed = ejection_repair(
                                    cg.bits, sol, cg.op_vertices, op_of,
                                    depth=4, seed=rs * 13 + rk,
                                    row_cache=row_cache)
                                if int(fixed.sum()) >= n_ops:
                                    sol = fixed
                                    break
                            else:
                                sol = fixed
                        size = int(sol.sum())
                    if size < n_ops:
                        last = (sched, None, None, size,
                                (cg.n, cg.n_edges))
                        continue
                    placement = {cg.vertices[i].op: cg.vertices[i]
                                 for i in mis_indices(sol)}
                    with trc.span("validate", ii=cur_ii,
                                  source="portfolio"):
                        report = validate_mapping(sched, cgra, placement)
                    last = (sched, placement, report, size,
                            (cg.n, cg.n_edges))
                    if not report.ok:
                        rec.emit("validate-reject", ii=cur_ii,
                                 source="portfolio")
                    if report.ok:
                        # The flag comes from the validator's report.
                        return MappingResult(
                            ok=report.ok, mode=mode, ii=cur_ii,
                            mii=the_mii,
                            n_routing_pes=sched.n_routing_ops,
                            ports_per_vio=dict(sched.ports_allocated),
                            placement=placement, sched=sched,
                            report=report, cg_size=(cg.n, cg.n_edges),
                            mis_size=size, n_ops=n_ops, attempts=attempts,
                            wall_s=_time.perf_counter() - t_start,
                            certificates=certificates)
                if remaining <= 0:
                    break
                # Alternate a local diversification with a fully fresh
                # restart (the portfolio analogue of the paper's
                # independent-restart retry) for every harvested seed.
                complete = np.flatnonzero(sbts.best_size >= n_ops)
                if device_engine:
                    # With K ~ 1000 device trajectories, hundreds may
                    # converge per round; re-seeding them all would pay
                    # a constructive_init per seed on the host.  The
                    # top 16 preserve the diversification pattern at
                    # bounded host cost.
                    complete = complete[:16]
                for j, k in enumerate(complete):
                    if j % 2 == 0:
                        sbts.rearm(int(k))
                    else:
                        fresh += 1
                        sbts.reset_seed(int(k), constructive_init(
                            cg, sched, cgra, seed=base + fresh))
    sched, placement, report, size, cg_size = last
    if cancel is not None and cancel.is_set():
        rec.emit("cancelled", ii=sched.ii if sched else -1)
    # attempts == 0 with certificates attached means every (II, jitter)
    # combination that scheduled was *proven* unbindable before any
    # stochastic search ran — a full-range UNSAT proof, unless a cancel
    # cut the II loop short (then the certificates only cover a prefix
    # of the range and the result must not claim the proof).
    proved = bool(certificates) and attempts == 0 \
        and not (cancel is not None and cancel.is_set())
    return MappingResult(
        ok=False, mode=mode, ii=sched.ii if sched else -1, mii=the_mii,
        n_routing_pes=sched.n_routing_ops if sched else 0,
        ports_per_vio=dict(sched.ports_allocated) if sched else {},
        placement=placement or {}, sched=sched, report=report,
        cg_size=cg_size, mis_size=size,
        n_ops=len(sched.dfg.ops) if sched else 0, attempts=attempts,
        wall_s=_time.perf_counter() - t_start,
        certificates=certificates, proved_infeasible=proved)


def compare_modes(dfg: DFG, cgra: CGRAConfig, *, seed: int = 0,
                  **kw) -> dict[str, MappingResult]:
    """BandMap vs BusMap on the same DFG/CGRA — the paper's experiment."""
    return {m: map_dfg(dfg, cgra, mode=m, seed=seed, **kw)
            for m in ("bandmap", "busmap")}
