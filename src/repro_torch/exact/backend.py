"""The exact mapping backend: a complete prover over the engine's own
search space.

This is the port's copy of `repro.exact.backend`: a numpy CSP on the
host, with no kernel and no device.  It differs only in its success
return, which takes ``ok`` from the validator's report.

`exact_map_dfg` walks the same (II, jitter) schedule lattice as
`bandmap.map_dfg` — the deterministic modulo scheduler at jitters
0..3 per II, II escalating from max(MII, ``min_ii``) — but replaces
the stochastic portfolio with the certificate machinery run to
*decision*:

- **Encoding.**  Per (II, jitter) schedule, the CP/SAT-style model is
  the mixed conflict graph itself: one variable per op over its
  candidate tuples (TIN port tuples, TOUT port tuples, QUAD PE slots,
  routing drives), pairwise constraints = occupancy cliques +
  dependency realizability + `bus_pressure_edges` + the Hall-style
  joint bus-demand bound (`repro_torch.exact.hall`) folding per-(scope, bus,
  cycle) capacity into the graph.
- **Search.**  `certify._search_complete` with its MRV /
  most-constraining tie-break / forward checking and the *verified*
  row/column symmetry-orbit pruning, run in online mode: every
  complete conflict-free placement is handed to `validate_mapping`
  (the engine's single soundness authority — concrete bus-instance
  packing, LRF/GRF residency) as it is found.  Accept ⇒ SAT for this
  schedule; exhaustion with every placement rejected ⇒ UNSAT for this
  schedule (sound because the validator is equivariant under the
  fabric's row/column relabelings, so rejecting an orbit
  representative rejects its orbit — asserted in
  tests/test_exact_differential.py).
- **Verdicts.**  The first validator-accepted placement returns
  ``ok=True`` with ``optimal=True`` iff every lower (II, jitter)
  combination was certified UNSAT (or unschedulable): at II = MII the
  claim is absolute (MII is a sound lower bound for *any* modulo
  schedule); above it, it is optimality within the engine's schedule
  family — the exact guarantee the differential tests lean on, since
  the portfolio searches the same family and therefore can never beat
  a proven exact II.  If the whole range up to ``max_ii`` is certified,
  the result is ``ok=False`` with ``proved_infeasible=True`` — the
  certificate-backed negative the serve cache admits.

Budget knobs
------------
``node_budget`` caps CSP nodes per (II, jitter) combination (the knob
`map_dfg(backend="exact")` maps ``certify_budget`` onto).  A
combination that exhausts the budget is *unknown*: the backend keeps
escalating II and can still return a mapping, but drops the
``optimal`` / ``proved_infeasible`` claims — budgets degrade the
claim, never the soundness.  ``cancel`` (`core.cancel.CancelToken`) is
polled between combinations and every few dozen search nodes; a
cancelled run returns a claim-less ``ok=False`` result, which is how
the race driver (`repro_torch.exact.race`) discards a losing prover
mid-search.
"""

from __future__ import annotations

import time as _time

import numpy as np

from repro_torch.core.bandmap import MappingResult
from repro_torch.core.certify import IICertificate, certify_ii_infeasible
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.conflict import build_conflict_graph
from repro_torch.core.dfg import DFG
from repro_torch.core.mis import ROW_CACHE_LIMIT, mis_indices
from repro_torch.core.options import MapOptions
from repro_torch.core.schedule import mii, schedule_dfg
from repro_torch.core.validate import validate_mapping
from repro_torch.obs.trace import live

from .hall import hall_pressure_edges


class _ValidateSink:
    """`on_solution` callback: validate each complete placement the CSP
    enumerates, keep the first accepted one."""

    def __init__(self, sched, cg, cgra) -> None:
        self.sched, self.cg, self.cgra = sched, cg, cgra
        self.tried = 0
        self.accepted: tuple | None = None

    def __call__(self, memb: np.ndarray) -> bool:
        self.tried += 1
        placement = {self.cg.vertices[i].op: self.cg.vertices[i]
                     for i in mis_indices(memb)}
        report = validate_mapping(self.sched, self.cgra, placement)
        if report.ok:
            self.accepted = (placement, report)
            return True
        return False


def exact_map_dfg(dfg: DFG, cgra: CGRAConfig,
                  options: "MapOptions | dict | None" = None, *,
                  cancel=None, tracer=None, **kwargs) -> MappingResult:
    """Prove the engine-optimal II (or certified infeasibility) for one
    DFG — see the module docstring for the exact claims.  Accepts the
    same `MapOptions` / dict / legacy-keyword forms as `map_dfg` so the
    race driver can hand both backends the same problem; the CSP node
    budget is ``certify.budget`` (the historical ``node_budget`` keyword
    is still accepted as an alias) and ``certify.hall`` gates the joint
    bus-demand bound (on by default — it only ever strengthens UNSAT
    proofs)."""
    if "node_budget" in kwargs:
        kwargs = dict(kwargs)
        kwargs["certify_budget"] = kwargs.pop("node_budget")
    opts = MapOptions.coerce(options, kwargs)
    mode, seed = opts.mode, opts.seed
    sch, ct = opts.schedule, opts.certify
    trc = live(tracer)
    t_start = _time.perf_counter()
    the_mii = mii(dfg, cgra)
    cache_limit = ROW_CACHE_LIMIT if opts.portfolio.row_cache_limit \
        is None else opts.portfolio.row_cache_limit
    certificates: list[IICertificate] = []
    proved_all = True      # every combination below the cursor decided
    attempts = 0
    last = (None, 0, (0, 0))
    cancelled = False
    for cur_ii in range(max(the_mii, sch.min_ii or 0), sch.max_ii + 1):
        for jitter in (0, 1, 2, 3):
            if cancel is not None and cancel.is_set():
                cancelled = True
                break
            try:
                sched = schedule_dfg(dfg, cgra, mode=mode, ii=cur_ii,
                                     max_ii=cur_ii, use_grf=sch.use_grf,
                                     jitter=jitter, seed=seed,
                                     max_bus_fanout=sch.max_bus_fanout)
            except RuntimeError:
                # The deterministic scheduler produces nothing at this
                # combination — there is no schedule to bind, so the
                # combination is decided (vacuously UNSAT within the
                # engine's family), not unknown.
                continue
            cg = build_conflict_graph(sched, cgra,
                                      bus_pressure=opts.bus_pressure,
                                      tracer=tracer)
            if ct.hall:
                hall_pressure_edges(cg.bits, cg.vertices,
                                    cg.op_vertices, sched, cgra)
            n_ops = len(sched.dfg.ops)
            # Memoized on the graph; hall edges are already folded in,
            # so the cache sees the strengthened adjacency.
            shared_u8 = cg.row_cache(cache_limit)
            sink = _ValidateSink(sched, cg, cgra)
            with trc.span("exact-csp", ii=cur_ii, jitter=jitter,
                          n_ops=n_ops) as xsp:
                cert, _ = certify_ii_infeasible(
                    cg, sched, cgra, jitter=jitter,
                    node_budget=ct.budget, row_cache=shared_u8,
                    row_cache_limit=cache_limit, on_solution=sink,
                    cancel=cancel, tracer=tracer)
                xsp.set(validations=sink.tried,
                        verdict="sat" if sink.accepted is not None
                        else "unsat" if cert is not None else "unknown")
                if cert is not None:
                    xsp.set(nodes=cert.nodes)
            trc.count("exact.validations", sink.tried)
            attempts += sink.tried
            last = (sched, n_ops, (cg.n, cg.n_edges))
            if sink.accepted is not None:
                placement, report = sink.accepted
                # The flag comes from the validator's report (the sink
                # keeps only accepted placements): the repo linter allows
                # a literal ``ok=True`` only under the reference's paths.
                return MappingResult(
                    ok=report.ok, mode=mode, ii=cur_ii, mii=the_mii,
                    n_routing_pes=sched.n_routing_ops,
                    ports_per_vio=dict(sched.ports_allocated),
                    placement=placement, sched=sched, report=report,
                    cg_size=(cg.n, cg.n_edges), mis_size=n_ops,
                    n_ops=n_ops, attempts=attempts,
                    wall_s=_time.perf_counter() - t_start,
                    certificates=certificates, optimal=proved_all,
                    backend="exact")
            if cert is not None:
                certificates.append(cert)
            else:
                # Budget out (or cancelled mid-search): this
                # combination is unknown, every claim past it degrades.
                proved_all = False
        if cancelled:
            break
    sched, n_ops, cg_size = last
    return MappingResult(
        ok=False, mode=mode, ii=sched.ii if sched else -1, mii=the_mii,
        n_routing_pes=sched.n_routing_ops if sched else 0,
        ports_per_vio=dict(sched.ports_allocated) if sched else {},
        placement={}, sched=sched, report=None, cg_size=cg_size,
        mis_size=0, n_ops=n_ops, attempts=attempts,
        wall_s=_time.perf_counter() - t_start,
        certificates=certificates,
        proved_infeasible=proved_all and not cancelled,
        backend="exact")
