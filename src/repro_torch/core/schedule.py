"""Phase 1: modulo scheduling with quantitative bandwidth allocation, and the
phase-2 routing-resource pre-allocation that the scheduler triggers when the
allocation policy falls short (paper §III-A, Fig. 4).

Policy (verbatim from the paper): at current modulo time m, if RD(VIO) > M,
allocate the VIO Q = min(ceil(RD/M), #available input ports) ports.  If
Q < ceil(RD/M), or the number of available PEs is smaller than RD, routing
PEs are adopted.  Multi-port binding is modelled by cloning the VIO into Q
copies of the same datum, each occupying one port (Fig. 2(c)(e)).

BusMap mode forces Q = 1 (one port per datum) and always covers the surplus
with routing PEs — this is the baseline the paper compares against.

Coverage model (see DESIGN.md §3): a port delivers to the M PEs of its row;
a routing PE occupies one delivery slot, caches the datum, and re-drives a
bus the next cycle, reaching (rows - 1) additional PEs in its column.  With
a GRF, a datum parked in the GRF is readable by all PEs (capacity-limited),
so GRF delivery removes the coverage constraint entirely.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

from .cgra import CGRAConfig
from .dfg import DFG, OpKind


@dataclasses.dataclass
class ScheduledDFG:
    dfg: DFG                        # includes VIO clones + routing ops
    ii: int
    mii: int
    time: dict[int, int]            # op_id -> scheduled time t
    delivery: dict[int, str]        # VIO op_id -> 'bus' | 'grf'
    ports_allocated: dict[int, int] # original VIO id -> Q

    def mslot(self, oid: int) -> int:
        return self.time[oid] % self.ii

    @property
    def n_routing_ops(self) -> int:
        return sum(1 for o in self.dfg.ops.values() if o.kind == OpKind.ROUTE)


def res_mii(dfg: DFG, cgra: CGRAConfig) -> int:
    """Resource-constrained MII."""
    return max(
        math.ceil(len(dfg.v_r) / cgra.n_pes),
        math.ceil(len(dfg.v_i) / cgra.n_iports),
        math.ceil(len(dfg.v_o) / cgra.n_oports),
        1,
    )


def mii(dfg: DFG, cgra: CGRAConfig) -> int:
    return max(res_mii(dfg, cgra), dfg.rec_mii())


def _route_pes_needed(n_consumers: int, cgra: CGRAConfig,
                      m_eff: int | None = None) -> int:
    """Routing PEs so one port + k routing PEs cover ``n_consumers``.

    coverage(k) = M - k + k*(rows-1): each routing PE takes one direct
    delivery slot in the port's row and adds rows-1 column-bus listeners.
    ``m_eff`` caps the direct per-port budget below the physical M (see
    the ``max_bus_fanout`` scheduling knob).
    """
    m, rows = cgra.pes_per_ibus, cgra.rows
    if m_eff is not None:
        m = min(m, m_eff)
    if n_consumers <= m:
        return 0
    gain = rows - 2  # net coverage gain per routing PE
    if gain <= 0:    # degenerate 1-/2-row arrays
        return n_consumers - m
    return math.ceil((n_consumers - m) / gain)


class _Scheduler:
    def __init__(self, dfg: DFG, cgra: CGRAConfig, mode: str, ii: int,
                 use_grf: bool, jitter: int = 0, seed: int = 0,
                 max_bus_fanout: int | None = None):
        self.dfg = dfg
        self.cgra = cgra
        self.mode = mode
        self.ii = ii
        self.use_grf = use_grf
        # Effective per-port delivery budget.  The paper's policy serves
        # up to M = pes_per_ibus consumers from one port; on wide arrays
        # (M = 16) that pins a whole fan-out to a single row, which
        # couples placement so hard that structurally mappable kernels
        # stop binding.  ``max_bus_fanout`` caps the budget: RD beyond
        # it allocates extra ports (bandmap: Q = ceil(RD/m_eff) clones,
        # the same split a 4x4 array would have produced) or routing
        # PEs (busmap), restoring placement freedom.  None = physical M
        # (exact paper behaviour).
        self.m_eff = cgra.pes_per_ibus if max_bus_fanout is None \
            else max(1, min(cgra.pes_per_ibus, max_bus_fanout))
        # Phase-4 diversity: jitter > 0 delays ops by a random 0..jitter
        # slots past ASAP, producing distinct schedules on retry (ASAP alone
        # is II-invariant, so plain II escalation adds no slack).
        self.jitter = jitter
        import numpy as _np
        self.rng = _np.random.default_rng(seed * 7919 + jitter * 131 + 7)
        self.pe = [0] * ii
        self.iport = [0] * ii
        self.oport = [0] * ii
        self.grf_live = 0
        self.time: dict[int, int] = {}
        self.delivery: dict[int, str] = {}
        self.ports_alloc: dict[int, int] = {}
        self.heights = dfg.heights()
        self.n_preds = {i: sum(1 for e in dfg.in_edges(i) if e.distance == 0)
                        for i in dfg.ops}
        self.ready: list[tuple[int, int]] = []
        for i, c in self.n_preds.items():
            if c == 0:
                heapq.heappush(self.ready, (-self.heights[i], i))
    # ------------------------------------------------------------- helpers
    def _pick(self, n: int) -> int:
        if self.jitter <= 0 or n <= 1:
            return 0
        return int(self.rng.integers(0, min(n, self.jitter + 1)))

    def est(self, oid: int) -> int:
        t = 0
        for e in self.dfg.in_edges(oid):
            if e.src in self.time:
                lag = self.time[e.src] + self.dfg.ops[e.src].latency
                t = max(t, lag - e.distance * self.ii)
        return max(t, 0)

    def _commit(self, oid: int, t: int) -> None:
        """Record time and release successors whose preds are all scheduled."""
        self.time[oid] = t
        for e in self.dfg.out_edges(oid):
            if e.distance == 0 and e.dst not in self.time:
                self.n_preds[e.dst] -= 1
                if self.n_preds[e.dst] == 0:
                    heapq.heappush(self.ready,
                                   (-self.heights[e.dst], e.dst))

    # --------------------------------------------------------------- VIO
    def _schedule_vio(self, oid: int, t: int) -> None:
        dfg, cgra, m = self.dfg, self.cgra, t % self.ii
        rd = dfg.rd(oid)
        m_bus = self.m_eff
        q_need = math.ceil(rd / m_bus)

        if self.use_grf and rd > m_bus and self.grf_live < cgra.grf:
            # Park the datum in the GRF: one port, coverage-unconstrained.
            self.iport[m] += 1
            self.grf_live += 1
            self.delivery[oid] = "grf"
            self.ports_alloc[oid] = 1
            self._commit(oid, t)
            return

        q = 1 if self.mode == "busmap" else min(q_need,
                                                cgra.n_iports - self.iport[m])
        q = max(q, 1)
        self.iport[m] += q
        self.delivery[oid] = "bus"
        self.ports_alloc[oid] = q

        # Split consumers among the Q port clones (Fig. 2(c)(e)).  Rewiring
        # happens BEFORE any successor bookkeeping so ready-counts stay exact.
        consumers = dfg.successors(oid)
        groups = [consumers]
        if q > 1:
            chunk = math.ceil(len(consumers) / q)
            groups = [consumers[k * chunk:(k + 1) * chunk] for k in range(q)]
            groups = [g for g in groups if g]
        clone_ids = [oid]
        for g in groups[1:]:
            cid = dfg.clone_vio(oid, g)
            clone_ids.append(cid)
            self.delivery[cid] = "bus"
            self.n_preds[cid] = 0
            self.heights[cid] = self.heights[oid]

        # Phase 2: per-clone routing pre-allocation for residual coverage.
        for cid, g in zip(clone_ids, groups):
            n_route = _route_pes_needed(len(g), cgra, self.m_eff)
            if n_route > 0:
                self._insert_routes(cid, n_route)

        for cid in clone_ids:
            self._commit(cid, t)

    def _insert_routes(self, host: int, n_route: int) -> None:
        """Move overflow consumers of ``host`` onto fresh routing ops (each
        re-broadcasts on its column bus, reaching rows-1 PEs)."""
        dfg, cgra = self.dfg, self.cgra
        consumers = dfg.successors(host)
        capacity = max(cgra.rows - 1, 1)
        direct = max(0, self.m_eff - n_route)
        overflow = consumers[direct:]
        for k in range(n_route):
            part = overflow[k * capacity:(k + 1) * capacity]
            if not part:
                break
            rid = dfg.add_op(OpKind.ROUTE, f"rt{host}_{k}")
            dfg.add_edge(host, rid)
            for c in part:
                # Carry the iteration distance onto the re-broadcast leg
                # so inter-iteration consumers keep their semantics.
                dists = [e.distance for e in dfg.edges
                         if e.src == host and e.dst == c]
                dfg.remove_edge(host, c)
                dfg.add_edge(rid, c, distance=max(dists, default=0))
            # Bookkeeping for the new op: its only pred is `host` (not yet
            # committed), so it becomes ready when host commits.  Consumers'
            # pred-counts are unchanged (vio edge swapped for route edge).
            self.n_preds[rid] = 1
            self.heights[rid] = 1 + max(
                (self.heights[c] for c in part if c in self.heights),
                default=0)

    # --------------------------------------------------------------- main
    def run(self) -> ScheduledDFG | None:
        cgra, ii = self.cgra, self.ii
        while self.ready:
            _, oid = heapq.heappop(self.ready)
            if oid in self.time:
                continue
            op = self.dfg.ops[oid]
            t0 = self.est(oid)
            placed = False
            if op.kind in (OpKind.COMPUTE, OpKind.ROUTE):
                # ASAP: aligned chains concentrate each VIO's consumers at
                # few modulo slots, which keeps the port allocation at the
                # paper's quantitative minimum Q = ceil(RD/M).
                cands = sorted(t for t in range(t0, t0 + ii)
                               if self.pe[t % ii] < cgra.n_pes)
                if cands:
                    t = cands[self._pick(len(cands))]
                    self.pe[t % ii] += 1
                    self._commit(oid, t)
                    placed = True
            elif op.kind == OpKind.VOUT:
                cands = sorted(t for t in range(t0, t0 + ii)
                               if self.oport[t % ii] < cgra.n_oports)
                if cands:
                    t = cands[self._pick(len(cands))]
                    self.oport[t % ii] += 1
                    self._commit(oid, t)
                    placed = True
            else:  # VIN: earliest slot with the full port allocation free,
                # falling back to the slot offering the most ports.
                rd = self.dfg.rd(oid)
                q_need = (1 if self.mode == "busmap"
                          else math.ceil(rd / self.m_eff))
                cands = [t for t in range(t0, t0 + ii)
                         if self.iport[t % ii] < cgra.n_iports]
                if cands:
                    full = [t for t in cands
                            if cgra.n_iports - self.iport[t % ii] >= q_need]
                    t = min(full) if full else min(
                        cands, key=lambda t: (self.iport[t % ii], t))
                    self._schedule_vio(oid, t)
                    placed = True
            if not placed:
                return None
        if len(self.time) != len(self.dfg.ops):
            return None
        # Loop-carried sanity: a back edge's source is unscheduled when
        # the list scheduler places its destination (est() skips it), so
        # the recurrence bound time[dst] + d*II >= time[src] + latency
        # must be re-checked once all ops have times.  A violation means
        # this II leaves too little slack for the cycle's latency —
        # reject and let II escalation (schedule_dfg / map_dfg) retry.
        for e in self.dfg.edges:
            if e.distance > 0 and (
                    self.time[e.dst] + e.distance * self.ii
                    < self.time[e.src] + self.dfg.ops[e.src].latency):
                return None
        self._retime_vios()
        return ScheduledDFG(self.dfg, ii, 0, self.time, self.delivery,
                            self.ports_alloc)

    def _retime_vios(self) -> None:
        """As-late-as-possible VIO retiming: deliver each datum just before
        its earliest consumer.  ASAP delivery parks data for the whole chain
        length, which overflows the GRF (and inflates LRF latch holds) for
        deep chains; just-in-time delivery keeps residency ~1 slot/datum —
        this is what lets GRF runs reach MII (paper §IV-B)."""
        ii = self.ii
        for oid in self.dfg.v_i:
            cons = [self.time[c] for c in self.dfg.successors(oid)
                    if c in self.time]
            if not cons:
                continue
            t_new = max(min(cons) - self.dfg.ops[oid].latency, 0)
            t_old = self.time[oid]
            if t_new <= t_old:
                continue
            m_old, m_new = t_old % ii, t_new % ii
            if m_old == m_new:
                self.time[oid] = t_new
                continue
            if self.iport[m_new] < self.cgra.n_iports:
                self.iport[m_old] -= 1
                self.iport[m_new] += 1
                self.time[oid] = t_new


def schedule_dfg(dfg: DFG, cgra: CGRAConfig, *, mode: str = "bandmap",
                 ii: int | None = None, max_ii: int = 64,
                 use_grf: bool | None = None, jitter: int = 0,
                 seed: int = 0,
                 max_bus_fanout: int | None = None) -> ScheduledDFG:
    """Iterative modulo scheduling.  Tries II = MII, MII+1, ... ≤ max_ii."""
    assert mode in ("bandmap", "busmap")
    if use_grf is None:
        use_grf = cgra.grf > 0
    the_mii = mii(dfg, cgra)
    start = ii if ii is not None else the_mii
    for cur_ii in range(start, max_ii + 1):
        out = _Scheduler(dfg.copy(), cgra, mode, cur_ii, use_grf,
                         jitter=jitter, seed=seed,
                         max_bus_fanout=max_bus_fanout).run()
        if out is not None:
            out.mii = the_mii
            return out
    raise RuntimeError(f"no schedule found for II <= {max_ii}")
