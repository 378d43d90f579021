"""Post-MIS mapping validation (and the concrete bus/cycle assignment the
pairwise conflict graph intentionally leaves open — see conflict.py).

Checks, for a complete placement (one vertex per op):

1. every PE/port resource instance is used at most once per modulo slot
   (re-verification of the conflict graph's occupancy edges);
2. a concrete **bus assignment** exists: every PE→PE transfer gets a
   (bus, cycle) with ≤1 driver per bus instance, honouring the fixed drives
   (VIO delivery on IBUS_r at its slot, VOO export on OBUS_c at its slot);
3. LRF capacity: weight residency (one slot per MAC hosted by a PE) plus
   transient hold intervals (producer-hold, consumer-latch) fit `lrf` on
   every (PE, slot), counting modulo-wraparound multiplicity;
4. GRF capacity for GRF-parked data.
"""

from __future__ import annotations

import dataclasses

from .cgra import CGRAConfig
from .conflict import QUAD, TIN, TOUT, Vertex
from .dfg import OpKind
from .schedule import ScheduledDFG
from .tec import COL, ROW


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    violations: list[str]
    bus_assignment: dict  # (edge src,dst) -> (scope, idx, k, slot)
    lrf_peak: int
    grf_peak: int


def _assign_buses(transfers: list, fixed_used: set, ii: int,
                  n_buses: int = 2,
                  n_restarts: int = 6) -> tuple[dict, list[str]]:
    """Concrete (bus, cycle) allocation for PE->PE transfers.

    Transfers from one producer into one scope (row/column) are *broadcasts*:
    a single drive serves every listener whose [ready, use] window contains
    the drive cycle.  Per (producer, scope) group we compute a minimal stab
    set (classic interval stabbing), keep the per-stab slot flexibility, and
    then allocate bus instances most-constrained-first with randomized
    restarts."""
    import random

    # Group listeners by (producer, scope).
    groups: dict[tuple, list[tuple[int, list[int]]]] = {}
    for src, dst, scopes, window in transfers:
        groups.setdefault((src, scopes[0]), []).append((dst, window))

    best: tuple[dict, list[str]] | None = None
    for attempt in range(n_restarts):
        rng = random.Random(attempt * 7919 + 13)
        used = set(fixed_used)
        assignment: dict = {}
        viol: list[str] = []
        demands = []  # (scope, member_edges, candidate_slots)
        for (src, (scope, idx)), members in groups.items():
            ms = sorted(members, key=lambda x: x[1][-1])
            covered: set[int] = set()
            for dst, w in ms:
                if dst in covered:
                    continue
                t_stab = w[-1]
                grp = [(d, w2) for d, w2 in ms
                       if d not in covered and t_stab in w2]
                lo = max(w2[0] for _, w2 in grp)
                hi = min(w2[-1] for _, w2 in grp)
                slots = sorted({t % ii for t in range(lo, hi + 1)})
                demands.append(((scope, idx), [(src, d) for d, _ in grp],
                                slots))
                covered.update(d for d, _ in grp)
        rng.shuffle(demands)
        pending = list(demands)
        ok = True
        while pending:
            def opts(dm):
                (scope, idx), _, slots = dm
                return [(scope, idx, k, s)
                        for k in range(n_buses) for s in slots
                        if (scope, idx, k, s) not in used]
            pending.sort(key=lambda dm: len(opts(dm)))
            dm = pending.pop(0)
            o = opts(dm)
            if not o:
                viol.append(f"bus congestion: no (bus,cycle) for drives "
                            f"{dm[1]} scope={dm[0]} slots={dm[2]}")
                ok = False
                continue
            key = o[0] if attempt == 0 else rng.choice(o)
            used.add(key)
            for edge in dm[1]:
                assignment[edge] = key
        if ok:
            return assignment, []
        if best is None or len(viol) < len(best[1]):
            best = (assignment, viol)
    return best if best is not None else ({}, [])


def _interval_slots(a: int, b: int, ii: int) -> dict[int, int]:
    """Multiplicity per modulo slot of cycles a..b inclusive."""
    out: dict[int, int] = {}
    if b < a:
        return out
    length = b - a + 1
    base, rem = divmod(length, ii)
    for s in range(ii):
        out[s] = base
    for k in range(rem):
        out[(a + k) % ii] = out.get((a + k) % ii, 0) + 1
    return {s: c for s, c in out.items() if c}


def validate_mapping(sched: ScheduledDFG, cgra: CGRAConfig,
                     placement: dict[int, Vertex]) -> ValidationReport:
    dfg, ii = sched.dfg, sched.ii
    viol: list[str] = []

    # ---- 1. hard occupancy re-check -------------------------------------
    seen: dict[tuple, int] = {}
    for oid, v in placement.items():
        keys: list[tuple] = []
        if v.kind == TIN:
            keys.append(("iport", v.port, v.m))
        elif v.kind == TOUT:
            keys.append(("oport", v.port, v.m))
        else:
            keys.append(("pe", v.pe, v.m))
        for k in keys:
            if k in seen:
                viol.append(f"occupancy clash {k}: ops {seen[k]} vs {oid}")
            seen[k] = oid

    # ---- 2. bus assignment ----------------------------------------------
    fixed_used: set[tuple] = set()   # (scope, idx, k, slot)
    for oid, v in placement.items():
        if v.kind == TIN and v.mode == "bus":
            key = (ROW, v.port, 0, v.m)
            if key in fixed_used:
                viol.append(f"IBUS clash {key} (VIO {oid})")
            fixed_used.add(key)
        elif v.kind == TOUT:
            key = (COL, v.port, 0, v.m)
            if key in fixed_used:
                viol.append(f"OBUS clash {key} (VOO {oid})")
            fixed_used.add(key)

    # Flexible PE->PE transfers: group by (producer, scope) — one bus drive
    # is a broadcast serving every listener whose window contains it.
    # Adjacent PEs (|Δr|+|Δc| == 1) are wired by dedicated NSEW neighbour
    # links (Fig. 1): the consumer reads the producer's output register
    # directly, consuming no bus slot.
    transfers = []  # (src, dst, scopes, window_set)
    for e in dfg.edges:
        pv, cv = placement.get(e.src), placement.get(e.dst)
        if pv is None or cv is None or pv.kind != QUAD or cv.kind != QUAD:
            continue
        t_ready = sched.time[e.src] + dfg.ops[e.src].latency
        t_use = sched.time[e.dst] + e.distance * ii
        if t_use < t_ready:
            # Loop-carried recurrence violated: iteration i's consumer
            # would read before iteration i-distance's producer wrote.
            # Checked before the LRF / neighbour-link shortcuts — those
            # paths need the value ready too (distance-0 edges satisfy
            # this by scheduler construction; only distance > 0 edges,
            # whose source the list scheduler cannot see, can trip it).
            viol.append(f"recurrence violated on edge {e.src}->{e.dst}: "
                        f"use t={t_use} < ready t={t_ready}")
            continue
        if pv.pe == cv.pe:
            continue  # LRF path
        if (pv.drive is None and
                abs(pv.pe[0] - cv.pe[0]) + abs(pv.pe[1] - cv.pe[1]) == 1):
            continue  # neighbour link (no bus resource)
        scopes = []
        if pv.drive is not None:
            scopes.append(pv.drive)
        else:
            if pv.pe[0] == cv.pe[0]:
                scopes.append((ROW, pv.pe[0]))
            if pv.pe[1] == cv.pe[1]:
                scopes.append((COL, pv.pe[1]))
        if not scopes:
            viol.append(f"unroutable edge {e.src}->{e.dst}: "
                        f"{pv.pe} -> {cv.pe}")
            continue
        window = list(range(t_ready, min(t_use, t_ready + ii - 1) + 1))
        transfers.append((e.src, e.dst, scopes, window))

    assignment, bus_viol = _assign_buses(transfers, fixed_used, ii,
                                         n_buses=cgra.buses_per_scope)
    viol.extend(bus_viol)

    # ---- 3. LRF capacity --------------------------------------------------
    lrf: dict[tuple, dict[int, int]] = {}

    def add_interval(pe, a, b):
        slots = _interval_slots(a, b, ii)
        d = lrf.setdefault(pe, {})
        for s, c in slots.items():
            d[s] = d.get(s, 0) + c

    for oid, v in placement.items():
        if v.kind == QUAD and dfg.ops[oid].kind == OpKind.COMPUTE:
            # Weight residency: one permanent slot for the op's constant.
            d = lrf.setdefault(v.pe, {})
            for s in range(ii):
                d[s] = d.get(s, 0) + 1

    for e in dfg.edges:
        pv, cv = placement.get(e.src), placement.get(e.dst)
        if pv is None or cv is None:
            continue
        t_src, t_dst = sched.time[e.src], sched.time[e.dst] + e.distance * ii
        if pv.kind == TIN:
            if pv.mode == "bus" and cv.kind == QUAD:
                add_interval(cv.pe, t_src, t_dst)  # latch at delivery
        elif cv.kind == TOUT:
            add_interval(pv.pe, t_src + dfg.ops[e.src].latency, t_dst)
        elif pv.kind == QUAD and cv.kind == QUAD:
            t_ready = t_src + dfg.ops[e.src].latency
            if pv.pe == cv.pe:
                add_interval(pv.pe, t_ready, t_dst)
            else:
                key = assignment.get((e.src, e.dst))
                t_d = key[3] if key else t_ready % ii
                # producer holds until drive; consumer latches after.
                add_interval(pv.pe, t_ready, t_ready + ((t_d - t_ready) % ii))
                drive_abs = t_ready + ((t_d - t_ready) % ii)
                add_interval(cv.pe, drive_abs, t_dst)

    lrf_peak = 0
    for pe, d in lrf.items():
        peak = max(d.values(), default=0)
        lrf_peak = max(lrf_peak, peak)
        if peak > cgra.lrf:
            viol.append(f"LRF overflow on PE {pe}: {peak} > {cgra.lrf}")

    # ---- 4. GRF capacity --------------------------------------------------
    grf_peak = 0
    grf_slots: dict[int, int] = {}
    for oid, v in placement.items():
        if v.kind == TIN and v.mode == "grf":
            t0 = sched.time[oid]
            # Park until the last *use*, which for an inter-iteration
            # consumer is e.distance * ii cycles past its scheduled slot
            # (same per-edge accounting as the LRF path above).
            t1 = max((sched.time[e.dst] + e.distance * ii
                      for e in dfg.out_edges(oid)), default=t0)
            for s, c in _interval_slots(t0, t1, ii).items():
                grf_slots[s] = grf_slots.get(s, 0) + c
    if grf_slots:
        grf_peak = max(grf_slots.values())
        if grf_peak > max(cgra.grf, 0):
            viol.append(f"GRF overflow: {grf_peak} > {cgra.grf}")

    return ValidationReport(not viol, viol, assignment, lrf_peak, grf_peak)
