"""Hall-style set bound over (scope, slot) bus-demand grids.

`conflict.bus_pressure_edges` folds two pairwise-decidable shapes of
bus scarcity into the conflict graph: a forced drive with *no* feasible
(bus, cycle) cell, and two forced drives pinned to the *same single*
cell.  What it cannot see is the joint below-capacity case the ROADMAP
names: three forced demands over two surviving cells is unsatisfiable
even though every pair of them still fits — until now that shape was
caught only post-hoc by `validate._assign_buses`.

`hall_pressure_edges` closes it with Hall's theorem.  For a candidate
pair (u, v) of forced-drive vertices in one (scope, idx) grid, the
demand family a complete placement containing both must satisfy is:

- u's and v's own forced drives — each needs one cell from its
  feasible set (``buses_per_scope × forced window``, minus the
  schedule-saturated bus-0 cells, exactly as in `bus_pressure_edges`);
- one drive per *implied* third party: any other op whose candidates
  compatible with {u, v} (non-adjacent in the graph built so far) all
  demand a cell in the same grid — forced routing ops pinned to this
  scope, and bus-VIO / VOO port tuples hard-wired to their bus-0 cell.
  The third party's demand set is the union over its surviving
  candidates (a superset of the chosen candidate's set, so using it is
  conservative); an op with *no* surviving candidate makes the pair
  unconditionally un-completable, which is the degenerate Hall
  violation (empty demand set).

Drives of distinct producers never share a (bus, cycle) — one driver
per bus instance per cycle is the validator's replay rule — so the
family is satisfiable iff it has a system of distinct representatives.
`sdr_exists` decides that by augmenting-path bipartite matching; no SDR
⇒ the edge (u, v) is added.

Soundness contract (the same no-false-conflict contract
`bus_pressure_edges` carries, property-tested in
`tests/test_exact_hall.py`): every added edge endpoints-pair is one
`validate_mapping` rejects in any complete placement — Hall violations
only shrink under taking subsets/chosen candidates, so a conservative
union can never manufacture a false conflict.  The bound is used by
the exact backend (`repro.exact.backend`), where stronger pruning
means smaller UNSAT exhaustions; the portfolio path keeps its
byte-pinned `bus_pressure_edges`-only graph.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.conflict import TIN, TOUT, _forced_drive_slots
from repro_torch.core.dfg import OpKind
from repro_torch.core.tec import COL, ROW


def sdr_exists(cell_sets) -> bool:
    """Hall's theorem, constructively: True iff the demand family
    ``cell_sets`` (iterables of hashable cells) admits a system of
    distinct representatives.  Plain augmenting-path bipartite matching
    — families here are a handful of sets over a few cells."""
    match: dict = {}
    sets = [list(s) for s in cell_sets]

    def aug(i: int, seen: set) -> bool:
        for c in sets[i]:
            if c in seen:
                continue
            seen.add(c)
            j = match.get(c)
            if j is None or aug(j, seen):
                match[c] = i
                return True
        return False

    return all(aug(i, set()) for i in range(len(sets)))


def hall_pressure_edges(bits, vertices, op_vertices, sched, cgra) -> int:
    """Add the Hall-bound edges (module docstring) to ``bits`` in
    place; returns the number of vertex pairs added."""
    dfg, ii = sched.dfg, sched.ii
    n_buses = cgra.buses_per_scope

    # Schedule-level saturation of the hardwired bus-0 cells (stage 1
    # of `bus_pressure_edges`, recomputed — it is a few lines over the
    # op list).
    vin_bus = [0] * ii
    vout = [0] * ii
    for oid, op in dfg.ops.items():
        m = sched.time[oid] % ii
        if op.kind == OpKind.VIN and \
                sched.delivery.get(oid, "bus") == "bus":
            vin_bus[m] += 1
        elif op.kind == OpKind.VOUT:
            vout[m] += 1
    sat = {ROW: [vin_bus[m] >= cgra.rows for m in range(ii)],
           COL: [vout[m] >= cgra.cols for m in range(ii)]}

    forced: dict[int, list[int]] = {}
    for oid, op in dfg.ops.items():
        if op.kind != OpKind.ROUTE:
            continue
        slots = _forced_drive_slots(sched, oid, sched.time[oid] % ii)
        if slots is not None:
            forced[oid] = slots
    if not forced:
        return 0

    def route_cells(oid: int, scope) -> frozenset:
        return frozenset((k, s) for k in range(n_buses)
                         for s in forced[oid]
                         if not (k == 0 and sat[scope][s]))

    # Pair endpoints: forced-drive route vertices, grouped per grid.
    grid_verts: dict[tuple, list[int]] = {}
    for oid in forced:
        for vi in op_vertices[oid]:
            v = vertices[vi]
            if v.drive is not None:
                grid_verts.setdefault(v.drive, []).append(vi)

    # Per-vertex demand (grid, cells) for third-party evaluation: route
    # candidates demand their drive grid, bus-VIO / VOO port tuples
    # their hard-wired bus-0 cell.
    demand_of: dict[int, tuple[tuple, frozenset]] = {}
    for v in vertices:
        if v.kind == TIN and v.mode == "bus":
            demand_of[v.idx] = ((ROW, v.port), frozenset({(0, v.m)}))
        elif v.kind == TOUT:
            demand_of[v.idx] = ((COL, v.port), frozenset({(0, v.m)}))
        elif v.op in forced and v.drive is not None:
            demand_of[v.idx] = (v.drive, route_cells(v.op, v.drive[0]))

    # Ops a pair must leave placeable: every op with at least one
    # demand-carrying candidate (only those can become grid-implied).
    party_ops = sorted({vertices[vi].op for vi in demand_of})
    party_doms = {o: np.asarray(op_vertices[o], dtype=np.int64)
                  for o in party_ops}

    n_pairs = 0
    src_acc: list[int] = []
    dst_acc: list[int] = []
    for grid, vis in grid_verts.items():
        scope, _ = grid
        cells_by_op = {}
        for vi in vis:
            o = vertices[vi].op
            if o not in cells_by_op:
                cells_by_op[o] = route_cells(o, scope)
        for a in range(len(vis)):
            u = vis[a]
            row_u = bits.row_u8(u)
            for b in range(a + 1, len(vis)):
                v = vis[b]
                ou, ov = vertices[u].op, vertices[v].op
                if ou == ov or bits.has_edge(u, v):
                    continue
                blocked = (row_u | bits.row_u8(v)) != 0
                demands = [cells_by_op[ou], cells_by_op[ov]]
                doomed = False
                for o in party_ops:
                    if o == ou or o == ov:
                        continue
                    comp = party_doms[o][~blocked[party_doms[o]]]
                    if comp.size == 0:
                        # No surviving candidate at all: the pair can
                        # never extend to a complete placement.
                        doomed = True
                        break
                    dsets = [demand_of.get(int(x)) for x in comp]
                    if all(d is not None and d[0] == grid
                           for d in dsets):
                        demands.append(
                            frozenset().union(*(d[1] for d in dsets)))
                if doomed or not sdr_exists(demands):
                    src_acc.append(u)
                    dst_acc.append(v)
                    n_pairs += 1
    if src_acc:
        bits.add_edges(np.asarray(src_acc), np.asarray(dst_acc))
    return n_pairs
