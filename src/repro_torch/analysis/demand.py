"""Implied-bandwidth-demand lower bounds over TIN/TOUT port tuples.

ROADMAP exact-engine rung (b): `exact.hall` only reasons about *forced
drive* routing pairs inside one (scope, slot) bus grid, so a DFG whose
bandwidth demand is carried entirely by dense VIO/VOO port tuples (no
routing ops at all) slips through — `hall_pressure_edges` returns 0 on
it.  This module closes that gap *before any schedule exists*, straight
from (DFG, CGRAConfig) structure.

The bound
---------
Call a VIO **eligible** when ``RD(v) <= m_eff`` where
``m_eff = pes_per_ibus`` capped by ``max_bus_fanout`` (byte-identical
to `schedule._Scheduler`'s budget).  For an eligible VIO the scheduler
*always* takes the single-port bus path, in both modes and regardless
of ``use_grf``:

- GRF parking requires ``rd > m_eff`` (`_schedule_vio`), so it never
  fires;
- bandmap allocates ``Q = min(ceil(rd/m_eff), free) = 1`` port, busmap
  always 1 — no clones;
- ``_route_pes_needed(rd, cgra, m_eff) == 0`` for ``rd <= m_eff`` — no
  routing ops are inserted.

Bus delivery makes every consumer's candidate satisfy
``cons.pe[0] == prod.port`` (`conflict._dep_ok`): all consumers sit on
the VIO's row.  Consumers shared between two eligible VIOs therefore
tie the two VIOs to the *same* row, and each bus VIO exclusively
occupies ``(IPORT_r, slot)`` (`conflict._occupancy`) — so ``k`` VIOs
transitively tied to one row need ``k`` distinct modulo slots:
**II >= k**.  The column side is dual and unconditional: a VOO's
producer must sit on the VOO's column (``prod.pe[1] == cons.port``),
VOOs occupy ``(OPORT_c, slot)`` exclusively, and producer→VOO edges are
never rewritten by the scheduler — ``k`` VOOs tied through shared
producers need **II >= k**.

Components are computed by union–find over the bipartite
(port-tuple op ↔ anchor op) incidence; the per-component floor is
decided by the same SDR (Hall) machinery the exact backend uses
(`exact.hall.sdr_exists` over the uniform slot family).

Soundness contract
------------------
Every bound is relative to the engine's deterministic schedule family
(every schedule `schedule_dfg` can emit for any (II, jitter, seed,
mode, use_grf) at the given ``max_bus_fanout``) — exactly the family
`exact.backend` quantifies over, which is why its UNSAT runs
differentially confirm these verdicts (tests/test_analysis_demand.py).
A bound never flags a combination any engine backend can map; it is a
*lower* bound, free to be loose (the engine may fail even above it).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.dfg import DFG, OpKind
from repro_torch.core.schedule import mii
from repro_torch.exact.hall import sdr_exists


def effective_fanout(cgra: CGRAConfig,
                     max_bus_fanout: int | None = None) -> int:
    """The per-port delivery budget ``m_eff``, byte-identical to
    `schedule._Scheduler`'s computation."""
    return cgra.pes_per_ibus if max_bus_fanout is None \
        else max(1, min(cgra.pes_per_ibus, max_bus_fanout))


@dataclasses.dataclass(frozen=True)
class DemandBound:
    """One co-location component and the II floor it implies."""
    scope: str                    # 'row' (VIO tuples) | 'col' (VOO tuples)
    tuple_ops: tuple[int, ...]    # the port-tuple ops pinned together
    anchor_ops: tuple[int, ...]   # computes/routes forcing co-location
    min_ii: int                   # == SDR floor of the slot family

    def summary(self) -> str:
        kind = "VIOs" if self.scope == "row" else "VOOs"
        return (f"{len(self.tuple_ops)} {kind} {list(self.tuple_ops)} "
                f"tied to one {self.scope} via ops "
                f"{list(self.anchor_ops)} need II >= {self.min_ii}")


class _UnionFind:
    def __init__(self) -> None:
        self._parent: dict = {}

    def find(self, x):
        p = self._parent.setdefault(x, x)
        while p != self._parent[p]:
            self._parent[p] = self._parent[self._parent[p]]
            p = self._parent[p]
        self._parent[x] = p
        return p

    def union(self, a, b) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self._parent[rb] = ra


def _component_floor(k: int) -> int:
    """Smallest II whose slot family {0..II-1} (one set per co-located
    tuple) admits a system of distinct representatives — the same Hall
    decision `exact.hall` applies to bus-cell grids."""
    for ii in range(1, k + 1):
        if sdr_exists([range(ii)] * k):
            return ii
    return k


def _side_bounds(pairs: list[tuple[int, int]],
                 scope: str) -> list[DemandBound]:
    """Union-find over (tuple op, anchor op) incidence ``pairs``."""
    uf = _UnionFind()
    for t, a in pairs:
        uf.union(("t", t), ("a", a))
    comps: dict = {}
    for t, a in pairs:
        root = uf.find(("t", t))
        tups, anchors = comps.setdefault(root, (set(), set()))
        tups.add(t)
        anchors.add(a)
    out = []
    for tups, anchors in comps.values():
        out.append(DemandBound(
            scope=scope, tuple_ops=tuple(sorted(tups)),
            anchor_ops=tuple(sorted(anchors)),
            min_ii=_component_floor(len(tups))))
    out.sort(key=lambda b: (-b.min_ii, b.tuple_ops))
    return out


def implied_demand_bounds(dfg: DFG, cgra: CGRAConfig, *,
                          max_bus_fanout: int | None = None
                          ) -> list[DemandBound]:
    """All component demand bounds (module docstring), strongest first.

    Only components with ``min_ii > 1`` are reported — singleton
    components bound nothing beyond MII (which is why the pre-pass is a
    provable no-op on every shipped kernel family)."""
    m_eff = effective_fanout(cgra, max_bus_fanout)
    anchor_kinds = (OpKind.COMPUTE, OpKind.ROUTE)

    row_pairs: list[tuple[int, int]] = []
    for v in dfg.v_i:
        # Eligibility must mirror the scheduler's rd (successor *list*
        # length, parallel edges included) or the no-clone guarantee
        # breaks.
        if len(dfg.successors(v)) > m_eff:
            continue
        for c in set(dfg.successors(v)):
            if dfg.ops[c].kind in anchor_kinds:
                row_pairs.append((v, c))

    col_pairs: list[tuple[int, int]] = []
    for v in dfg.v_o:
        for p in set(dfg.predecessors(v)):
            if dfg.ops[p].kind in anchor_kinds:
                col_pairs.append((v, p))

    bounds = _side_bounds(row_pairs, "row") + \
        _side_bounds(col_pairs, "col")
    return [b for b in bounds if b.min_ii > 1]


def demand_mii(dfg: DFG, cgra: CGRAConfig, *,
               max_bus_fanout: int | None = None) -> int:
    """Static II floor: classic MII joined with the component demand
    bounds.  Every (II, jitter) combination below it is unbindable
    within the engine's schedule family."""
    floor = mii(dfg, cgra)
    for b in implied_demand_bounds(dfg, cgra,
                                   max_bus_fanout=max_bus_fanout):
        floor = max(floor, b.min_ii)
    return floor
