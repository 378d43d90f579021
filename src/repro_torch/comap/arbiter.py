"""Shared-scope arbitration and merged-binding replay for co-mapping.

Regions own their PEs exclusively, but the row/column infrastructure is
shared: two regions spanning the same global row contend for that row's
IPORT and its IBUS cells, regions sharing a column contend for the
OPORT/OBUS — and the PE-driven routing buses of every shared scope are a
common pool.  Per-region mappings are validated *locally* under the
assumption that their region owns its scopes outright, so the co-mapper
must re-establish soundness globally.  Two mechanisms:

- :func:`arbitrate` — cheap structural check over the regions' **fixed**
  claims (port instances and hardwired bus-0 drive cells, which no
  global reassignment can move), plus the pooled GRF budget.  A clash
  here dooms every global binding that keeps the per-region placements,
  so the implicated regions are re-mapped with fresh seeds before any
  merge is attempted.  Cross-region collisions between *flexible*
  (bus, cycle) assignments are collected as advisory conflicts only:
  the merged validator re-solves the global bus packing from scratch
  and may legally move them.
- :func:`merge_mappings` — disjoint-union of the per-region scheduled
  DFGs (ops renumbered, coordinates translated to global) into one
  ``ScheduledDFG`` + placement that `core.validate.validate_mapping`
  replays against the full-array config.  The existing validator is the
  single soundness authority: occupancy, global bus assignment, LRF and
  GRF capacity are all re-checked on the merged binding.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.bandmap import MappingResult
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.conflict import TIN, TOUT, Vertex
from repro_torch.core.dfg import DFG
from repro_torch.core.schedule import ScheduledDFG
from repro_torch.core.tec import COL, ROW

from .regions import Region


@dataclasses.dataclass
class ArbiterReport:
    ok: bool
    conflicts: list[str]            # hard: doom every merged binding
    advisory: list[str]             # flexible-cell overlaps (re-solvable)
    implicated: set[int]            # region indices to re-map (hard)
    advisory_implicated: set[int]   # fallback retry set after a merged
    #                                 validation failure

    def summary(self) -> str:
        return (f"arbiter: ok={self.ok}, {len(self.conflicts)} hard / "
                f"{len(self.advisory)} advisory conflicts")


def fixed_claims(region: Region, result: MappingResult,
                 ) -> dict[tuple, str]:
    """Global fixed resource cells a region's mapping occupies.

    Port instances and the hardwired bus-0 drives of VIO delivery / VOO
    export are pinned by the placement itself — they are the claims no
    global bus re-assignment can relocate."""
    claims: dict[tuple, str] = {}
    for oid, v in result.placement.items():
        if v.kind == TIN:
            row = v.port + region.r0
            claims[("iport", row, v.m)] = f"VIO {oid} on IPORT_{row}"
            if v.mode == "bus":
                claims[("bus", ROW, row, 0, v.m)] = \
                    f"VIO {oid} delivery on IBUS_{row}"
        elif v.kind == TOUT:
            col = v.port + region.c0
            claims[("oport", col, v.m)] = f"VOO {oid} on OPORT_{col}"
            claims[("bus", COL, col, 0, v.m)] = \
                f"VOO {oid} export on OBUS_{col}"
    return claims


def flexible_cells(region: Region, result: MappingResult,
                   ) -> dict[tuple, str]:
    """Global (scope, idx, bus, slot) cells of the region's *local* bus
    assignment for PE->PE transfers.  Advisory only — the merged replay
    re-solves these globally."""
    cells: dict[tuple, str] = {}
    if result.report is None:
        return cells
    for edge, (scope, idx, k, slot) in result.report.bus_assignment.items():
        g_idx = idx + (region.r0 if scope == ROW else region.c0)
        cells[(scope, g_idx, k, slot)] = f"transfer {edge}"
    return cells


def arbitrate(regions: list[Region], results: list[MappingResult],
              cgra: CGRAConfig) -> ArbiterReport:
    """Check the co-resident mappings' shared-scope claims.

    All results must be at one common II (the co-mapper's invariant —
    modulo slots of different IIs would not even be comparable)."""
    iis = {r.ii for r in results}
    assert len(iis) == 1, f"co-mapped kernels disagree on II: {iis}"
    conflicts: list[str] = []
    advisory: list[str] = []
    implicated: set[int] = set()
    advisory_implicated: set[int] = set()

    hard_owner: dict[tuple, tuple[int, str]] = {}
    for ri, (region, res) in enumerate(zip(regions, results)):
        for cell, what in fixed_claims(region, res).items():
            if cell in hard_owner:
                oi, owhat = hard_owner[cell]
                conflicts.append(
                    f"fixed claim clash on {cell}: region {oi} ({owhat}) "
                    f"vs region {ri} ({what})")
                implicated.update((oi, ri))
            else:
                hard_owner[cell] = (ri, what)

    flex_owner: dict[tuple, tuple[int, str]] = {}
    for ri, (region, res) in enumerate(zip(regions, results)):
        for cell, what in flexible_cells(region, res).items():
            hit = hard_owner.get(cell) or flex_owner.get(cell)
            if hit is not None and hit[0] != ri:
                advisory.append(
                    f"flexible cell overlap on {cell}: region {hit[0]} "
                    f"({hit[1]}) vs region {ri} ({what})")
                advisory_implicated.update((hit[0], ri))
            flex_owner.setdefault(cell, (ri, what))

    grf_total = sum(res.report.grf_peak for res in results
                    if res.report is not None)
    if grf_total > max(cgra.grf, 0):
        conflicts.append(f"pooled GRF overflow: {grf_total} > {cgra.grf}")
        implicated.update(ri for ri, res in enumerate(results)
                          if res.report is not None
                          and res.report.grf_peak > 0)

    return ArbiterReport(not conflicts, conflicts, advisory,
                         implicated, advisory_implicated)


def merge_mappings(regions: list[Region], results: list[MappingResult],
                   ) -> tuple[ScheduledDFG, dict[int, Vertex]]:
    """Disjoint-union the per-region scheduled DFGs and placements into
    one global binding (ops renumbered, coordinates translated).

    The returned pair is exactly what ``validate_mapping`` consumes, so
    the existing validator replays the merged binding unchanged."""
    iis = {r.ii for r in results}
    assert len(iis) == 1
    ii = iis.pop()
    merged = DFG()
    time: dict[int, int] = {}
    delivery: dict[int, str] = {}
    ports: dict[int, int] = {}
    placement: dict[int, Vertex] = {}
    for region, res in zip(regions, results):
        sched = res.sched
        assert sched is not None
        idmap: dict[int, int] = {}
        for oid in sorted(sched.dfg.ops):
            op = sched.dfg.ops[oid]
            idmap[oid] = merged.add_op(op.kind, name=op.name,
                                       latency=op.latency)
        # Clone groups renumber in a second pass: a group's anchor VIO
        # references itself, so its id may not precede it in the map.
        for oid, op in sched.dfg.ops.items():
            if op.clone_of >= 0:
                merged.ops[idmap[oid]].clone_of = idmap[op.clone_of]
        for e in sched.dfg.edges:
            merged.add_edge(idmap[e.src], idmap[e.dst], distance=e.distance)
        for oid, t in sched.time.items():
            time[idmap[oid]] = t
        for oid, d in sched.delivery.items():
            delivery[idmap[oid]] = d
        for oid, q in sched.ports_allocated.items():
            ports[idmap[oid]] = q
        for oid, v in res.placement.items():
            placement[idmap[oid]] = region.translate_vertex(
                v, op=idmap[oid])
    merged_sched = ScheduledDFG(
        merged, ii, max((r.mii for r in results), default=1),
        time, delivery, ports)
    return merged_sched, placement
