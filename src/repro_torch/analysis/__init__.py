"""Static pre-mapping analysis: sound verdicts before any search runs.

The port's copy of `repro.analysis`: the domain pass (`dfglint` +
`demand`, the schedule-free II floor behind ``map_dfg``'s static
pre-pass) and its two wrappers, `analyze` and `static_infeasibility`
(the serve tier's admission check); and the repo pass, `astlint`, the
linter of the port's written-down invariants over ``src/repro_torch``
(a standalone module, ``python -m repro_torch.analysis.astlint``, not
imported here).

Soundness contract
------------------
Every verdict this package emits is a **sound negative**: "no engine
backend maps this (DFG, config) at II < k" (`demand.demand_mii`) or
"... at any II" (`static_infeasibility`).  The analyzer never emits
"feasible": absence of findings promises nothing.  Consumers:

- `bandmap.map_dfg(static_prepass=True)` skips II values below the
  static floor, recording one `IICertificate` per skipped II with
  ``stage='static-demand'`` and ``jitter=-1``.
- `serve.scheduler` rejects statically-infeasible requests on the
  calling thread (``source="static_reject"``) with a certificate-backed
  negative `MappingResult` that `serve.cache.store` admits.
"""

from __future__ import annotations

import time as _time

from repro_torch.core.bandmap import MappingResult
from repro_torch.core.certify import IICertificate
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.dfg import DFG
from repro_torch.core.schedule import mii

from .demand import (DemandBound, demand_mii, effective_fanout,
                     implied_demand_bounds)
from .dfglint import (LintFinding, fatal_findings,
                      generator_invariant_findings, lint_dfg)

__all__ = [
    "DemandBound", "LintFinding", "analyze", "demand_mii",
    "effective_fanout", "fatal_findings",
    "generator_invariant_findings", "implied_demand_bounds",
    "lint_dfg", "static_infeasibility",
]


def analyze(dfg: DFG, cgra: CGRAConfig, *,
            max_bus_fanout: int | None = None
            ) -> tuple[list, list]:
    """Convenience: (lint findings, demand bounds) for one pair."""
    findings = lint_dfg(dfg, cgra, max_bus_fanout=max_bus_fanout)
    if fatal_findings(findings):
        return findings, []
    return findings, implied_demand_bounds(
        dfg, cgra, max_bus_fanout=max_bus_fanout)


def static_infeasibility(dfg: DFG, cgra: CGRAConfig, *,
                         mode: str = "bandmap", max_ii: int = 32,
                         min_ii: int | None = None,
                         max_bus_fanout: int | None = None
                         ) -> MappingResult | None:
    """Full-range static verdict: a certificate-backed negative
    `MappingResult` when the pair provably cannot map at any
    II <= ``max_ii`` (fatal structural lint, or a MII/demand floor past
    the range), else ``None``.

    The result is cache-admissible under `serve.cache.store`'s existing
    negative rules: ``attempts == 0`` with certificates attached and
    ``proved_infeasible=True`` — the same encoding a full
    certified-UNSAT engine run produces, minus the engine."""
    t0 = _time.perf_counter()
    findings = lint_dfg(dfg, cgra, max_bus_fanout=max_bus_fanout)
    fatal = fatal_findings(findings)
    floor = None
    if not fatal:
        floor = demand_mii(dfg, cgra, max_bus_fanout=max_bus_fanout)
        if floor <= max_ii:
            return None
        detail = f"static demand floor II >= {floor} > max_ii={max_ii}"
    else:
        detail = "; ".join(f.summary() for f in fatal[:3])
    try:
        the_mii = mii(dfg, cgra)
    except (ValueError, KeyError, RuntimeError):
        # Fatally malformed DFGs (dangling edges, cycles) can defeat
        # even the MII recurrence scan; the claim covers the full range
        # regardless.
        the_mii = 1
    start = max(the_mii if not fatal else 1, min_ii or 0, 1)
    certs = [IICertificate(ii=ii, jitter=-1, stage="static-demand",
                           detail=detail, nodes=0, wall_s=0.0)
             for ii in range(start, max_ii + 1)]
    if not certs:
        # Range empty (e.g. MII already past max_ii): one certificate
        # carries the whole-range claim.
        certs = [IICertificate(ii=-1, jitter=-1, stage="static-demand",
                               detail=detail, nodes=0, wall_s=0.0)]
    return MappingResult(
        ok=False, mode=mode, ii=-1, mii=the_mii, n_routing_pes=0,
        ports_per_vio={}, placement={}, sched=None, report=None,
        cg_size=(0, 0), mis_size=0, n_ops=len(dfg.ops), attempts=0,
        wall_s=_time.perf_counter() - t0, certificates=certs,
        proved_infeasible=True, backend="static")
