"""Structural pre-mapping lint over (DFG, CGRAConfig) pairs.

Two severities:

- ``error`` — the DFG cannot be mapped by any engine backend: the
  pipeline either crashes on it (dangling edge ids, a distance-0
  recurrence cycle) or every candidate pair of some dependence edge is
  a conflict (`conflict._dep_ok` is False for *all* placements: a VIN
  with a predecessor, a VOUT with a successor).  `analysis.analyze`
  turns these into "cannot map at all" verdicts.
- ``warn`` — the shape breaks the generator-family invariants that
  `core.workloads` upholds (and now asserts, sharing these exact
  rules): such DFGs are mappable in principle but are the slow/doomed
  corner cases — e.g. an op with two VIO predecessors needs both port
  rows at once, and two VOOs sharing a producer contest one column —
  the quantitative side of which `analysis.demand` bounds soundly.

Rules (names are stable test/CLI identifiers):

========================  ========  ====================================
rule                      severity  fires when
========================  ========  ====================================
dangling-edge             error     edge endpoint id not in ``dfg.ops``
zero-distance-cycle       error     intra-iteration (distance-0) cycle
vin-has-pred              error     edge into a VIN
vout-has-succ             error     edge out of a VOUT
multi-vio-pred            warn      op with > 1 distinct VIN preds
shared-voo-producer       warn      producer feeding > 1 VOO, or a VOO
                                    with != 1 producer
vio-overfanout            warn      RD(vio) > m_eff: the scheduler will
                                    clone ports / insert routing PEs
vio-unconsumed            warn      VIN with no consumers
========================  ========  ====================================
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.dfg import DFG, OpKind

from .demand import effective_fanout


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    severity: str        # 'error' | 'warn'
    message: str
    ops: tuple[int, ...] = ()

    def summary(self) -> str:
        return f"[{self.severity}] {self.rule}: {self.message}"


def generator_invariant_findings(dfg: DFG) -> list[LintFinding]:
    """The `core.workloads` family invariants as warn-level findings —
    the single source of truth both the generators' assertions and the
    full lint share.

    - **multi-vio-pred**: every op has <= 1 distinct VIO predecessor
      (bus delivery pins a consumer to its VIO's row; two VIO preds
      demand two rows at once).
    - **shared-voo-producer**: VOOs have exactly one producer and no
      two VOOs share one (two VOOs fed by one op land on one column
      and contest its OPORT/OBUS cells slot by slot).
    """
    findings: list[LintFinding] = []
    ops = dfg.ops
    for oid in ops:
        vio_preds = sorted({p for p in dfg.predecessors(oid)
                            if p in ops and ops[p].kind == OpKind.VIN})
        if ops[oid].kind != OpKind.VIN and len(vio_preds) > 1:
            findings.append(LintFinding(
                "multi-vio-pred", "warn",
                f"op {oid} has {len(vio_preds)} VIO predecessors "
                f"{vio_preds} (family invariant: <= 1)",
                ops=(oid, *vio_preds)))
    fed: dict[int, list[int]] = {}
    for vo in dfg.v_o:
        prods = sorted({p for p in dfg.predecessors(vo) if p in ops})
        if len(prods) != 1:
            findings.append(LintFinding(
                "shared-voo-producer", "warn",
                f"VOO {vo} has {len(prods)} producers {prods} "
                f"(family invariant: exactly 1)", ops=(vo, *prods)))
        for p in prods:
            fed.setdefault(p, []).append(vo)
    for p, vos in sorted(fed.items()):
        if len(vos) > 1:
            findings.append(LintFinding(
                "shared-voo-producer", "warn",
                f"producer {p} feeds VOOs {sorted(vos)} (family "
                f"invariant: distinct producers per VOO)",
                ops=(p, *sorted(vos))))
    return findings


def lint_dfg(dfg: DFG, cgra: CGRAConfig | None = None, *,
             max_bus_fanout: int | None = None) -> list[LintFinding]:
    """Run every rule; errors first.  ``cgra`` enables the fabric-aware
    rules (vio-overfanout)."""
    findings: list[LintFinding] = []
    ops = dfg.ops

    dangling = False
    for e in dfg.edges:
        for end in (e.src, e.dst):
            if end not in ops:
                dangling = True
                findings.append(LintFinding(
                    "dangling-edge", "error",
                    f"edge {e.src}->{e.dst} (distance {e.distance}) "
                    f"references missing op {end}",
                    ops=tuple(x for x in (e.src, e.dst) if x in ops)))
    if not dangling:
        try:
            dfg.topo_order()
        except ValueError:
            findings.append(LintFinding(
                "zero-distance-cycle", "error",
                "intra-iteration (distance-0) cycle: no ASAP schedule "
                "exists at any II", ops=()))

    for e in dfg.edges:
        if e.dst in ops and ops[e.dst].kind == OpKind.VIN:
            findings.append(LintFinding(
                "vin-has-pred", "error",
                f"edge {e.src}->{e.dst} targets VIN {e.dst}: no "
                f"candidate pair realizes a dependence into an input "
                f"port tuple", ops=(e.dst,)))
        if e.src in ops and ops[e.src].kind == OpKind.VOUT:
            findings.append(LintFinding(
                "vout-has-succ", "error",
                f"edge {e.src}->{e.dst} leaves VOUT {e.src}: no "
                f"candidate pair realizes a dependence out of an "
                f"output port tuple", ops=(e.src,)))

    findings.extend(generator_invariant_findings(dfg))

    for v in dfg.v_i:
        rd = len(dfg.successors(v))
        if rd == 0:
            findings.append(LintFinding(
                "vio-unconsumed", "warn",
                f"VIN {v} has no consumers", ops=(v,)))
        elif cgra is not None:
            m_eff = effective_fanout(cgra, max_bus_fanout)
            if rd > m_eff:
                findings.append(LintFinding(
                    "vio-overfanout", "warn",
                    f"VIN {v} fans out to {rd} consumers > m_eff="
                    f"{m_eff}: the scheduler will split it into "
                    f"port clones / routing PEs", ops=(v,)))

    findings.sort(key=lambda f: (f.severity != "error", f.rule, f.ops))
    return findings


def fatal_findings(findings: list[LintFinding]) -> list[LintFinding]:
    return [f for f in findings if f.severity == "error"]
