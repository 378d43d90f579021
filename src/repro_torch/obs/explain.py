"""Explain reports: narrate *why* a mapping landed where it did.

A `MappingResult` already carries the verdict structure — per-(II,
jitter) infeasibility certificates, the static demand floor, attempt
counts, the race winner tag — but nothing renders it as a narrative.
:func:`explain_result` turns a result (plus, optionally, the `Tracer`
and flight-recorder data from the same run) into a structured
`ExplainReport`:

- **II escalation path** — one entry per II from MII to the landing
  II, each naming its cause: static-demand floor, certificate stage(s)
  per jitter, or portfolio exhaustion.  A ``proved_infeasible`` result
  reads as a full-range UNSAT narrative.
- **Routing-PE accounting** — routing PEs and delivery ports per
  multi-consumer VIO, against the paper's BandMap-vs-BusMap framing
  (BusMap broadcasts one port per datum; BandMap's allocation is what
  the routing-PE count measures).
- **Portfolio coverage curve** — harvest-round coverage from
  "portfolio"/"portfolio-device" spans or "harvest-round" flight
  events, plus the group-move kick count.
- **Race outcome** — winner side, cancel→exit latency and the loser's
  post-cancel iterations, from the "race" span or flight events.

Exposed as ``MappingResult.explain()`` and as a CLI over serialized
results (`MappingResult.to_bytes` files, e.g. a serve artifact)::

    python -m repro_torch.obs.explain artifacts/result.bin [--json]

This module deliberately never imports ``repro_torch.core`` at module level
(`repro_torch.core.bandmap` imports `repro_torch.obs`): results are duck-typed.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class ExplainReport:
    """Structured narrative for one mapping result; `as_dict()` is the
    machine shape, `render()` the human one."""
    ok: bool
    mode: str
    ii: int
    mii: int
    backend: str
    attempts: int
    proved_infeasible: bool
    optimal: bool
    escalation: list[dict]      # per-II: ii / outcome / cause / stages
    routing: dict               # n_routing_pes / n_vios / ports / note
    coverage: list[dict]        # harvest rounds: round / coverage / best
    kicks: int                  # group-move kicks observed (traced runs)
    race: dict | None           # winner / cancel_latency_s / ...
    n_flight_events: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        ratio = self.mii / self.ii if self.ii else 0.0
        head = "ok" if self.ok else (
            "proved infeasible" if self.proved_infeasible else "failed")
        lines = [
            f"explain: {self.mode} — {head}, II={self.ii} "
            f"(MII={self.mii}, ratio={ratio:.2f}), "
            f"backend={self.backend}"
            + (", proven optimal" if self.optimal else "")]
        lines.append("II escalation:")
        for e in self.escalation:
            lines.append(f"  II={e['ii']}: {e['outcome']} — {e['cause']}")
        r = self.routing
        lines.append(f"routing: {r['note']}")
        if self.coverage:
            last = self.coverage[-1]
            lines.append(
                f"portfolio: {len(self.coverage)} harvest round(s), "
                f"final coverage {last['coverage']:.0%} "
                f"(best {last['best']}); group-move kicks: {self.kicks}")
        elif self.kicks:
            lines.append(f"portfolio: group-move kicks: {self.kicks}")
        if self.race is not None:
            rc = self.race
            extra = ""
            if rc.get("cancel_latency_s") is not None:
                extra += (f", cancel→exit "
                          f"{rc['cancel_latency_s'] * 1e3:.1f} ms")
            if rc.get("loser_iters_after_cancel") is not None:
                extra += (f", loser iters after cancel "
                          f"{rc['loser_iters_after_cancel']}")
            lines.append(f"race: winner={rc.get('winner')}{extra}")
        if self.n_flight_events:
            lines.append(
                f"flight: {self.n_flight_events} event(s) attached")
        return "\n".join(lines)


def _escalation(result, certs) -> list[dict]:
    """One entry per II from MII up to the landing (or last proven) II,
    each with a definite cause."""
    by_ii: dict[int, list] = {}
    for c in certs:
        by_ii.setdefault(int(c.ii), []).append(c)
    mii = int(getattr(result, "mii", 0) or 0)
    top = max([int(result.ii)] + list(by_ii), default=mii)
    out: list[dict] = []
    for ii in range(mii, max(top, mii) + 1):
        cs = by_ii.get(ii, [])
        stages = sorted({c.stage for c in cs})
        jitters = sorted({int(c.jitter) for c in cs})
        if result.ok and ii == int(result.ii):
            cause = (f"validated placement "
                     f"(after {int(result.attempts)} attempt(s)")
            if cs:
                cause += (f"; jitter(s) {jitters} certified first: "
                          f"{', '.join(stages)}")
            cause += ")"
            entry = dict(ii=ii, outcome="mapped", cause=cause)
        elif any(c.stage == "static-demand" for c in cs):
            detail = next((c.detail for c in cs
                           if c.stage == "static-demand"), "")
            cause = "static demand floor"
            if detail:
                cause += f": {detail}"
            entry = dict(ii=ii, outcome="skipped", cause=cause)
        elif cs:
            cause = (f"certified infeasible at jitter(s) {jitters} "
                     f"(stage(s): {', '.join(stages)})")
            if len(jitters) < 4:
                cause += "; remaining jitters exhausted the portfolio"
            entry = dict(ii=ii, outcome="skipped", cause=cause)
        else:
            entry = dict(
                ii=ii, outcome="exhausted",
                cause="no certificate — portfolio budget exhausted "
                      "without a validated placement (or no schedule "
                      "exists at this II)")
        entry["stages"] = stages
        entry["certified_jitters"] = jitters
        out.append(entry)
    return out


def _routing(result) -> dict:
    ports = getattr(result, "ports_per_vio", None) or {}
    n_vios = len(ports)
    total = int(sum(ports.values()))
    n_route = int(getattr(result, "n_routing_pes", 0))
    mode = getattr(result, "mode", "")
    if mode == "busmap":
        note = (f"{n_route} routing PE(s) under the BusMap baseline "
                f"(one port per datum, routing-PE broadcast; "
                f"{n_vios} multi-consumer VIO(s))")
    else:
        note = (f"{n_route} routing PE(s) with bandwidth allocation "
                f"({total} delivery port(s) across {n_vios} "
                f"multi-consumer VIO(s); BusMap would broadcast "
                f"through routing PEs instead)")
    return dict(n_routing_pes=n_route, n_vios=n_vios,
                total_ports=total, note=note)


def _coverage(spans, flight) -> list[dict]:
    """Harvest-round curve; spans carrying per-round coverage attrs
    (exact timings) win over flight events when both exist."""
    rounds: list[dict] = []
    for rec in spans:
        if rec.name in ("portfolio", "portfolio-device") \
                and "coverage" in rec.attrs:
            rounds.append(dict(
                ii=rec.attrs.get("ii"), round=rec.attrs.get("round"),
                coverage=float(rec.attrs["coverage"]),
                best=rec.attrs.get("best"), t=rec.t1))
    if rounds:
        rounds.sort(key=lambda r: r["t"])
        return rounds
    for ev in flight:
        if ev.get("kind") == "harvest-round":
            rounds.append(dict(
                ii=ev.get("ii"), round=ev.get("round"),
                coverage=float(ev.get("coverage", 0.0)),
                best=ev.get("best"), t=ev.get("t")))
    return rounds


def _race(result, spans, flight) -> dict | None:
    backend = getattr(result, "backend", "")
    info: dict = {}
    for rec in spans:
        if rec.name == "race":
            info.update({k: rec.attrs[k] for k in
                         ("winner", "cancel_latency_s",
                          "loser_iters_after_cancel")
                         if k in rec.attrs})
    for ev in flight:
        if ev.get("kind") == "race-winner":
            info.setdefault("winner", ev.get("winner"))
            if ev.get("cancel_latency_s") is not None:
                info.setdefault("cancel_latency_s",
                                ev["cancel_latency_s"])
    if backend.startswith("race:"):
        info.setdefault("winner", backend.split(":", 1)[1])
    return info or None


def explain_result(result, *, tracer=None, flight=None) -> ExplainReport:
    """Build an `ExplainReport` from a `MappingResult`-shaped object.
    ``tracer`` is the (optional) live `Tracer` the run was recorded
    under; ``flight`` overrides the result's own attached ``flight``
    dump (dicts as produced by `FlightRecorder.dump`)."""
    if flight is None:
        flight = tuple(getattr(result, "flight", ()) or ())
    spans = list(tracer.finished) if tracer is not None else []
    certs = list(getattr(result, "certificates", ()) or ())
    kicks = int(tracer.counter_value("portfolio.kicks")) \
        if tracer is not None else 0
    return ExplainReport(
        ok=bool(result.ok), mode=result.mode, ii=int(result.ii),
        mii=int(result.mii), backend=getattr(result, "backend", ""),
        attempts=int(getattr(result, "attempts", 0)),
        proved_infeasible=bool(getattr(result, "proved_infeasible",
                                       False)),
        optimal=bool(getattr(result, "optimal", False)),
        escalation=_escalation(result, certs),
        routing=_routing(result),
        coverage=_coverage(spans, flight),
        kicks=kicks,
        race=_race(result, spans, flight),
        n_flight_events=len(flight))


# ------------------------------------------------------------------- cli
def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.obs.explain <result.bin> [--json]`` — explain
    a serialized result (`MappingResult.to_bytes` written to a file,
    e.g. by the serve tier's artifact store)."""
    import argparse

    from repro_torch.core.bandmap import MappingResult

    ap = argparse.ArgumentParser(
        description="Explain a serialized MappingResult")
    ap.add_argument("path", help="file holding MappingResult.to_bytes")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON")
    args = ap.parse_args(argv)
    with open(args.path, "rb") as fh:
        res = MappingResult.from_bytes(fh.read())
    report = explain_result(res)
    if args.json:
        print(json.dumps(report.as_dict(), indent=1, default=str))
    else:
        print(report.render())
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
