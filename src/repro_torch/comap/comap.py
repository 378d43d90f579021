"""Multi-kernel co-mapping driver.

``co_map`` places several DFGs on one PEA concurrently:

1. **Layout** — `regions.partition` slices the array into rectangular
   regions, area-proportional to the kernels' op counts (HeLEx-style
   spatial region layout, arXiv 2511.19366).
2. **Common-II region mapping** — every kernel is mapped inside its
   region view (``CGRAConfig.view``) at one shared II: modulo slots of
   co-resident kernels must mean the same cycle for the shared buses to
   be arbitrable at all.  The search starts at the largest per-region
   MII and escalates.  Each region run *is* a full `bandmap.map_dfg`
   pipeline — conflict-graph build, `certify` pre-pass,
   `PortfolioSBTS` harvest rounds — and yields a regular
   ``MappingResult``; a co-mapping round batches those engines over all
   regions before any global work happens.
3. **Arbitration** — `arbiter.arbitrate` cross-checks the regions'
   fixed port/bus-cell claims and the pooled GRF budget; clashing
   regions are re-mapped with diversified seeds (the co-mapping
   analogue of the validation-retry re-arm).
4. **Merged replay** — `arbiter.merge_mappings` disjoint-unions the
   region bindings into one global ``ScheduledDFG`` + placement and the
   existing `core.validate.validate_mapping` replays it against the
   full-array config.  Only a validator-accepted merged binding is
   reported ok.

This is the port's copy of `repro.comap.comap`.  ``co_map`` takes one
more runtime handle, ``device``, passed to every region's `map_dfg`:
with the port's default ``engine="device"`` each region's portfolio
runs `mis_device.DeviceSBTS` on the card.
"""

from __future__ import annotations

import dataclasses
import time as _time

from repro_torch.core.bandmap import MappingResult, map_dfg
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.conflict import Vertex
from repro_torch.core.dfg import DFG
from repro_torch.core.options import MapOptions
from repro_torch.core.schedule import ScheduledDFG, mii
from repro_torch.core.validate import ValidationReport, validate_mapping
from repro_torch.core.workloads import op_weight
from repro_torch.obs.flight import recording
from repro_torch.obs.trace import live

from .arbiter import ArbiterReport, arbitrate, merge_mappings
from .regions import Region, partition


@dataclasses.dataclass
class CoMapResult:
    ok: bool
    ii: int                          # common II (-1 when nothing mapped)
    regions: list[Region]
    # Region-view configs the per-kernel runs were mapped against
    # (region rows/cols + the GRF share granted to each region).
    region_cfgs: list[CGRAConfig]
    results: list[MappingResult | None]   # per-kernel region mappings
    sched: ScheduledDFG | None       # merged schedule (ok runs)
    placement: dict[int, Vertex]     # merged global placement
    report: ValidationReport | None  # merged validator replay
    arbiter: ArbiterReport | None
    attempts: int                    # co-mapping rounds spent
    wall_s: float
    # Flight-recorder dump (see `repro_torch.obs.flight`) attached to failed
    # runs mapped under a live recorder — same contract as
    # `MappingResult.flight`.
    flight: tuple = ()

    @property
    def n_kernels(self) -> int:
        return len(self.regions)

    def summary(self) -> str:
        per = ", ".join(
            f"{r}→{'∅' if res is None else res.summary().split(':')[1].strip()}"
            for r, res in zip(self.regions, self.results))
        return (f"comap: ok={self.ok} II={self.ii} "
                f"kernels={self.n_kernels} rounds={self.attempts} "
                f"[{per}]")


def co_map(dfgs: list[DFG], cgra: CGRAConfig,
           options: "MapOptions | dict | None" = None, *,
           rounds: int = 4, grf_split: bool = True, tracer=None,
           record=None, device=None, **kwargs) -> CoMapResult:
    """Co-map ``dfgs`` onto ``cgra``; see the module docstring.

    Mapping knobs take the same `MapOptions` / dict / legacy-keyword
    forms as `map_dfg` (``mode``, ``max_ii``, ``mis_restarts``,
    ``certify``, ...); each region run is a full `map_dfg` under those
    options with its II pinned to the common-II cursor and a
    region-diversified seed.  ``rounds`` (arbitration/validation
    retries per II before escalating) and ``grf_split`` (divide the
    global register file evenly among regions for the local runs — the
    pooled budget is re-checked by the arbiter and the merged replay
    either way) are co-mapping knobs, not `MapOptions` fields, so they
    stay true keyword arguments.  ``min_ii`` floors the common-II
    search (a caller pacing the kernels to an external rate passes the
    same floor it would pass to `map_dfg`).  ``tracer`` (default None)
    records per-region "comap-region" spans, "arbitrate"/"merge-replay"
    spans and the ``comap.arbitration_retries`` counter; see
    `repro_torch.obs`.  ``record`` (default None) is the flight-recorder
    twin: "comap-round"/"comap-arbitrate" events land in the shared
    ring (each region run also records its own engine events into it),
    and a failed run returns with ``result.flight`` attached.
    ``device`` (default None, meaning ``"cuda"``) is where the regions'
    device engines run; a runtime handle, never a fingerprinted
    knob."""
    opts = MapOptions.coerce(options, kwargs)
    seed = opts.seed
    max_ii, min_ii = opts.schedule.max_ii, opts.schedule.min_ii
    trc = live(tracer)
    rec = recording(record)
    t0 = _time.perf_counter()
    k = len(dfgs)
    if k == 0:
        raise ValueError("co_map needs at least one DFG")
    regions = partition(cgra, [op_weight(d) for d in dfgs])
    grf_share = (cgra.grf // k) if grf_split else cgra.grf
    cfgs = [reg.config(cgra, grf=grf_share) for reg in regions]
    start_ii = max(min_ii or 0,
                   max(mii(d, cfg) for d, cfg in zip(dfgs, cfgs)))

    results: list[MappingResult | None] = [None] * k
    attempts = 0
    last_arb: ArbiterReport | None = None
    last_report: ValidationReport | None = None
    last_merged: tuple[ScheduledDFG | None, dict] = (None, {})

    for ii_star in range(start_ii, max_ii + 1):
        results = [None] * k
        stale = set(range(k))
        for rnd in range(rounds):
            attempts += 1
            for i in sorted(stale):
                with trc.span("comap-region", region=i, round=rnd,
                              ii=ii_star) as sp:
                    results[i] = map_dfg(
                        dfgs[i], cfgs[i],
                        options=opts.replace(
                            min_ii=ii_star, max_ii=ii_star,
                            seed=seed + 131 * rnd + 17 * i),
                        tracer=tracer, record=record, device=device)
                    sp.set(ok=results[i].ok)
            rec.emit("comap-round", ii=ii_star, round=rnd,
                     ok_regions=sum(1 for r in results
                                    if r is not None and r.ok))
            if not all(r is not None and r.ok for r in results):
                # Some region cannot bind at this common II at all —
                # re-seeding the others cannot fix that; escalate.
                break
            with trc.span("arbitrate", round=rnd, ii=ii_star) as asp:
                arb = arbitrate(regions, results, cgra)
                asp.set(ok=arb.ok)
            rec.emit("comap-arbitrate", ii=ii_star, round=rnd,
                     ok=arb.ok)
            last_arb = arb
            if not arb.ok:
                trc.count("comap.arbitration_retries")
                stale = set(arb.implicated)
                continue
            with trc.span("merge-replay", ii=ii_star):
                merged_sched, placement = merge_mappings(regions,
                                                         results)
                report = validate_mapping(merged_sched, cgra, placement)
            last_report = report
            last_merged = (merged_sched, placement)
            if report.ok:
                return CoMapResult(
                    ok=True, ii=ii_star, regions=regions,
                    region_cfgs=cfgs, results=results,
                    sched=merged_sched, placement=placement,
                    report=report, arbiter=arb, attempts=attempts,
                    wall_s=_time.perf_counter() - t0)
            # Merged validation failed on capacity the fixed claims
            # could not see (global bus packing): re-map the regions the
            # advisory overlaps implicate, or everyone as a last resort.
            stale = set(arb.advisory_implicated) or set(range(k))

    merged_sched, placement = last_merged
    flight: tuple = ()
    if record is not None:
        flight = record.dump()
    return CoMapResult(
        ok=False,
        ii=next((r.ii for r in results if r is not None), -1),
        regions=regions, region_cfgs=cfgs, results=results,
        sched=merged_sched, placement=placement, report=last_report,
        arbiter=last_arb, attempts=attempts,
        wall_s=_time.perf_counter() - t0, flight=flight)
