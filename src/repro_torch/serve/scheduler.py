"""Admission + batching of concurrent mapping requests.

A batch of `MapRequest`s is served in four stages:

1. **Admission** — requests are ordered by (deadline, arrival): the
   earliest deadline is looked up, deduped and dispatched first, so
   under a loaded worker pool tight-deadline requests start earliest.
2. **Cache** — each request's canonical form is looked up in the
   `MappingCache`; hits (positive, validator-replayed, or soundly
   negative) resolve immediately.  Cache misses then pass the *static
   admission check* (`repro_torch.analysis.static_infeasibility`): a request
   whose (DFG, fabric, options) is statically proven unmappable over
   its whole II range resolves right here with
   ``source="static_reject"`` — a certificate-backed negative that is
   also stored, so every later isomorphic request is a negative cache
   hit.  The check runs on the calling thread (it is microseconds) and
   the worker pool is never touched.  Tenant-tagged requests skip the
   cache and dedupe: co-residency asks for a *joint* placement with
   the batch's co-tenants, which no cached solo placement satisfies,
   and two isomorphic kernels of one tenant are distinct co-resident
   instances, not duplicates.
3. **Dedupe + grouping** — missing requests with the same cache key
   collapse onto one *leader* computation (followers resolve from the
   cache right after the leader lands — each follower still gets its
   own relabeled, validator-replayed copy).  Requests sharing a
   non-``None`` ``tenant``, the same fabric and the same options are
   co-tenants: groups of two or more are batched into one
   `comap.co_map` region run and placed on the array *together* (each
   kernel in its own rectangular region at one common II); a tenant
   alone in its batch is effectively solo, so it is cache-looked-up
   and mapped like any other request.  Co-mapped region results are
   not cached (their region shape depends on the whole group; a failed
   group run falls everyone back to cached solo maps, since
   region-locally-ok placements of a failed run still clash on shared
   scopes).
4. **Dispatch** — remaining independent leaders run `map_dfg` across a
   thread pool, with per-request seed diversification (two identical
   budgets don't retrace the same portfolio trajectories).  Workers
   only run the pure mapper; all cache traffic stays on the calling
   thread, so the cache needs no locking.  Options flow to `map_dfg`
   verbatim, so ``options={"backend": "race"}`` races the exact prover
   against the portfolio per request (`repro_torch.exact.race`): exact SAT
   winners land in the cache as proven-``optimal`` positives, and
   exact UNSAT winners (``proved_infeasible``) are admitted as
   certificate-backed negative entries that short-circuit every
   isomorphic request from then on (`serve.cache`).

The scheduler is synchronous per batch — `run` returns when every
request has an outcome — which is what the benchmark loop and the
`MappingService` facade want; a long-lived server loops over batches.

Observability: a scheduler-level flight recorder (``record=``)
receives the serve-admit / serve-reject / serve-crash event stream;
every dispatched worker additionally runs under its *own* per-request
`FlightRecorder`, so a failed or crashed map returns with
``result.flight`` attached without interleaving batch-mates.  A
digest-keyed head sampler (``sample=``, a ``digest -> tracer-or-None``
callable) attaches live tracers to a deterministic subset of requests;
both default to ``None``/off, keeping dispatch outcomes bit-identical.

This is the port's copy of `repro.serve.scheduler`.  It takes one more
runtime handle, ``device`` (None means ``"cuda"``, resolved when the
scheduler is built, so a missing GPU raises there and never turns into
a crash outcome per request), and passes it to every `map_dfg` and
`co_map` it runs: with the port's default ``engine="device"`` requests
map on the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time as _time
from concurrent.futures import ThreadPoolExecutor, as_completed

from repro_torch.analysis import static_infeasibility
from repro_torch.core.bandmap import MappingResult, map_dfg
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.dfg import DFG
from repro_torch.core.mis_device import resolve_device
from repro_torch.core.options import MapOptions
from repro_torch.core.validate import validate_mapping
from repro_torch.obs.flight import FlightRecorder, recording

from .cache import MappingCache
from .canon import (CanonicalForm, canonical_dfg, canonical_form,
                    relabel_result)


@dataclasses.dataclass
class MapRequest:
    """One mapping request.  ``options`` is forwarded to `map_dfg`
    verbatim (mode, budgets, knobs) and participates in the cache key.
    ``deadline`` orders admission (smaller = sooner; same unit as the
    caller likes — only the order matters).  Requests sharing a
    ``tenant`` ask to be co-resident on the fabric and are batched into
    one co-mapping run."""
    dfg: DFG
    cgra: CGRAConfig
    options: dict = dataclasses.field(default_factory=dict)
    deadline: float = math.inf
    tenant: str | None = None
    seed: int | None = None
    req_id: str = ""


@dataclasses.dataclass
class ServeOutcome:
    req_id: str
    result: MappingResult
    hit: bool
    source: str          # memory | disk | negative-* | dedupe | computed
    #                    # | comap | static_reject | crash
    # Serve-side latency: batch admission -> this request resolved,
    # queue wait included (NOT just the mapper's internal wall time).
    wall_s: float
    canon_digest: str

    @property
    def ok(self) -> bool:
        return self.result.ok


class RequestScheduler:
    """See module docstring."""

    def __init__(self, cache: MappingCache, *,
                 max_workers: int | None = None,
                 base_seed: int = 0,
                 record=None, sample=None,
                 flight_capacity: int = 256, device=None) -> None:
        self.cache = cache
        # Where the requests' device engines run (the port's change).
        self.device = resolve_device(device)
        # Scheduler-level flight recorder (``None`` = off): receives the
        # serve-admit / serve-reject / serve-crash stream for every
        # batch this scheduler runs.  Distinct from the *per-request*
        # recorders `run` creates for dispatched workers — a request's
        # failure dump must not interleave with its batch-mates'.
        self.record = record
        # Head sampler: callable ``digest -> tracer-or-None`` (the
        # service wires `obs.expo.head_sample` through this).  ``None``
        # keeps dispatch bit-identical to the unsampled scheduler.
        self.sample = sample
        self.flight_capacity = flight_capacity
        # The numpy portfolio is GIL-heavy python+numpy: oversubscribing
        # cores slows every in-flight map and inflates tail latency, so
        # the default pool matches the machine.  Requests running the
        # device engine (``engine="device"``, the port's default) spend
        # their portfolio wall in CUDA launches and host syncs that
        # release the GIL but contend for the one card — a device-heavy
        # deployment should size the pool toward 1-2 workers and lean
        # on the engine's K-way internal parallelism instead of
        # pool-level concurrency.
        self.max_workers = max_workers if max_workers is not None \
            else max(1, min(os.cpu_count() or 1, 8))
        self.base_seed = base_seed

    # ------------------------------------------------------------- run
    def run(self, requests: list[MapRequest]) -> list[ServeOutcome]:
        n = len(requests)
        canons: list[CanonicalForm] = [None] * n
        effs: list[MapOptions] = [None] * n
        outcomes: list[ServeOutcome | None] = [None] * n
        order = sorted(range(n),
                       key=lambda i: (requests[i].deadline, i))
        # Serve-side latency = batch admission -> this request resolved
        # (queue wait included — a fast map behind a long queue is a
        # slow request).
        t_batch = _time.perf_counter()
        rec = recording(self.record)

        def resolve(i: int, result, *, hit: bool, source: str) -> None:
            outcomes[i] = ServeOutcome(
                requests[i].req_id, result, hit=hit, source=source,
                wall_s=_time.perf_counter() - t_batch,
                canon_digest=canons[i].digest)

        def resolve_hit(i: int, cache_hit, *, dedupe: bool) -> None:
            src = "dedupe" if dedupe else cache_hit.source
            if cache_hit.negative:
                src = f"negative-{src}"
                rec.emit("serve-reject", digest=canons[i].digest,
                         reason="negative-cache")
            resolve(i, cache_hit.result, hit=True, source=src)

        def resolve_static(i: int, neg) -> None:
            rec.emit("serve-reject", digest=canons[i].digest,
                     reason="static")
            resolve(i, neg, hit=False, source="static_reject")

        # Stage 2: cache lookups in admission order.  Tenant-tagged
        # requests skip the cache *and* dedupe here: co-residency asks
        # for a joint placement with the batch's co-tenants — a cached
        # solo full-array placement would overlap theirs, and two
        # isomorphic kernels of one tenant are distinct co-resident
        # instances, not duplicates.  (A tenant that turns out to be
        # alone in the batch is looked up in stage 3b instead.)
        pending: list[int] = []
        for i in order:
            canons[i] = canonical_form(requests[i].dfg)
            # Effective options — the seed resolved (pinned or digest-
            # derived) — are what the mapper will actually run under,
            # so they are also what the cache must key on: a negative
            # entry proven under seed 7 must never answer a request
            # that would have run under another seed.
            effs[i] = self._solo_options(requests[i], canons[i])
            if requests[i].tenant is not None:
                pending.append(i)
                continue
            hit = self.cache.lookup(canons[i], requests[i].cgra,
                                    effs[i])
            if hit is not None:
                resolve_hit(i, hit, dedupe=False)
                continue
            neg = self._static_reject(requests[i], canons[i], effs[i])
            if neg is not None:
                resolve_static(i, neg)
            else:
                pending.append(i)

        # Stage 3a: in-flight dedupe by cache key (leader = earliest
        # deadline, since ``pending`` is in admission order) — distinct
        # pinned seeds mean distinct keys, so they never collapse.
        # Tenant requests are not deduped (see above) — they route
        # straight to the co-tenant buckets (grouped by raw options:
        # co-residency should not split on seed).
        by_key: dict[str, list[int]] = {}
        by_tenant: dict[tuple, list[int]] = {}
        for i in pending:
            r = requests[i]
            if r.tenant is not None:
                # Canonical digest excluded: co-tenancy is about
                # sharing the fabric, not about being isomorphic.  The
                # seed is excluded too — `_co_run` runs the group under
                # one seed anyway, and a pinned seed must not split a
                # tenant's kernels into overlapping solo placements.
                tkey = (r.tenant, self.cache.key(
                    _FABRIC_ONLY, r.cgra,
                    {k: v for k, v in r.options.items() if k != "seed"}))
                by_tenant.setdefault(tkey, []).append(i)
                continue
            key = self.cache.key(canons[i], r.cgra, effs[i])
            by_key.setdefault(key, []).append(i)
        leaders = [idxs[0] for idxs in by_key.values()]
        followers = {idxs[0]: idxs[1:] for idxs in by_key.values()}

        # Stage 3b: co-tenant groups of >= 2 become `co_map` runs.  A
        # tenant alone in its batch has nothing to be co-resident with,
        # so it is effectively solo — which also makes a cached solo
        # placement sound to reuse; look it up now (stage 2 skipped it).
        co_groups: list[list[int]] = []
        solo: list[int] = list(leaders)
        for idxs in by_tenant.values():
            if len(idxs) >= 2:
                co_groups.append(idxs)
                continue
            i = idxs[0]
            hit = self.cache.lookup(canons[i], requests[i].cgra,
                                    effs[i])
            if hit is not None:
                resolve_hit(i, hit, dedupe=False)
                continue
            neg = self._static_reject(requests[i], canons[i], effs[i])
            if neg is not None:
                resolve_static(i, neg)
            else:
                solo.append(i)
        solo.sort(key=lambda i: (requests[i].deadline, i))

        # Stage 4: dispatch.  Futures are submitted in deadline order
        # and collected as they complete, so a request never waits on
        # unrelated work: each dedupe follower resolves (replay of the
        # leader's entry — relabeled onto its own DFG and validator-
        # replayed) the moment its leader lands, not when the whole
        # pool drains.  When the leader's result was uncacheable
        # (heuristic failure) or rejected on replay, followers share
        # the leader's in-hand result directly — identical key means
        # identical canonical input and options, so a rerun would
        # reproduce it bit-for-bit.
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            crash_ctx: dict[object, tuple[int, FlightRecorder]] = {}

            def submit_solo(i: int):
                # Map the *canonical* copy: bit-identical input and a
                # digest-derived seed make the whole run a function of
                # structure + options — see `canon.canonical_dfg`.
                # Every dispatched worker runs under its own flight
                # recorder (a request's failure dump must not
                # interleave with its batch-mates'); the per-digest
                # head sampler decides whether it also gets a tracer.
                rec.emit("serve-admit", digest=canons[i].digest,
                         tenant=requests[i].tenant)
                req_rec = FlightRecorder(self.flight_capacity)
                tracer = self.sample(canons[i].digest) \
                    if self.sample is not None else None
                fut = pool.submit(
                    map_dfg, canonical_dfg(requests[i].dfg, canons[i]),
                    requests[i].cgra, effs[i],
                    tracer=tracer, record=req_rec, device=self.device)
                crash_ctx[fut] = (i, req_rec)
                return fut

            futs = {submit_solo(i): ("solo", i) for i in solo}
            futs.update(
                (pool.submit(self._co_run, requests, idxs),
                 ("comap", idxs)) for idxs in co_groups)
            fallback_futs: dict[object, int] = {}

            def resolve_computed(i: int, res) -> None:
                """``res`` is canonically-labeled: store as-is, then
                relabel onto the request's own ids (re-validated, so
                the released binding is validator-accepted under the
                ids the caller sees)."""
                self.cache.store(canons[i], requests[i].cgra,
                                 effs[i], res, canonical=True)
                inv = {ci: oid
                       for oid, ci in canons[i].canon_of.items()}
                out = relabel_result(res, inv)
                if out.ok and out.sched is not None:
                    out = dataclasses.replace(out, report=validate_mapping(
                        out.sched, requests[i].cgra, out.placement))
                resolve(i, out, hit=False, source="computed")
                for j in followers.pop(i, ()):
                    hit = self.cache.lookup(canons[j], requests[j].cgra,
                                            effs[j])
                    if hit is not None:
                        resolve_hit(j, hit, dedupe=True)
                        continue
                    # Leader's entry was uncacheable (heuristic
                    # failure) or rejected on replay.  The follower
                    # shares the leader's key — identical canonical
                    # input and effective options — so a rerun would
                    # reproduce ``res`` bit-for-bit; share the in-hand
                    # result instead of burning another full map.
                    inv_j = {ci: oid
                             for oid, ci in canons[j].canon_of.items()}
                    out_j = relabel_result(res, inv_j)
                    if out_j.ok and out_j.sched is not None:
                        out_j = dataclasses.replace(
                            out_j, report=validate_mapping(
                                out_j.sched, requests[j].cgra,
                                out_j.placement))
                    resolve(j, out_j, hit=False, source="dedupe")

            for fut in as_completed(list(futs)):
                tag, payload = futs[fut]
                if tag == "solo":
                    try:
                        res = fut.result()
                    except Exception as exc:
                        i, req_rec = crash_ctx[fut]
                        res = self._crash_result(requests[i], effs[i],
                                                 req_rec, exc)
                        rec.emit("serve-crash", digest=canons[i].digest,
                                 error=type(exc).__name__)
                        resolve(i, res, hit=False, source="crash")
                        # Followers share the crashed leader's result:
                        # an identical canonical input and options
                        # would reproduce the crash, not dodge it.
                        for j in followers.pop(i, ()):
                            resolve(j, res, hit=False, source="crash")
                        continue
                    resolve_computed(payload, res)
                    continue
                try:
                    pairs = fut.result()
                except Exception as exc:
                    # A crashed co-map run takes no kernel down with
                    # it: every group member falls back to a solo map
                    # (the same degradation path as an unplaced
                    # kernel).
                    rec.emit("serve-crash", digest="co-tenant",
                             error=type(exc).__name__)
                    for i in payload:
                        fallback_futs[submit_solo(i)] = i
                    continue
                for i, res in pairs:
                    if res is not None:
                        # Successful region results are NOT cached:
                        # they bind a region view whose shape depends
                        # on the whole group, and no lookup path
                        # carries a region config — a repeated group
                        # re-runs `co_map`.
                        resolve(i, res, hit=False, source="comap")
                    else:
                        # Unplaced kernel: its fallback solo map goes
                        # through the pool like any other computation.
                        fallback_futs[submit_solo(i)] = i
            for fut in as_completed(list(fallback_futs)):
                i = fallback_futs[fut]
                try:
                    res = fut.result()
                except Exception as exc:
                    _, req_rec = crash_ctx[fut]
                    rec.emit("serve-crash", digest=canons[i].digest,
                             error=type(exc).__name__)
                    resolve(i, self._crash_result(requests[i], effs[i],
                                                  req_rec, exc),
                            hit=False, source="crash")
                    continue
                resolve_computed(i, res)
        return outcomes

    # --------------------------------------------------------- helpers
    def _crash_result(self, req: MapRequest, eff: MapOptions,
                      req_rec: FlightRecorder,
                      exc: BaseException) -> MappingResult:
        """Synthetic ``ok=False`` outcome for a worker that raised.

        Carries the request's flight dump (postmortem, capped with a
        terminal "serve-crash" event) and ``attempts=1`` with no
        certificates — deliberately failing the cache's sound-negative
        admission rule, so a crash is never stored as a proof and an
        isomorphic retry gets a fresh run."""
        req_rec.emit("serve-crash", error=type(exc).__name__,
                     detail=str(exc)[:200])
        return MappingResult(
            ok=False, mode=eff.mode, ii=-1, mii=0, n_routing_pes=0,
            ports_per_vio={}, placement={}, sched=None, report=None,
            cg_size=(0, 0), mis_size=0, n_ops=len(req.dfg.ops),
            attempts=1, wall_s=0.0, flight=req_rec.dump())

    def _static_reject(self, req: MapRequest, canon: "CanonicalForm",
                       eff: MapOptions) -> MappingResult | None:
        """Static admission check on a cache miss (calling thread —
        the analyzer is schedule-free structure scanning).  A verdict
        is stored under the canonical key first — the sound negative
        `cache.store` admits (``attempts == 0`` + certificates +
        ``proved_infeasible``) — then relabeled onto the request's own
        ids for the outcome."""
        res = static_infeasibility(
            canonical_dfg(req.dfg, canon), req.cgra,
            mode=eff.mode,
            max_ii=eff.schedule.max_ii,
            min_ii=eff.schedule.min_ii,
            max_bus_fanout=eff.schedule.max_bus_fanout)
        if res is None:
            return None
        self.cache.store(canon, req.cgra, eff, res, canonical=True)
        inv = {ci: oid for oid, ci in canon.canon_of.items()}
        return relabel_result(res, inv)

    def _solo_options(self, req: MapRequest,
                      canon: CanonicalForm) -> MapOptions:
        """Per-request seed diversification: a pinned seed (in options
        or on the request) wins; otherwise the seed derives from the
        canonical digest — distinct problems explore distinct portfolio
        trajectories, while isomorphic requests reproduce the same run
        (which is what lets their results be shared soundly)."""
        if isinstance(req.options, MapOptions):
            # Structured options carry an explicit seed — pinned.
            return req.options
        eff = MapOptions.coerce(req.options)
        if "seed" not in req.options:
            eff = eff.replace(
                seed=req.seed if req.seed is not None else
                (self.base_seed + int(canon.digest[:8], 16)) % (1 << 31))
        return eff

    def _co_run(self, requests: list[MapRequest], idxs: list[int]
                ) -> list[tuple[int, MappingResult | None]]:
        """One co-tenant group -> one `co_map` region run.  Returns
        (request idx, result-or-None) pairs: a result binds the
        kernel's *region view* (`CoMapResult.region_cfgs`) in global
        fabric coordinates; ``None`` means the kernel was not jointly
        placed and the caller submits its fallback solo map through the
        pool (workers here only run the co-mapper itself)."""
        from repro_torch.comap import co_map

        lead = requests[idxs[0]]
        cgra = lead.cgra
        raw = dict(lead.options)
        # ``rounds`` / ``grf_split`` are co-mapping knobs, not
        # `MapOptions` fields — they ride the option dict on the wire
        # and peel off here ("rounds" is not a mapping knob name, so
        # the single-source lint rule does not apply).
        co_kw = {k: raw.pop(k) for k in ("rounds", "grf_split")
                 if k in raw}
        eff = MapOptions.coerce(raw)
        if "seed" not in raw:
            # Same precedence as solo requests: options seed, then the
            # request-level pinned seed, then the scheduler default.
            eff = eff.replace(seed=lead.seed if lead.seed is not None
                              else self.base_seed)
        cm = co_map([requests[i].dfg for i in idxs], cgra,
                    options=eff, device=self.device, **co_kw)
        out: list[tuple[int, MappingResult | None]] = []
        for j, i in enumerate(idxs):
            # A region result is only a *joint* placement when the whole
            # co-map succeeded (arbitration + merged validator replay);
            # after a failed run, region-locally-ok results still clash
            # on shared scopes, so every kernel falls back.
            res = cm.results[j] if cm.ok else None
            if res is None or not res.ok:
                out.append((i, None))
            else:
                # Region runs place in region-local coordinates;
                # translate to the shared fabric so co-resident
                # outcomes are directly comparable (disjoint PEs,
                # global ports).
                out.append((i, dataclasses.replace(res, placement={
                    oid: cm.regions[j].translate_vertex(v)
                    for oid, v in res.placement.items()})))
        return out


class _FabricSentinel:
    """Stands in for a canonical form in co-tenant group keys (only the
    fabric + options fingerprints matter there)."""
    digest = "co-tenant"
    blob = b""
    canon_of: dict[int, int] = {}
    op_of: list[int] = []


_FABRIC_ONLY = _FabricSentinel()
