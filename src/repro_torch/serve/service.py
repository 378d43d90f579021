"""`MappingService` — the mapping-as-a-service facade.

One object owns the canonical-form cache (`serve.cache`) and the
batching scheduler (`serve.scheduler`) and exposes two calls:

- ``map(dfg, cgra, **options)`` — one request, one outcome;
- ``map_batch(requests)``       — a wave of `MapRequest`s, outcomes in
  request order.

Invariant (inherited from the cache, restated here because callers see
this module): **every positive cache hit is replayed through
`core.validate.validate_mapping` before it is released** — the service
never returns a binding the validator has not accepted against the
requesting DFG's own op ids.  Negative hits short-circuit only when the
canonical blobs are byte-equal, i.e. when the request is provably
isomorphic to the DFG the infeasibility was established for.

The service keeps running metrics — per-request latency percentiles,
hit sources, throughput — which `launch/serve.py`,
`examples/serve_batch.py` and the ``serve`` benchmark section report.
Three always-on exposition surfaces ride on top (`repro_torch.obs`):
`prometheus()` renders the registry in Prometheus text format with a
shard label, every request appends one line to a JSONL access log
(`obs.expo.AccessLog`), and ``trace_sample`` head-samples requests by
canonical digest for full tracing at bounded cost — sampling is a pure
function of (digest, rate), so the sampled set is stable across
shards and replays.

This is the port's copy of `repro.serve.service`.  It takes one more
runtime handle, ``device`` (None means ``"cuda"``; without a GPU the
service raises when it is built), which reaches every mapping run, and
it keeps its disk tier in its own `DEFAULT_ART_DIR`.
"""

from __future__ import annotations

import time as _time
from collections import deque

from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.dfg import DFG
from repro_torch.obs.expo import AccessLog, head_sample, render_prometheus
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer

from .cache import MappingCache
from .scheduler import MapRequest, RequestScheduler, ServeOutcome

# The port's own directory (the port's change): it never shares the
# reference's ``artifacts/serve``.
DEFAULT_ART_DIR = "artifacts/serve_torch"


class MappingService:
    """See module docstring.  ``art_dir=None`` keeps the cache purely
    in-memory (benchmarks, tests); pass `DEFAULT_ART_DIR` (or any path)
    to persist mappings across processes."""

    # Shared mutable metrics state lives in one `obs.MetricsRegistry`:
    # concurrent `map_batch` callers (the facade is the natural thing
    # to share across server threads) publish each batch as a single
    # `record()` — one lock acquisition, no interleaved counter
    # updates.  The lock-guarded contract the hand-rolled counters used
    # to carry now lives on the registry itself (its ``_lock_guarded``
    # tuple, enforced by the same astlint rule).

    def __init__(self, *, cache: MappingCache | None = None,
                 capacity: int = 256, art_dir: str | None = None,
                 max_workers: int | None = None,
                 base_seed: int = 0,
                 registry: MetricsRegistry | None = None,
                 shard: str | None = None,
                 trace_sample: float = 0.0,
                 access_log: AccessLog | None = None,
                 flight: FlightRecorder | None = None,
                 device=None) -> None:
        self.cache = cache if cache is not None else \
            MappingCache(capacity=capacity, art_dir=art_dir)
        # ``shard`` names this service instance in Prometheus labels
        # (a multi-process deployment scrapes one endpoint per shard
        # and aggregates by label).  ``trace_sample`` is the head-
        # sampling rate in [0, 1]: requests whose canonical digest is
        # picked by `obs.expo.head_sample` run under a live tracer,
        # collected in ``self.traces``; 0.0 (the default) keeps serve
        # runs bit-identical to the untraced service.
        self.shard = shard
        self.trace_sample = float(trace_sample)
        self.access_log = access_log if access_log is not None \
            else AccessLog()
        # Service-level flight recorder: the scheduler's admit/reject/
        # crash stream.  Always on (near-zero cost) — ``flight=None``
        # gets a default ring, not a null recorder.
        self.flight = flight if flight is not None \
            else FlightRecorder()
        self.traces: deque = deque(maxlen=64)
        self.scheduler = RequestScheduler(self.cache,
                                          max_workers=max_workers,
                                          base_seed=base_seed,
                                          record=self.flight,
                                          sample=self._sample_tracer,
                                          device=device)
        self.registry = registry if registry is not None \
            else MetricsRegistry()

    def _sample_tracer(self, digest: str):
        """Digest-keyed head sampler handed to the scheduler: returns
        a fresh `Tracer` for sampled digests (retained in
        ``self.traces`` as ``(digest, tracer)``, newest-64 ring) and
        ``None`` otherwise.  Pure in (digest, rate) — see
        `obs.expo.head_sample`."""
        if not head_sample(digest, self.trace_sample):
            return None
        tracer = Tracer()
        self.traces.append((digest, tracer))
        return tracer

    # -------------------------------------------------------------- api
    def map(self, dfg: DFG, cgra: CGRAConfig, *, deadline: float = 0.0,
            tenant: str | None = None, req_id: str = "",
            **options) -> ServeOutcome:
        return self.map_batch([MapRequest(
            dfg=dfg, cgra=cgra, options=options, deadline=deadline,
            tenant=tenant, req_id=req_id)])[0]

    def map_batch(self, requests: list[MapRequest]
                  ) -> list[ServeOutcome]:
        t0 = _time.perf_counter()
        outcomes = self.scheduler.run(requests)
        wall = _time.perf_counter() - t0
        counters: dict = {"requests": len(outcomes),
                          "batch_wall_s": wall}
        hits = ok = 0
        for out in outcomes:
            hits += int(out.hit)
            ok += int(out.result is not None and out.result.ok)
            key = f"source.{out.source}"
            counters[key] = counters.get(key, 0) + 1
        counters["hits"] = hits
        counters["ok"] = ok
        # One batched record = one lock acquisition = one consistent
        # snapshot boundary for a concurrent metrics() reader.  The
        # queue-depth gauge samples admission pressure: how many
        # requests this batch put in front of the scheduler.
        self.registry.record(
            counters=counters,
            gauges={"queue_depth": len(requests)},
            observations={"latency_s": [o.wall_s for o in outcomes]})
        # One access-log line per request (schema pinned in
        # `obs.expo.ACCESS_LOG_FIELDS`); ``wall_s`` is the serve-side
        # queue-inclusive latency, not the mapper's internal wall.
        for req, out in zip(requests, outcomes):
            self.access_log.log(
                req_id=out.req_id, digest=out.canon_digest,
                tenant=req.tenant, ok=out.result.ok, hit=out.hit,
                source=out.source, wall_s=round(out.wall_s, 6),
                ii=out.result.ii, backend=out.result.backend)
        return outcomes

    # ---------------------------------------------------------- metrics
    def metrics(self, reset: bool = False) -> dict:
        """Running metrics snapshot.  ``reset=True`` atomically clears
        the registry after reading, so a nightly scrape can report
        interval deltas without clobbering a concurrent reader's view
        mid-snapshot; the default keeps cumulative totals (cache stats
        are lifetime either way)."""
        snap = self.registry.snapshot(reset=reset)
        c, h = snap["counters"], snap["histograms"]
        lat = h.get("latency_s", {})
        n_req = c.get("requests", 0)
        n_hits = c.get("hits", 0)
        wall = c.get("batch_wall_s", 0.0)
        sources = {k[len("source."):]: v for k, v in c.items()
                   if k.startswith("source.")}
        qd = snap["gauges"].get("queue_depth",
                                dict(last=0, min=0, max=0, count=0,
                                     mean=0.0))
        return dict(
            requests=n_req,
            ok=c.get("ok", 0),
            hits=n_hits,
            hit_rate=round(n_hits / n_req, 4) if n_req else 0.0,
            p50_ms=round(lat.get("p50", 0.0) * 1e3, 3),
            p95_ms=round(lat.get("p95", 0.0) * 1e3, 3),
            p99_ms=round(lat.get("p99", 0.0) * 1e3, 3),
            wall_s=round(wall, 3),
            throughput_rps=round(n_req / wall, 2) if wall else 0.0,
            sources=sources,
            static_rejects=sources.get("static_reject", 0),
            queue_depth=qd,
            cache=self.cache.stats.as_dict(),
        )

    def prometheus(self, *, labels: dict | None = None,
                   namespace: str = "bandmap") -> str:
        """Prometheus text-format exposition of the registry's
        *cumulative* view (never drains: a scrape must not race a
        `metrics(reset=True)` consumer) plus a derived ``hit_rate``
        gauge.  ``labels`` defaults to ``{"shard": self.shard}`` when
        this service was given a shard name."""
        snap = self.registry.snapshot()
        c = snap["counters"]
        n_req = c.get("requests", 0)
        gauges = dict(snap["gauges"])
        gauges["hit_rate"] = dict(
            last=round(c.get("hits", 0) / n_req, 6) if n_req else 0.0)
        snap = dict(snap, gauges=gauges)
        if labels is None and self.shard is not None:
            labels = {"shard": self.shard}
        return render_prometheus(snap, labels=labels,
                                 namespace=namespace)

    def summary(self) -> str:
        m = self.metrics()
        return (f"serve: {m['requests']} requests "
                f"({m['ok']} ok), hit-rate {m['hit_rate']:.0%}, "
                f"p50 {m['p50_ms']:.1f} ms, p95 {m['p95_ms']:.1f} ms, "
                f"p99 {m['p99_ms']:.1f} ms, "
                f"{m['throughput_rps']:.1f} req/s")
