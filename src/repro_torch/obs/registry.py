"""Unified metrics store: counters, gauges and histograms behind one lock.

`MetricsRegistry` is the single backing store for every numeric the
engine and the serving tier emit:

- **counters** — monotonically accumulated numbers (requests served,
  portfolio iterations, CSP nodes expanded).  Increments are
  lock-guarded, so concurrent writers (serve worker threads, the two
  sides of a mapping race) never lose counts.
- **gauges** — point-in-time samples (queue depth at batch admission,
  per-seed portfolio coverage).  The registry keeps last/min/max plus
  the running count/sum, so a snapshot can report the latest value and
  the envelope without retaining every sample.
- **histograms** — full sample lists summarised to p50/p95/p99 (via
  ``numpy.percentile``, linear interpolation) at snapshot time; the
  serving tier's request-latency percentiles live here.

``snapshot(reset=False)`` returns a plain-dict view; ``reset=True``
returns the current *window* and then folds it into a cumulative
drained store before clearing — so periodic scrapes get interval
deltas while every other reader's default (cumulative) view keeps the
lifetime totals.  One consumer draining the window can therefore never
silently zero another's view: ``snapshot()`` after ``snapshot(
reset=True)`` still reports everything ever recorded (drained
histogram samples are retained up to ``_DRAIN_SAMPLE_CAP`` newest
samples per name, so a long-lived service stays bounded; percentiles
over a drained-and-capped history are over that retained suffix).
``counter_value`` and ``percentiles`` read the same cumulative view.

Thread-safety contract: the backing dicts (including the drained
store) are declared in ``_lock_guarded`` and only ever mutated under
``self._lock`` — the repo's ``lock-guarded-state`` AST-lint rule
enforces exactly that.
"""

from __future__ import annotations

import threading

import numpy as np


class Counter:
    """Handle bound to one named counter — hot loops hold the handle so
    the per-increment cost is one lock acquire, no dict lookup churn in
    the caller."""

    __slots__ = ("_reg", "name")

    def __init__(self, reg: "MetricsRegistry", name: str) -> None:
        self._reg = reg
        self.name = name

    def inc(self, n: int | float = 1) -> None:
        self._reg.inc(self.name, n)

    @property
    def value(self) -> int | float:
        return self._reg.counter_value(self.name)


class NullCounter:
    """Allocation-free no-op twin of `Counter` (the NullTracer hands
    these out so untraced hot loops pay one no-op call per increment)."""

    __slots__ = ()
    name = ""
    value = 0

    def inc(self, n: int | float = 1) -> None:
        pass


NULL_COUNTER = NullCounter()

#: Newest histogram samples retained per name in the drained store — a
#: week of reset-scrapes must not accumulate unbounded latency samples.
_DRAIN_SAMPLE_CAP = 65536


class MetricsRegistry:
    """See module docstring."""

    # Shared mutable state: serve workers, the race's two sides and any
    # metrics() reader hit this concurrently.  Enforced by the
    # `lock-guarded-state` astlint rule.
    _lock_guarded = ("_counters", "_gauges", "_hists", "_drained")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int | float] = {}
        # name -> [last, min, max, count, total]
        self._gauges: dict[str, list] = {}
        self._hists: dict[str, list[float]] = {}
        # Prior windows folded in by snapshot(reset=True): same shapes
        # as the live stores (histogram samples capped, newest kept).
        self._drained: dict = dict(counters={}, gauges={}, hists={})

    # ------------------------------------------------------------ write
    def inc(self, name: str, n: int | float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> Counter:
        with self._lock:
            self._counters.setdefault(name, 0)
        return Counter(self, name)

    def gauge(self, name: str, value: int | float) -> None:
        value = float(value)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._gauges[name] = [value, value, value, 1, value]
            else:
                g[0] = value
                g[1] = min(g[1], value)
                g[2] = max(g[2], value)
                g[3] += 1
                g[4] += value

    def observe(self, name: str, value: int | float) -> None:
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    def record(self, counters: dict | None = None,
               gauges: dict | None = None,
               observations: dict | None = None) -> None:
        """Apply a batch of updates under one lock acquisition — the
        consistent-snapshot path for callers that publish several
        metrics per event (e.g. one serve batch).  ``observations``
        values may be a scalar or an iterable of samples."""
        with self._lock:
            for name, n in (counters or {}).items():
                self._counters[name] = self._counters.get(name, 0) + n
            for name, value in (gauges or {}).items():
                value = float(value)
                g = self._gauges.get(name)
                if g is None:
                    self._gauges[name] = [value, value, value, 1, value]
                else:
                    g[0] = value
                    g[1] = min(g[1], value)
                    g[2] = max(g[2], value)
                    g[3] += 1
                    g[4] += value
            for name, values in (observations or {}).items():
                if np.isscalar(values):
                    values = [values]
                self._hists.setdefault(name, []).extend(
                    float(v) for v in values)

    # ------------------------------------------------------------- read
    def counter_value(self, name: str) -> int | float:
        """Lifetime value — drained windows included, so a concurrent
        ``snapshot(reset=True)`` never makes a counter appear to move
        backwards."""
        with self._lock:
            return self._drained["counters"].get(name, 0) + \
                self._counters.get(name, 0)

    def percentiles(self, name: str,
                    qs: tuple = (50, 95, 99)) -> tuple[float, ...]:
        with self._lock:
            samples = list(self._drained["hists"].get(name, ())) + \
                list(self._hists.get(name, ()))
        if not samples:
            return tuple(0.0 for _ in qs)
        arr = np.asarray(samples, dtype=float)
        return tuple(float(np.percentile(arr, q)) for q in qs)

    def snapshot(self, reset: bool = False) -> dict:
        """Plain-dict view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}``.  Gauges report last/min/max/count/mean;
        histograms report count/mean/max plus p50/p95/p99.

        The default view is *cumulative* (drained windows merged back
        in).  ``reset=True`` returns only the current window and folds
        it into the drained store before clearing (one atomic
        read-and-fold-and-reset — no updates can fall between), so an
        interval scraper and a lifetime reader can share the registry
        without the scrape zeroing the reader (the double-drain
        hazard)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = {k: list(v) for k, v in self._gauges.items()}
            hists = {k: list(v) for k, v in self._hists.items()}
            d = self._drained
            if reset:
                for k, v in counters.items():
                    d["counters"][k] = d["counters"].get(k, 0) + v
                for k, g in gauges.items():
                    dg = d["gauges"].get(k)
                    if dg is None:
                        d["gauges"][k] = list(g)
                    else:
                        dg[0] = g[0]
                        dg[1] = min(dg[1], g[1])
                        dg[2] = max(dg[2], g[2])
                        dg[3] += g[3]
                        dg[4] += g[4]
                for k, samples in hists.items():
                    pool = d["hists"].setdefault(k, [])
                    pool.extend(samples)
                    if len(pool) > _DRAIN_SAMPLE_CAP:
                        del pool[:len(pool) - _DRAIN_SAMPLE_CAP]
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
            else:
                for k, v in d["counters"].items():
                    counters[k] = counters.get(k, 0) + v
                for k, dg in d["gauges"].items():
                    g = gauges.get(k)
                    if g is None:
                        gauges[k] = list(dg)
                    else:
                        # The live window's last is the newest sample;
                        # envelope and count/total fold across windows.
                        g[1] = min(g[1], dg[1])
                        g[2] = max(g[2], dg[2])
                        g[3] += dg[3]
                        g[4] += dg[4]
                for k, samples in d["hists"].items():
                    hists[k] = list(samples) + hists.get(k, [])
        out_g = {}
        for name, (last, lo, hi, count, total) in gauges.items():
            out_g[name] = dict(last=last, min=lo, max=hi, count=count,
                               mean=total / count if count else 0.0)
        out_h = {}
        for name, samples in hists.items():
            arr = np.asarray(samples, dtype=float)
            p50, p95, p99 = (np.percentile(arr, (50, 95, 99))
                             if arr.size else (0.0, 0.0, 0.0))
            out_h[name] = dict(
                count=int(arr.size),
                mean=float(arr.mean()) if arr.size else 0.0,
                max=float(arr.max()) if arr.size else 0.0,
                p50=float(p50), p95=float(p95), p99=float(p99))
        return dict(counters=counters, gauges=out_g, histograms=out_h)
