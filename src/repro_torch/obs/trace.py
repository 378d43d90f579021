"""Nestable spans over a monotonic clock, plus the NullTracer contract.

`Tracer` records *spans* — named, attributed intervals on the
monotonic clock (`time.perf_counter`, never the wall clock) — and
forwards counters/gauges to a `MetricsRegistry`.  Spans nest through a
per-thread stack, so one tracer can be shared by concurrent engine
threads (the mapping race, serve workers): each finished span carries
its thread id and its parent span's id, which is exactly what the
Chrome trace-event export (`obs.export`) needs to lay out per-thread
timelines in Perfetto.

The tracer-threading rule (enforced by the ``tracer-default-none``
AST-lint rule on the engine modules): every engine entry point accepts
``tracer=None``, converts it once via :func:`live` and never branches
on trace *content* — tracing must be observation only, so a
``tracer=None`` run stays bit-identical to a traced one.  `NullTracer`
is that default: every method is a no-op returning a shared singleton
(`NULL_SPAN`, `NULL_COUNTER`), so the untraced hot path allocates
nothing and never touches an RNG stream or a lock.

Usage::

    tracer = Tracer()
    with tracer.span("certify", ii=ii, jitter=j) as sp:
        ...
        sp.set(stage="exhausted", nodes=nodes)
    tracer.count("certify.csp_nodes", nodes)
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time

from .registry import NULL_COUNTER, Counter, MetricsRegistry


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span.  Times are seconds on the monotonic clock,
    relative to the tracer's epoch (its construction instant)."""
    sid: int            # unique per tracer, assigned at span start
    parent: int         # enclosing span's sid, -1 at top level
    name: str
    t0: float
    t1: float
    tid: int            # OS thread ident of the recording thread
    depth: int          # nesting depth within its thread (0 = root)
    attrs: dict

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


class _LiveSpan:
    """Context-manager handle for an open span."""

    __slots__ = ("_tracer", "sid", "parent", "name", "t0", "depth",
                 "attrs")

    def __init__(self, tracer: "Tracer", sid: int, parent: int,
                 name: str, depth: int, attrs: dict) -> None:
        self._tracer = tracer
        self.sid = sid
        self.parent = parent
        self.name = name
        self.depth = depth
        self.attrs = attrs
        self.t0 = _time.perf_counter()

    def set(self, **attrs) -> "_LiveSpan":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self)
        return False


class _NullSpan:
    """Shared no-op span — `NullTracer.span` returns this singleton, so
    the untraced path allocates nothing per call."""

    __slots__ = ()
    name = ""
    attrs: dict = {}

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """See module docstring."""

    # Finished-span list is appended to by every traced thread; the
    # `lock-guarded-state` astlint rule pins the mutation to the lock.
    _lock_guarded = ("_finished",)

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.epoch = _time.perf_counter()
        self._lock = threading.Lock()
        self._finished: list[SpanRecord] = []
        self._next_sid = 0
        self._tls = threading.local()

    # ------------------------------------------------------------- spans
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs) -> _LiveSpan:
        stack = self._stack()
        parent = stack[-1].sid if stack else -1
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        sp = _LiveSpan(self, sid, parent, name, len(stack), attrs)
        stack.append(sp)
        return sp

    def _finish(self, sp: _LiveSpan) -> None:
        t1 = _time.perf_counter()
        stack = self._stack()
        # Tolerate out-of-order exits (a caller holding the handle past
        # an enclosing span): pop through to this span if present.
        if sp in stack:
            del stack[stack.index(sp):]
        rec = SpanRecord(sid=sp.sid, parent=sp.parent, name=sp.name,
                         t0=sp.t0 - self.epoch, t1=t1 - self.epoch,
                         tid=threading.get_ident(), depth=sp.depth,
                         attrs=dict(sp.attrs))
        with self._lock:
            self._finished.append(rec)

    @property
    def finished(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._finished)

    # ----------------------------------------------------------- metrics
    def count(self, name: str, n: int | float = 1) -> None:
        self.registry.inc(name, n)

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def counter_value(self, name: str) -> int | float:
        return self.registry.counter_value(name)

    def gauge(self, name: str, value: int | float) -> None:
        self.registry.gauge(name, value)

    # ----------------------------------------------------------- summary
    def phase_breakdown(self) -> dict[str, dict]:
        """Aggregate finished spans by name: ``{name: {"count": n,
        "total_s": wall}}``, sorted by descending total.  Nested spans
        each contribute their own full duration (attribution, not a
        partition of wall time)."""
        agg: dict[str, dict] = {}
        for rec in self.finished:
            slot = agg.setdefault(rec.name, {"count": 0, "total_s": 0.0})
            slot["count"] += 1
            slot["total_s"] += rec.dur_s
        return dict(sorted(agg.items(),
                           key=lambda kv: -kv[1]["total_s"]))


class NullTracer:
    """The ``tracer=None`` default behind :func:`live`: structurally a
    `Tracer`, behaviourally nothing — no allocation, no lock, no RNG,
    no state.  Engine paths hold exactly one of these per process
    (`NULL_TRACER`)."""

    registry = None
    epoch = 0.0
    finished: tuple = ()

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def count(self, name: str, n: int | float = 1) -> None:
        pass

    def counter(self, name: str):
        return NULL_COUNTER

    def counter_value(self, name: str) -> int:
        return 0

    def gauge(self, name: str, value: int | float) -> None:
        pass

    def phase_breakdown(self) -> dict:
        return {}


NULL_TRACER = NullTracer()


def live(tracer: "Tracer | NullTracer | None") -> "Tracer | NullTracer":
    """The one conversion engine entry points perform on their
    ``tracer=None`` parameter: None becomes the shared `NULL_TRACER`,
    anything else passes through."""
    return NULL_TRACER if tracer is None else tracer
