"""Flight recorder: a bounded ring buffer of structured engine events.

Spans (`obs.trace`) answer *where the time went* on an opt-in traced
run; the flight recorder answers *what just happened* on every run —
it is cheap enough to leave on in production serving, and `dump()` of
the last-N events is attached to failed results so a postmortem never
needs a re-run under a live tracer.

`FlightRecorder.emit(kind, **attrs)` appends one `FlightEvent` to a
lock-guarded ``deque(maxlen=capacity)``: O(1), no percentile math, no
span stack, and the ring bound means a week-long serve process holds a
constant-size buffer.  Event kinds are the pinned ``EVENTS``
vocabulary in `repro_torch.obs` (the flight analogue of ``PHASES``).

The ``record=None`` contract (the flight analogue of ``tracer=None``,
enforced by the ``recorder-default-none`` AST-lint rule): engine entry
points accept ``record=None``, convert it exactly once via
:func:`recording`, and only ever test ``record is None`` /
``is not None`` — recording is observation only, so a ``record=None``
run stays bit-identical and allocation-free (`NullFlightRecorder` is a
shared no-op singleton, like `NULL_TRACER`).

Usage::

    rec = FlightRecorder(capacity=256)
    res = map_dfg(dfg, cgra, record=rec)
    if not res.ok:
        print(res.flight)        # the recorder's dump, attached by
                                 # map_dfg on every failed result
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from collections import deque

#: Default ring capacity — enough to hold a full II escalation's
#: attempt/certificate/harvest narrative for the paper kernels while
#: keeping a failed result's ``flight`` payload small.
DEFAULT_CAPACITY = 256


@dataclasses.dataclass(frozen=True)
class FlightEvent:
    """One recorded event.  ``t`` is seconds on the monotonic clock
    since the recorder's epoch (its construction instant) — never the
    wall clock, so canonical paths may hold a recorder."""
    seq: int            # global emission index (survives ring eviction)
    t: float
    kind: str           # one of `repro_torch.obs.EVENTS`
    attrs: dict

    def as_dict(self) -> dict:
        """JSON-able flat dict (the shape `dump()` returns and
        `MappingResult.flight` carries)."""
        return dict(seq=self.seq, t=round(self.t, 6), kind=self.kind,
                    **self.attrs)


class FlightRecorder:
    """See module docstring."""

    # The ring and its emission counter are appended to by every
    # recording thread (serve workers, the race's two sides); the
    # `lock-guarded-state` astlint rule pins the mutation to the lock.
    _lock_guarded = ("_events", "_seq")

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = capacity
        self.epoch = _time.perf_counter()
        self._lock = threading.Lock()
        self._events: deque[FlightEvent] = deque(maxlen=capacity)
        self._seq = 0

    def emit(self, kind: str, **attrs) -> None:
        t = _time.perf_counter() - self.epoch
        with self._lock:
            self._events.append(FlightEvent(self._seq, t, kind, attrs))
            self._seq += 1

    def dump(self) -> tuple[dict, ...]:
        """The last-``capacity`` events, oldest first, as JSON-able
        dicts — the payload failed results carry in their ``flight``
        field.  A dropped prefix is visible as a gap before the first
        ``seq``."""
        with self._lock:
            events = tuple(self._events)
        return tuple(ev.as_dict() for ev in events)

    @property
    def total(self) -> int:
        """Events emitted over the recorder's lifetime (>= len)."""
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class NullFlightRecorder:
    """The ``record=None`` default behind :func:`recording`:
    structurally a `FlightRecorder`, behaviourally nothing — no
    allocation, no lock, no clock read.  Engine paths hold exactly one
    per process (`NULL_RECORDER`)."""

    capacity = 0
    epoch = 0.0
    total = 0

    def emit(self, kind: str, **attrs) -> None:
        pass

    def dump(self) -> tuple:
        return ()

    def __len__(self) -> int:
        return 0


NULL_RECORDER = NullFlightRecorder()


def recording(record: "FlightRecorder | NullFlightRecorder | None"
              ) -> "FlightRecorder | NullFlightRecorder":
    """The one conversion engine entry points perform on their
    ``record=None`` parameter: None becomes the shared `NULL_RECORDER`,
    anything else passes through (mirror of `trace.live`)."""
    return NULL_RECORDER if record is None else record
