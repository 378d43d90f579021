"""Trace serialization: plain JSON and Chrome trace-event format.

Two shapes out of one `Tracer`:

- :func:`to_json` / :func:`from_json` — a lossless plain-dict dump of
  the finished spans plus the registry snapshot (counters/gauges/
  histograms), suitable for bench artifacts and round-trip tests.
- :func:`to_chrome_trace` — the Chrome trace-event JSON array format
  (``{"traceEvents": [...]}`` with complete events, ``ph: "X"``),
  which opens directly in Perfetto (https://ui.perfetto.dev) or
  chrome://tracing.  Timestamps and durations are microseconds from
  the tracer epoch; each recording thread becomes one Perfetto track.

`write_chrome_trace` / `write_json` are the one-call file writers the
demo and bench harness use.
"""

from __future__ import annotations

import json
import os

from .trace import SpanRecord, Tracer


def to_json(tracer: Tracer) -> dict:
    """Lossless plain-dict dump: spans in finish order plus the metrics
    snapshot.  Round-trips through :func:`from_json`."""
    return {
        "spans": [
            dict(sid=r.sid, parent=r.parent, name=r.name, t0=r.t0,
                 t1=r.t1, tid=r.tid, depth=r.depth, attrs=r.attrs)
            for r in tracer.finished
        ],
        "metrics": tracer.registry.snapshot(),
    }


def from_json(payload: dict) -> list[SpanRecord]:
    """Rebuild the span records from a :func:`to_json` payload."""
    return [SpanRecord(**span) for span in payload["spans"]]


def to_chrome_trace(tracer: Tracer, process_name: str = "repro") -> dict:
    """Chrome trace-event JSON object format.  Complete ("X") events,
    microsecond timestamps; counters become one final "C" event so the
    totals show as a Perfetto counter track."""
    events = []
    tids = {}
    for rec in tracer.finished:
        # Perfetto wants small stable tids; remap OS idents in order of
        # first appearance so track 0 is the main thread.
        tid = tids.setdefault(rec.tid, len(tids))
        events.append({
            "name": rec.name,
            "ph": "X",
            "ts": rec.t0 * 1e6,
            "dur": (rec.t1 - rec.t0) * 1e6,
            "pid": 0,
            "tid": tid,
            "args": {k: _jsonable(v) for k, v in rec.attrs.items()},
        })
    counters = tracer.registry.snapshot()["counters"]
    if counters:
        t_end = max((e["ts"] + e["dur"] for e in events), default=0.0)
        events.append({
            "name": "counters", "ph": "C", "ts": t_end,
            "pid": 0, "tid": 0,
            "args": {k: _jsonable(v) for k, v in counters.items()},
        })
    events.append({
        "name": "process_name", "ph": "M", "ts": 0, "pid": 0, "tid": 0,
        "args": {"name": process_name},
    })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(value):
    """Coerce span-attribute values to JSON-safe scalars (numpy ints
    and floats appear in engine attrs; anything exotic becomes repr)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    try:
        import numpy as np
        if isinstance(value, np.integer):
            return int(value)
        if isinstance(value, np.floating):
            return float(value)
    except ImportError:  # pragma: no cover - numpy is a hard dep here
        pass
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return repr(value)


def write_chrome_trace(tracer: Tracer, path: str,
                       process_name: str = "repro") -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(tracer, process_name), fh)
    return path


def write_json(tracer: Tracer, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(to_json(tracer), fh)
    return path
