"""Serve-tier exposition: Prometheus text format, access log, sampling.

Three pieces, all consumed by `serve.MappingService`:

- :func:`render_prometheus` / :func:`parse_prometheus` — render a
  `MetricsRegistry.snapshot()` dict in the Prometheus text exposition
  format (version 0.0.4), with an optional label dimension
  (``{shard="0"}``) so replicated serve processes scrape into one
  aggregatable namespace — the "replication-friendly metrics" half of
  the ROADMAP's distributed-serving item.  Counters render as
  ``counter``, gauges as their last value (``gauge``), histograms as a
  ``summary`` (p50/p95/p99 quantile samples plus ``_count``/``_sum``).
  The parser exists for round-trip tests and scrape tooling; it reads
  exactly what the renderer writes.
- :class:`AccessLog` — a lock-guarded JSONL per-request log with the
  pinned ``ACCESS_LOG_FIELDS`` schema (one line per `ServeOutcome`),
  kept in a bounded in-memory ring and optionally mirrored to a file.
  ``redact_digests=True`` truncates canonical digests to 12 hex chars,
  for logs that leave the trust boundary (the digest is derived from
  the request's DFG structure).
- :func:`head_sample` — deterministic digest-keyed head sampling: the
  decision is a pure function of (digest, rate), so the *same* request
  is sampled on every replica and every retry — bounded-cost tracing
  that stays reproducible, unlike a coin flip per request.
"""

from __future__ import annotations

import json
import threading
import time as _time
from collections import deque

#: Pinned access-log schema (STABLE — `tests/test_obs_expo.py` asserts
#: every emitted line carries exactly these keys, in this order).
ACCESS_LOG_FIELDS = ("ts", "req_id", "digest", "tenant", "ok", "hit",
                     "source", "wall_s", "ii", "backend")

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


# ------------------------------------------------------------ prometheus
def _metric_name(namespace: str, name: str) -> str:
    full = f"{namespace}_{name}" if namespace else name
    return "".join(c if c in _NAME_OK else "_" for c in full)


def _labels_str(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(snapshot: dict, *, labels: dict | None = None,
                      namespace: str = "bandmap") -> str:
    """Render a `MetricsRegistry.snapshot()` dict (``counters`` /
    ``gauges`` / ``histograms``) as Prometheus text exposition.
    ``labels`` (e.g. ``{"shard": "0"}``) are attached to every sample;
    metric names are ``<namespace>_<name>`` with non-identifier chars
    mapped to ``_`` (``latency_s`` stays, ``source.computed`` becomes
    ``source_computed``)."""
    lines: list[str] = []
    base = _labels_str(labels)
    for name, value in sorted(snapshot.get("counters", {}).items()):
        m = _metric_name(namespace, name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{base} {float(value):g}")
    for name, g in sorted(snapshot.get("gauges", {}).items()):
        m = _metric_name(namespace, name)
        last = g.get("last", 0.0) if isinstance(g, dict) else float(g)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{base} {float(last):g}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        m = _metric_name(namespace, name)
        lines.append(f"# TYPE {m} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            ql = dict(labels or {}, quantile=q)
            lines.append(
                f"{m}{_labels_str(ql)} {float(h.get(key, 0.0)):g}")
        count = int(h.get("count", 0))
        total = float(h.get("mean", 0.0)) * count
        lines.append(f"{m}_count{base} {count:g}")
        lines.append(f"{m}_sum{base} {total:g}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse text produced by :func:`render_prometheus` back into
    ``{metric_name: [(labels, value), ...]}`` — the round-trip half of
    the exposition tests.  Comment/TYPE lines are skipped."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        labels: dict = {}
        if head.endswith("}"):
            name, inner = head[:-1].split("{", 1)
            for pair in inner.split(","):
                if not pair:
                    continue
                k, v = pair.split("=", 1)
                labels[k] = v.strip('"')
        else:
            name = head
        out.setdefault(name, []).append((labels, float(value)))
    return out


# ------------------------------------------------------------- sampling
def head_sample(digest: str, rate: float) -> bool:
    """Deterministic head-sampling decision for one canonical digest.
    ``rate`` is the sampled fraction in [0, 1]; the decision hashes the
    digest's leading 8 hex chars into [0, 10000) and compares, so it is
    a pure function of (digest, rate) — stable across replicas,
    retries and processes."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return int(digest[:8] or "0", 16) % 10_000 < int(rate * 10_000)


# ------------------------------------------------------------ access log
class AccessLog:
    """Per-request JSONL log with the pinned `ACCESS_LOG_FIELDS` schema.

    Lines land in a bounded in-memory ring (``capacity`` newest lines,
    so a long-lived service never grows unboundedly) and, when ``path``
    is given, are appended to the file as they arrive.  All writes go
    through one lock — serve batches may resolve outcomes from pool
    callbacks on several threads."""

    _lock_guarded = ("_lines", "_count")

    def __init__(self, path: str | None = None, *,
                 capacity: int = 4096,
                 redact_digests: bool = False) -> None:
        self.path = path
        self.redact_digests = redact_digests
        self._lock = threading.Lock()
        self._lines: deque[str] = deque(maxlen=capacity)
        self._count = 0
        if path:
            import os
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # Touch (append mode) so an empty log is still a file.
            with open(path, "a"):
                pass

    def log(self, **fields) -> str:
        """Emit one line.  Unknown keys are dropped and missing keys
        are filled with None, so the line schema is exactly
        `ACCESS_LOG_FIELDS` regardless of the caller; ``ts`` defaults
        to the wall clock (this is an operational log, not a canonical
        path)."""
        entry = {k: fields.get(k) for k in ACCESS_LOG_FIELDS}
        if entry["ts"] is None:
            entry["ts"] = round(_time.time(), 3)
        if self.redact_digests and entry["digest"]:
            entry["digest"] = str(entry["digest"])[:12]
        line = json.dumps(entry, sort_keys=False, default=str)
        with self._lock:
            self._lines.append(line)
            self._count += 1
            if self.path:
                with open(self.path, "a") as fh:
                    fh.write(line + "\n")
        return line

    def tail(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` (default: all retained) lines, parsed."""
        with self._lock:
            lines = list(self._lines)
        if n is not None:
            lines = lines[-n:]
        return [json.loads(ln) for ln in lines]

    @property
    def total(self) -> int:
        """Lines emitted over the log's lifetime (>= len)."""
        with self._lock:
            return self._count

    def __len__(self) -> int:
        with self._lock:
            return len(self._lines)
