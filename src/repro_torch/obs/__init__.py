"""Observability for the port: spans, metrics and flight events.

Copies of the reference's six modules (`trace`, `registry`, `export`,
`flight`, `explain`, `expo`), and the reference's span and flight-event
vocabularies (``PHASES``, ``EVENTS``) verbatim, so that traces, flight
dumps, explain reports and Prometheus renderings of the two packages
read alike.
"""

from .registry import NULL_COUNTER, Counter, MetricsRegistry, NullCounter
from .trace import NULL_TRACER, NullTracer, SpanRecord, Tracer, live
from .export import (from_json, to_chrome_trace, to_json,
                     write_chrome_trace, write_json)
from .flight import (NULL_RECORDER, FlightEvent, FlightRecorder,
                     NullFlightRecorder, recording)
from .explain import ExplainReport, explain_result
from .expo import (ACCESS_LOG_FIELDS, AccessLog, head_sample,
                   parse_prometheus, render_prometheus)

#: The stable span-name vocabulary (same names as the reference).
PHASES = (
    "map-dfg", "static-prepass", "schedule", "conflict-build", "certify",
    "portfolio-init", "portfolio", "portfolio-device", "repair",
    "validate", "exact-csp",
    "race", "race-side", "comap-region", "arbitrate", "merge-replay",
)

#: The stable flight-event vocabulary (same kinds as the reference).
EVENTS = (
    "phase-begin", "phase-end", "attempt", "static-skip", "certificate",
    "harvest-round", "validate-reject", "cancelled",
    "race-cancel", "race-winner", "comap-round", "comap-arbitrate",
    "serve-admit", "serve-reject", "serve-crash",
)

__all__ = [
    "Counter", "MetricsRegistry", "NullCounter", "NULL_COUNTER",
    "Tracer", "NullTracer", "NULL_TRACER", "SpanRecord", "live",
    "to_json", "from_json", "to_chrome_trace", "write_chrome_trace",
    "write_json", "PHASES",
    "FlightRecorder", "NullFlightRecorder", "NULL_RECORDER",
    "FlightEvent", "recording", "EVENTS",
    "ExplainReport", "explain_result",
    "AccessLog", "ACCESS_LOG_FIELDS", "head_sample",
    "render_prometheus", "parse_prometheus",
]
