"""Observability for the port: spans, metrics and flight events.

Copies of the reference's `trace`, `registry` and `flight` modules, and
the reference's span and flight-event vocabularies (``PHASES``,
``EVENTS``) verbatim, so that traces and flight dumps of the two
packages read alike.  The reference's `export`, `explain` and `expo`
modules are not ported yet (ROADMAP, "obs/explain|expo|export").
"""

from .registry import NULL_COUNTER, Counter, MetricsRegistry, NullCounter
from .trace import NULL_TRACER, NullTracer, SpanRecord, Tracer, live
from .flight import (NULL_RECORDER, FlightEvent, FlightRecorder,
                     NullFlightRecorder, recording)

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
    "PHASES",
    "FlightRecorder", "NullFlightRecorder", "NULL_RECORDER",
    "FlightEvent", "recording", "EVENTS",
]
