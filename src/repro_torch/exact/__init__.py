"""Exact-engine pieces the port needs so far: `hall.sdr_exists`, which
the static pre-pass (`analysis.demand`) calls.  The exact backend and
the race (`repro.exact.backend`, `repro.exact.race`) are not ported
yet (ROADMAP, "exact/backend + race")."""

from .hall import hall_pressure_edges, sdr_exists

__all__ = ["hall_pressure_edges", "sdr_exists"]
