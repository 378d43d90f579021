"""Exact mapping backend and the exact-vs-portfolio race (the port's
copy of `repro.exact`).

- `backend.exact_map_dfg` — complete prover over the engine's
  (II, jitter) schedule family: proven-optimal SAT or certified UNSAT.
- `hall.hall_pressure_edges` / `hall.sdr_exists` — Hall-style joint
  bus-demand bound over (scope, slot) grids.
- `race.race_map_dfg` — both engines at once, first sound answer wins,
  loser cancelled (`core.cancel.CancelToken`); its portfolio side runs
  on ``device`` (the card by default).

Entry point for callers: ``map_dfg(dfg, cgra, backend="exact")`` or
``backend="race"`` (`core.bandmap`).
"""

from repro_torch.core.cancel import CancelToken

from .backend import exact_map_dfg
from .hall import hall_pressure_edges, sdr_exists
from .race import race_map_dfg

__all__ = ["CancelToken", "exact_map_dfg", "hall_pressure_edges",
           "race_map_dfg", "sdr_exists"]
