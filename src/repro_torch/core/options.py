"""`MapOptions` — the single source of truth for mapping knobs.

`map_dfg` grew 18 keyword arguments across PRs 1-8 (schedule shaping,
certificate budgets, portfolio tuning, backend selection); every engine
module read its slice of them from loose kwargs or option dicts, and
`serve.cache` fingerprinted the raw dict.  This module consolidates
them into one frozen dataclass tree:

- `ScheduleOptions`  — II range and schedule shaping (``max_ii``,
  ``min_ii``, ``use_grf``, ``max_bus_fanout``).
- `CertifyOptions`   — certificate stages, exact-search budgets and the
  static pre-pass (``enabled``, ``budget``, ``n_exact_placements``,
  ``static_prepass``, ``hall``, ``exact_node_budget``).
- `PortfolioOptions` — the stochastic engine (``restarts``, ``iters``,
  ``engine="device"|"numpy"``, ``device_seeds``, ``group_move``,
  ``row_cache_limit``).
- `MapOptions`       — top level: ``mode``, ``seed``, ``backend``,
  ``bus_pressure`` + the three groups above.

Engine modules (`core.bandmap`, `repro.exact`, `repro.comap`,
`serve.scheduler`) read knobs ONLY from a `MapOptions` instance — the
``options-single-source`` rule in `repro.analysis.astlint` forbids them
from pulling a knob name out of a dict.  Legacy keyword calls keep
working through exactly one adapter, :meth:`MapOptions.from_kwargs`
(unknown keys warn, they do not raise — forward compatibility for
option dicts that travel through the serve tier).

Fingerprint stability
---------------------
:meth:`MapOptions.fingerprint` is the cache-key ingredient
`serve.cache.options_fingerprint` delegates to.  It hashes the *sparse
legacy-kwarg rendering* — only fields that differ from their defaults,
under their legacy kwarg names, with ``seed`` always included — using
the exact formula the serve tier used before this module existed
(``sha256(repr(sorted(d.items())))[:12]``).  Every option dict the
serving scheduler historically produced (request options + a resolved
seed) renders to the same sparse dict, so on-disk cache entries written
before the migration still hit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings

from .mis import GroupMoveConfig


@dataclasses.dataclass(frozen=True)
class ScheduleOptions:
    """II range + schedule shaping (see `core.schedule.schedule_dfg`)."""
    max_ii: int = 32
    min_ii: int | None = None
    use_grf: bool | None = None
    max_bus_fanout: int | None = None


@dataclasses.dataclass(frozen=True)
class CertifyOptions:
    """Certificate stages + exact-search budgets (`core.certify`,
    `repro.exact`).  ``budget`` is the per-(II, jitter) CSP node budget
    (the old ``certify_budget``); ``exact_node_budget`` overrides it
    for the race's prover side only (`exact.race_map_dfg`)."""
    enabled: bool = True
    budget: int = 200_000
    n_exact_placements: int = 4
    static_prepass: bool = True
    hall: bool = True
    exact_node_budget: int | None = None


@dataclasses.dataclass(frozen=True)
class PortfolioOptions:
    """The stochastic MIS engine.  ``engine`` selects the numpy
    lock-step portfolio (`core.mis.PortfolioSBTS`, the oracle) or the
    GPU-resident batched engine (`core.mis_device.DeviceSBTS`);
    ``device_seeds`` is the device engine's trajectory count (the numpy
    engine's count is ``restarts``, scaled by the II=MII boost).

    ``engine`` defaults to ``"device"`` here, the one default that
    differs from the JAX package (whose default is ``"numpy"``): the
    port maps on the GPU unless the caller asks for the host engine.
    `MapOptions.fingerprint` hashes only knobs that differ from their
    defaults, so the two packages' default options hash alike although
    they name different engines."""
    restarts: int = 10
    iters: int = 20_000
    engine: str = "device"
    device_seeds: int = 1024
    group_move: GroupMoveConfig | None = None
    row_cache_limit: int | None = None

    def __post_init__(self):
        if self.group_move is True:
            object.__setattr__(self, "group_move", GroupMoveConfig())
        elif self.group_move is False:
            object.__setattr__(self, "group_move", None)
        if self.engine not in ("numpy", "device"):
            raise ValueError(
                f"unknown portfolio engine {self.engine!r} "
                f"(expected 'numpy' or 'device')")


#: legacy `map_dfg` kwarg name -> (group attr | None, field name).
LEGACY_KNOBS: dict[str, tuple[str | None, str]] = {
    "mode": (None, "mode"),
    "seed": (None, "seed"),
    "backend": (None, "backend"),
    "bus_pressure": (None, "bus_pressure"),
    "max_ii": ("schedule", "max_ii"),
    "min_ii": ("schedule", "min_ii"),
    "use_grf": ("schedule", "use_grf"),
    "max_bus_fanout": ("schedule", "max_bus_fanout"),
    "certify": ("certify", "enabled"),
    "certify_budget": ("certify", "budget"),
    "n_exact_placements": ("certify", "n_exact_placements"),
    "static_prepass": ("certify", "static_prepass"),
    "hall": ("certify", "hall"),
    "exact_node_budget": ("certify", "exact_node_budget"),
    "mis_restarts": ("portfolio", "restarts"),
    "mis_iters": ("portfolio", "iters"),
    "engine": ("portfolio", "engine"),
    "device_seeds": ("portfolio", "device_seeds"),
    "group_move": ("portfolio", "group_move"),
    "row_cache_limit": ("portfolio", "row_cache_limit"),
}


@dataclasses.dataclass(frozen=True)
class MapOptions:
    """Every `map_dfg` knob, grouped.  See the module docstring."""
    mode: str = "bandmap"
    seed: int = 0
    backend: str = "portfolio"
    bus_pressure: bool = True
    schedule: ScheduleOptions = ScheduleOptions()
    certify: CertifyOptions = CertifyOptions()
    portfolio: PortfolioOptions = PortfolioOptions()

    # ------------------------------------------------------- adapters
    @staticmethod
    def from_kwargs(**kwargs) -> "MapOptions":
        """THE legacy adapter: flat `map_dfg`-style kwargs -> options
        tree.  Unknown keys warn and are dropped (an option dict from a
        newer client must not crash an older server)."""
        groups: dict[str, dict] = {"schedule": {}, "certify": {},
                                   "portfolio": {}}
        top: dict = {}
        unknown = []
        for key, value in kwargs.items():
            spec = LEGACY_KNOBS.get(key)
            if spec is None:
                unknown.append(key)
                continue
            group, field = spec
            (top if group is None else groups[group])[field] = value
        if unknown:
            warnings.warn(
                f"MapOptions.from_kwargs: unknown option keys "
                f"{sorted(unknown)} ignored", stacklevel=2)
        return MapOptions(
            schedule=ScheduleOptions(**groups["schedule"]),
            certify=CertifyOptions(**groups["certify"]),
            portfolio=PortfolioOptions(**groups["portfolio"]), **top)

    @staticmethod
    def coerce(options: "MapOptions | dict | None",
               kwargs: dict | None = None) -> "MapOptions":
        """Entry-point glue: accept a `MapOptions`, an option dict, or
        legacy kwargs (exactly one of ``options`` / ``kwargs``)."""
        if options is None:
            return MapOptions.from_kwargs(**(kwargs or {}))
        if kwargs:
            raise TypeError(
                "pass either options=MapOptions(...) or legacy keyword "
                f"arguments, not both (got extra {sorted(kwargs)})")
        if isinstance(options, MapOptions):
            return options
        if isinstance(options, dict):
            return MapOptions.from_kwargs(**options)
        raise TypeError(f"options must be MapOptions | dict | None, "
                        f"got {type(options).__name__}")

    def to_kwargs(self, *, sparse: bool = True) -> dict:
        """Render back to flat legacy kwargs.  ``sparse`` keeps only
        fields that differ from the defaults (plus ``seed``, always) —
        the canonical form :meth:`fingerprint` hashes."""
        defaults = _DEFAULTS
        out = {}
        for key, (group, field) in LEGACY_KNOBS.items():
            holder = self if group is None else getattr(self, group)
            value = getattr(holder, field)
            if sparse and key != "seed" \
                    and value == getattr(
                        defaults if group is None
                        else getattr(defaults, group), field):
                continue
            out[key] = value
        return out

    def replace(self, **kwargs) -> "MapOptions":
        """`dataclasses.replace` over *legacy* kwarg names (group
        routing included), e.g. ``opts.replace(seed=3, max_ii=8)``."""
        merged = self.to_kwargs(sparse=False)
        merged.update(kwargs)
        return MapOptions.from_kwargs(**merged)

    # ---------------------------------------------------- fingerprint
    def fingerprint(self) -> str:
        """Cache-key fingerprint — byte-compatible with the serve
        tier's historical ``sha256(repr(sorted(dict.items())))[:12]``
        over its sparse option dicts (see module docstring)."""
        d = self.to_kwargs(sparse=True)
        return hashlib.sha256(
            repr(sorted(d.items())).encode()).hexdigest()[:12]


_DEFAULTS = MapOptions()
