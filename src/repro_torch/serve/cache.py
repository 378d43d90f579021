"""Two-tier mapping cache: in-memory LRU over an on-disk artifact store.

Entries are keyed by (canonical DFG digest, `CGRAConfig` fingerprint,
mapping-option fingerprint) — a mapping is only reusable for the exact
fabric and the exact `map_dfg` knob set it was produced under (search
budgets change what an ``ok=False`` result means, `max_bus_fanout`
changes the schedule itself).  Nothing is reused across different
`CGRAConfig`s: even a row/column-swapped fabric yields a different
fingerprint and therefore a different entry.

Stored values are full `MappingResult`s *relabeled into canonical op
ids* (`serve.canon.relabel_result`), positive or negative:

- **positive** — a validated binding.  On a hit the placement is
  relabeled onto the requesting DFG's op ids and **replayed through
  `core.validate.validate_mapping` before release**: the validator
  stays the single soundness authority, the cache never vouches for a
  binding itself.  A replay rejection evicts the entry and reports a
  miss (the service then maps from scratch).
- **negative** — an ``ok=False`` result, stored **only when it is a
  proof**: either ``attempts == 0`` with certificates attached (every
  (II, jitter) schedule explored was *proven* unbindable by
  `core.certify` before any stochastic search ran) or
  ``proved_infeasible`` (the exact backend, `repro_torch.exact`, certified
  every combination up to ``max_ii`` — the race path's UNSAT winners
  carry this flag even though the losing portfolio spent attempts in
  parallel).  A heuristic failure (portfolio budget exhausted under
  one seed) is never stored: a different seed might succeed, so
  caching it would mask feasible mappings.  Negative hits
  short-circuit the whole pipeline.  Their
  guarantee: a hit requires byte-equal canonical ``blob``s (request
  isomorphic to the cached problem), and the serving scheduler maps
  the *canonical* DFG copy with a digest-derived seed
  (`serve.canon.canonical_dfg`), so an isomorphic request would
  deterministically reproduce the exact schedules the certificates
  cover — jittered schedules are seed- and labeling-dependent, which
  is why determinism, not the certificates alone, carries the
  cross-request claim.

The disk tier (``art_dir``; `serve.service.DEFAULT_ART_DIR` =
``artifacts/serve_torch/`` is the conventional location, used by
``launch/serve.py --map-trace``) holds one pickle per entry via the
`MappingResult.to_bytes` hooks; in-memory evictions never delete disk
artifacts, so a warm restart repopulates from disk.

This is the port's copy of `repro.serve.cache`.  It never loads an
entry of the reference's cache, in two ways.  Its keys hash in a
package tag (`PACKAGE_TAG`), so the same request has another key, and
another file name, than in the reference: the two packages' default
options fingerprint alike while naming different engines.  And the
disk tier unpickles through an unpickler that refuses the reference's
classes (and JAX's), so a reference entry under a port key is an
unreadable artifact, a miss, and imports nothing of the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import pickle
import time as _time
from collections import OrderedDict

from repro_torch.core.bandmap import MappingResult
from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.options import MapOptions
from repro_torch.core.validate import validate_mapping

from .canon import CanonicalForm, relabel_result

ENTRY_VERSION = 1

#: Hashed into every key (the port's change): a request has another key
#: here than in the reference's cache.
PACKAGE_TAG = "repro_torch"


class _PortUnpickler(pickle.Unpickler):
    """Refuses every class of the reference package and of JAX (the
    port's change): loading one would import them into the port."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in ("repro", "jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a class of the port")
        return super().find_class(module, name)


def _loads(data: bytes):
    return _PortUnpickler(io.BytesIO(data)).load()


def config_fingerprint(cgra: CGRAConfig) -> str:
    """Stable short fingerprint of every `CGRAConfig` field."""
    return hashlib.sha256(
        repr(dataclasses.astuple(cgra)).encode()).hexdigest()[:12]


def options_fingerprint(options) -> str:
    """Stable short fingerprint of the `map_dfg` options — a
    `MapOptions` instance or a legacy option dict.

    Delegates to `MapOptions.fingerprint`, whose sparse legacy-kwarg
    rendering reproduces this function's historical
    ``sha256(repr(sorted(dict.items())))[:12]`` byte-for-byte on every
    option dict the serving scheduler produced (request options + a
    resolved seed), so on-disk entries written before the `MapOptions`
    migration still hit."""
    return MapOptions.coerce(options).fingerprint()


@dataclasses.dataclass
class CacheEntry:
    blob: bytes               # canonical form bytes (collision guard)
    result: MappingResult     # relabeled into canonical op ids
    negative: bool

    def to_bytes(self) -> bytes:
        return pickle.dumps(
            (ENTRY_VERSION, self.blob, self.negative,
             self.result.to_bytes()), protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_bytes(data: bytes) -> "CacheEntry":
        version, blob, negative, res = _loads(data)
        if version != ENTRY_VERSION:
            raise ValueError(f"cache entry version {version} != "
                             f"{ENTRY_VERSION}")
        # `MappingResult.from_bytes`, through the port's unpickler.
        res_version, result = _loads(res)
        if res_version != MappingResult.SERIAL_VERSION:
            raise ValueError(
                f"MappingResult serial version {res_version} != "
                f"{MappingResult.SERIAL_VERSION}")
        return CacheEntry(blob, result, negative)


@dataclasses.dataclass
class CacheStats:
    mem_hits: int = 0
    disk_hits: int = 0
    neg_hits: int = 0
    misses: int = 0
    replay_rejects: int = 0
    blob_mismatches: int = 0
    neg_uncacheable: int = 0   # heuristic failures refused by store()
    puts: int = 0
    evictions: int = 0
    replay_wall_s: float = 0.0

    @property
    def hits(self) -> int:
        return self.mem_hits + self.disk_hits

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return dict(vars(self), hits=self.hits, lookups=self.lookups,
                    hit_rate=round(self.hit_rate, 4))


@dataclasses.dataclass
class CacheHit:
    result: MappingResult     # relabeled onto the requesting DFG
    source: str               # 'memory' | 'disk'
    negative: bool


class MappingCache:
    """See module docstring.  ``capacity`` bounds the in-memory tier;
    ``art_dir=None`` disables the disk tier entirely."""

    def __init__(self, capacity: int = 256,
                 art_dir: str | None = None) -> None:
        self.capacity = capacity
        self.art_dir = art_dir
        self._mem: OrderedDict[str, CacheEntry] = OrderedDict()
        self.stats = CacheStats()
        if art_dir:
            os.makedirs(art_dir, exist_ok=True)

    # ------------------------------------------------------------- keys
    @staticmethod
    def key(canon: CanonicalForm, cgra: CGRAConfig,
            options: "MapOptions | dict") -> str:
        # The options' part hashes in `PACKAGE_TAG` (the port's change).
        tagged = hashlib.sha256(
            f"{PACKAGE_TAG}:{options_fingerprint(options)}".encode()
        ).hexdigest()[:12]
        return f"{canon.digest[:32]}-{config_fingerprint(cgra)}-{tagged}"

    def _path(self, key: str) -> str:
        return os.path.join(self.art_dir, f"{key}.pkl")

    # ---------------------------------------------------------- lookup
    def lookup(self, canon: CanonicalForm, cgra: CGRAConfig,
               options: "MapOptions | dict") -> CacheHit | None:
        """Return a validated (or soundly-negative) hit, else None.

        Every positive hit is replayed through the validator before
        release; a rejected replay evicts the entry and counts as a
        miss."""
        key = self.key(canon, cgra, options)
        source = "memory"
        entry = self._mem.get(key)
        if entry is not None:
            self._mem.move_to_end(key)
        elif self.art_dir and os.path.exists(self._path(key)):
            try:
                with open(self._path(key), "rb") as f:
                    entry = CacheEntry.from_bytes(f.read())
            except Exception:
                # Unreadable artifact (version skew, torn concurrent
                # write, plain corruption — unpickling garbage can
                # raise nearly anything): a miss, never a crash.
                entry = None
            if entry is not None:
                source = "disk"
                self._insert_mem(key, entry)
        if entry is None:
            self.stats.misses += 1
            return None
        if entry.blob != canon.blob:
            # Digest collision or a non-automorphic WL tie: the request
            # is NOT isomorphic to the stored problem.  Never reuse.
            self.stats.blob_mismatches += 1
            self.stats.misses += 1
            return None
        inv = {ci: oid for oid, ci in canon.canon_of.items()}
        res = relabel_result(entry.result, inv)
        if entry.negative:
            self.stats.neg_hits += 1
            if source == "memory":
                self.stats.mem_hits += 1
            else:
                self.stats.disk_hits += 1
            return CacheHit(res, source, negative=True)
        t0 = _time.perf_counter()
        report = validate_mapping(res.sched, cgra, res.placement)
        self.stats.replay_wall_s += _time.perf_counter() - t0
        if not report.ok:
            self.evict(key)
            self.stats.replay_rejects += 1
            self.stats.misses += 1
            return None
        if source == "memory":
            self.stats.mem_hits += 1
        else:
            self.stats.disk_hits += 1
        return CacheHit(dataclasses.replace(res, report=report), source,
                        negative=False)

    # ----------------------------------------------------------- store
    def store(self, canon: CanonicalForm, cgra: CGRAConfig,
              options: "MapOptions | dict", result: MappingResult, *,
              canonical: bool = False) -> str | None:
        """Store ``result`` under its canonical key; returns the key.

        ``canonical=True`` means the result was produced by mapping the
        canonically-relabeled DFG (`canon.canonical_dfg`) — the serving
        scheduler's path — and needs no relabeling on the way in;
        otherwise the result is for the request's own labeling and is
        relabeled through ``canon.canon_of``.

        Failed results are stored only when they are *proofs*: either
        certificate-backed fast-fails (``attempts == 0`` and
        certificates present — no stochastic search ever ran) or exact
        UNSAT results (``proved_infeasible`` — every (II, jitter)
        combination in range certified by the exact backend, which may
        well have spent validation attempts along the way; the race
        path, where the portfolio ran in parallel, lands here too).
        Heuristic failures are refused (returns None) and will be
        recomputed, possibly under a luckier seed."""
        if not result.ok and not result.proved_infeasible \
                and not (result.attempts == 0 and result.certificates):
            self.stats.neg_uncacheable += 1
            return None
        key = self.key(canon, cgra, options)
        id_map = {ci: ci for ci in range(canon.n)} if canonical \
            else canon.canon_of
        entry = CacheEntry(
            blob=canon.blob,
            result=relabel_result(result, id_map),
            negative=not result.ok)
        self._insert_mem(key, entry)
        if self.art_dir:
            # Per-process tmp name: concurrent services sharing an
            # art_dir must not truncate each other's in-flight writes;
            # os.replace keeps the install itself atomic.
            tmp = f"{self._path(key)}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(entry.to_bytes())
            os.replace(tmp, self._path(key))
        self.stats.puts += 1
        return key

    def evict(self, key: str) -> None:
        """Drop an entry from both tiers (replay rejection path)."""
        self._mem.pop(key, None)
        if self.art_dir:
            try:
                os.remove(self._path(key))
            except FileNotFoundError:
                pass

    def _insert_mem(self, key: str, entry: CacheEntry) -> None:
        self._mem[key] = entry
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats.evictions += 1

    def __len__(self) -> int:
        return len(self._mem)
