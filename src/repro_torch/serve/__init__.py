"""Mapping-as-a-service layer over the BandMap engine.

`canon` — isomorphism-invariant canonical DFG hashing + relabel maps;
`cache` — two-tier (LRU + disk) mapping cache, validator-replayed hits;
`scheduler` — admission, dedupe, co-tenant batching, worker pool;
`service` — the `MappingService` facade + metrics.
"""

from .cache import CacheHit, CacheStats, MappingCache
from .canon import CanonicalForm, canonical_form, canonical_hash, \
    relabel_result
from .scheduler import MapRequest, RequestScheduler, ServeOutcome
from .service import DEFAULT_ART_DIR, MappingService

__all__ = [
    "CacheHit", "CacheStats", "MappingCache",
    "CanonicalForm", "canonical_form", "canonical_hash",
    "relabel_result",
    "MapRequest", "RequestScheduler", "ServeOutcome",
    "DEFAULT_ART_DIR", "MappingService",
]
