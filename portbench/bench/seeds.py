"""Streams of random numbers derived from a run's ``--seed``."""

from __future__ import annotations

import hashlib


def substream(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed`` (any
    whole number, however large)."""
    digest = hashlib.blake2b(repr((int(seed),) + keys).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
