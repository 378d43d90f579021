"""uint64-packed bitset adjacency — the conflict-graph storage engine.

The binder solves MIS on graphs whose size grows with |ops| x |PEA|
(an 8x8 CGRA already yields |V_C| > 1000), so the dense ``bool [n, n]``
matrix of the original implementation is both the memory and the traffic
bottleneck: every conflict-membership probe reads O(n) bytes.  Here a
vertex's neighbourhood is one row of ``ceil(n/64)`` uint64 words (bit j of
word j//64 = edge to vertex j, little-endian bit order), so membership
tests, degree counts and S-conflict counts become O(n/64) word ops:

- AND + popcount (``np.bitwise_count``) gives |N(v) ∩ S| per row, for the
  whole graph in one vectorised ``[n, words]`` expression;
- ``np.unpackbits`` turns a row back into a 0/1 vector for incremental
  conflict-count updates (O(n/8) memory traffic instead of an O(n) bool
  row, and one numpy call instead of a mask cascade);
- group conflicts (per-op cliques, resource-occupancy cliques) are row
  ORs of one precomputed group mask — no pairwise python loops.

All layouts are little-endian on the bit level (``bitorder="little"``), so
packing bool vectors via ``np.packbits(...).view(np.uint64)`` and the
arithmetic path (``1 << (i & 63)`` into word ``i >> 6``) agree.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

WORD = 64
_ONE = np.uint64(1)
_LITTLE = sys.byteorder == "little"


def n_words(n: int) -> int:
    return (n + WORD - 1) // WORD


def make_set(n: int) -> np.ndarray:
    """Empty bitset over a universe of ``n`` elements."""
    return np.zeros(n_words(n), dtype=np.uint64)


def set_bit(words: np.ndarray, i: int) -> None:
    words[i >> 6] |= _ONE << np.uint64(i & 63)


def clear_bit(words: np.ndarray, i: int) -> None:
    words[i >> 6] &= ~(_ONE << np.uint64(i & 63))


def test_bit(words: np.ndarray, i: int) -> bool:
    return bool((words[i >> 6] >> np.uint64(i & 63)) & _ONE)


def pack_bool(mask: np.ndarray) -> np.ndarray:
    """Pack a bool/0-1 vector into uint64 words (little-endian bits)."""
    mask = np.ascontiguousarray(mask, dtype=bool)
    if _LITTLE:
        packed = np.packbits(mask, bitorder="little")
        pad = (-packed.size) % 8
        if pad:
            packed = np.concatenate([packed, np.zeros(pad, np.uint8)])
        return packed.view(np.uint64).copy()
    words = make_set(mask.size)
    idx = np.flatnonzero(mask)
    np.bitwise_or.at(words, idx >> 6,
                     _ONE << (idx & 63).astype(np.uint64))
    return words


def pack_bool_rows(mask: np.ndarray) -> np.ndarray:
    """Pack a bool matrix ``[m, n]`` into uint64 rows ``[m, words]``."""
    mask = np.ascontiguousarray(mask, dtype=bool)
    if mask.shape[1] == 0:
        return np.zeros((mask.shape[0], 0), dtype=np.uint64)
    if _LITTLE:
        packed = np.packbits(mask, axis=1, bitorder="little")
        pad = (-packed.shape[1]) % 8
        if pad:
            packed = np.pad(packed, ((0, 0), (0, pad)))
        return np.ascontiguousarray(packed).view(np.uint64)
    return np.stack([pack_bool(row) for row in mask])  # pragma: no cover


def pack_indices(idx, n: int) -> np.ndarray:
    """Bitset over ``n`` elements with the given indices set."""
    words = make_set(n)
    idx = np.asarray(idx, dtype=np.int64)
    np.bitwise_or.at(words, idx >> 6, _ONE << (idx & 63).astype(np.uint64))
    return words


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    """Unpack a bitset (or a ``[..., words]`` batch) to 0/1 uint8 of
    length ``n`` along the last axis."""
    u8 = words.reshape(-1, words.shape[-1]).view(np.uint8)
    if not _LITTLE:  # pragma: no cover - big-endian fallback
        u8 = u8.reshape(-1, words.shape[-1], 8)[..., ::-1].reshape(
            u8.shape[0], -1)
    out = np.unpackbits(u8, axis=-1, bitorder="little", count=n)
    return out.reshape(words.shape[:-1] + (n,))


def popcount(words: np.ndarray) -> int:
    return int(np.bitwise_count(words).sum())


def indices(words: np.ndarray, n: int) -> np.ndarray:
    """Sorted element indices present in the bitset."""
    return np.flatnonzero(unpack(words, n))


class BitsetGraph:
    """Undirected graph as packed adjacency rows ``uint64 [n, words]``."""

    __slots__ = ("n", "words", "rows")

    def __init__(self, n: int):
        self.n = n
        self.words = n_words(n)
        self.rows = np.zeros((n, self.words), dtype=np.uint64)

    # ------------------------------------------------------------ build
    def add_edge(self, i: int, j: int) -> None:
        if i == j:
            return
        self.rows[i, j >> 6] |= _ONE << np.uint64(j & 63)
        self.rows[j, i >> 6] |= _ONE << np.uint64(i & 63)

    def add_edges(self, i_arr, j_arr) -> None:
        """Vectorised symmetric edge insertion for index arrays."""
        i = np.asarray(i_arr, dtype=np.int64)
        j = np.asarray(j_arr, dtype=np.int64)
        keep = i != j
        i, j = i[keep], j[keep]
        np.bitwise_or.at(self.rows, (i, j >> 6),
                         _ONE << (j & 63).astype(np.uint64))
        np.bitwise_or.at(self.rows, (j, i >> 6),
                         _ONE << (i & 63).astype(np.uint64))

    def add_clique(self, ids) -> None:
        """Pairwise-connect every pair of ``ids`` (diagonal bits are set
        too; call :meth:`clear_diagonal` once after building)."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size < 2:
            return
        mask = pack_indices(ids, self.n)
        self.rows[ids] |= mask

    def clear_diagonal(self) -> None:
        idx = np.arange(self.n, dtype=np.int64)
        self.rows[idx, idx >> 6] &= ~(_ONE << (idx & 63).astype(np.uint64))

    # ----------------------------------------------------------- queries
    def has_edge(self, i: int, j: int) -> bool:
        return test_bit(self.rows[i], j)

    def degrees(self) -> np.ndarray:
        return np.bitwise_count(self.rows).sum(axis=1, dtype=np.int64)

    @property
    def n_edges(self) -> int:
        return popcount(self.rows) // 2

    def row_u8(self, v: int) -> np.ndarray:
        """Neighbourhood of ``v`` as a 0/1 uint8 vector."""
        return unpack(self.rows[v], self.n)

    def rows_u8(self, vs) -> np.ndarray:
        """Batched :meth:`row_u8` — one unpackbits call for many rows."""
        return unpack(self.rows[np.asarray(vs, dtype=np.int64)], self.n)

    def neighbors(self, v: int) -> np.ndarray:
        return np.flatnonzero(self.row_u8(v))

    def conflict_counts(self, s_words: np.ndarray) -> np.ndarray:
        """|N(v) ∩ S| for every v, one vectorised AND+popcount."""
        return np.bitwise_count(self.rows & s_words).sum(
            axis=1, dtype=np.int64)

    def union_rows(self, vs) -> np.ndarray:
        """Packed neighbourhood union ∪_{v ∈ vs} N(v) — one OR-reduce
        over the gathered rows, no per-vertex python loop."""
        vs = np.asarray(vs, dtype=np.int64)
        if vs.size == 0:
            return make_set(self.n)
        return np.bitwise_or.reduce(self.rows[vs], axis=0)

    def cluster_members(self, vs, s_words: np.ndarray) -> np.ndarray:
        """Conflict cluster of the candidate set ``vs`` against the
        selection ``s_words``: indices of every selected vertex adjacent
        to at least one of ``vs``.  This is the group-move neighbourhood's
        extraction primitive — for an unplaced op it names exactly the
        placements that pin it out, in one AND over the packed union."""
        return indices(self.union_rows(vs) & s_words, self.n)

    def any_conflict(self, s_words: np.ndarray) -> bool:
        """Does any member of S have a neighbour in S?"""
        members = indices(s_words, self.n)
        if members.size == 0:
            return False
        return bool((self.rows[members] & s_words).any())

    def rows_u32(self, n_pad: int | None = None) -> np.ndarray:
        """Adjacency rows re-viewed as uint32 words ``[n, n_pad//32]`` —
        the device-shaped export the Pallas engines consume
        (`kernels.sbts_step`, `core.mis_device`): `jax.numpy` has no
        uint64, so packed sets live as uint32 on device.  Bit j of word
        j//32 = edge to vertex j (same little-endian bit order as
        ``rows``; on big-endian hosts the uint64 view is byteswapped
        first).  ``n_pad`` pads both axes with zero rows/words up to the
        given vertex count (a multiple of 32) so kernels can tile
        without remainder handling — padded vertices have no edges."""
        n_pad = self.n if n_pad is None else n_pad
        if n_pad % 32 or n_pad < self.n:
            raise ValueError(f"n_pad={n_pad} must be a multiple of 32 "
                             f">= n={self.n}")
        out = np.zeros((n_pad, n_pad // 32), dtype=np.uint32)
        if _LITTLE:
            w32 = self.rows.view(np.uint32)
            out[:self.n, :min(w32.shape[1], out.shape[1])] = \
                w32[:, :out.shape[1]]
        else:  # pragma: no cover - big-endian fallback
            bits = np.zeros((self.n, n_pad), dtype=np.uint32)
            bits[:, :self.n] = unpack(self.rows, self.n)
            out[:self.n] = (
                bits.reshape(self.n, -1, 32)
                << np.arange(32, dtype=np.uint32)).sum(
                    axis=-1, dtype=np.uint32)
        return out

    def rows_i32(self, n_pad: int | None = None,
                 device=None) -> torch.Tensor:
        """The torch word view of :meth:`rows_u32`: the same words
        bit-reinterpreted as ``int32 [n_pad, n_pad//32]`` (torch has no
        uint32 arithmetic) on ``device`` — the operand the
        `kernels.sbts_step` kernel and `core.mis_device` consume."""
        w32 = self.rows_u32(n_pad)
        return torch.from_numpy(w32.view(np.int32)).to(device)

    # -------------------------------------------------------- conversion
    @classmethod
    def from_rows(cls, rows: np.ndarray) -> "BitsetGraph":
        """Adopt packed adjacency rows ``uint64 [n, n_words(n)]`` as
        they are (e.g. another engine's `BitsetGraph.rows`)."""
        rows = np.asarray(rows)
        n = rows.shape[0] if rows.ndim == 2 else -1
        if rows.dtype != np.uint64 or rows.shape != (n, n_words(n)):
            raise ValueError(f"rows must be uint64 [n, ceil(n/64)], got "
                             f"{rows.dtype} {rows.shape}")
        if n % WORD and (rows[:, -1] >> np.uint64(n % WORD)).any():
            raise ValueError(f"rows name vertices beyond n={n}")
        g = cls(n)
        g.rows = rows.copy()
        return g

    def to_dense(self) -> np.ndarray:
        return unpack(self.rows, self.n).astype(bool)

    @classmethod
    def from_dense(cls, adj: np.ndarray) -> "BitsetGraph":
        adj = np.asarray(adj)
        g = cls(adj.shape[0])
        if g.n == 0:
            return g
        g.rows = pack_bool_rows(adj.astype(bool))
        g.clear_diagonal()
        return g


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[K, n_pad]`` -> ``int32 [K, n_pad//32]`` words: bit j of
    word j//32 is element j, little-endian, as in :meth:`rows_u32`
    (the words are uint32 bit patterns held as int32)."""
    k, n_pad = bits.shape
    if n_pad % 32:
        raise ValueError(f"n_pad={n_pad} is not a multiple of 32")
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device))
    words = (bits.reshape(k, n_pad // 32, 32).to(torch.int64)
             * weights).sum(dim=-1)
    # [0, 2**32) -> the int32 with the same bits (explicit wrap: no
    # implementation-defined narrowing).
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_words`: ``int32 [..., W]`` ->
    bool ``[..., 32*W]``.  The shift is arithmetic on int32, so every
    shifted word is masked to its low bit before use."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = torch.bitwise_and(
        torch.bitwise_right_shift(words.unsqueeze(-1), shifts), 1)
    return bits.to(torch.bool).reshape(*words.shape[:-1],
                                       words.shape[-1] * 32)


def as_bitset_graph(adj) -> BitsetGraph:
    """Accept either a dense bool adjacency matrix or a BitsetGraph."""
    if isinstance(adj, BitsetGraph):
        return adj
    return BitsetGraph.from_dense(np.asarray(adj))
