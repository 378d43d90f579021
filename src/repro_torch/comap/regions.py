"""Rectangular region layout for multi-kernel co-mapping.

A :class:`Region` is an axis-aligned block of the PEA.  Each co-resident
kernel is mapped inside one region as if the region were a standalone
CGRA (``CGRAConfig.view``), then every placement coordinate is translated
back to the global array:

- a region's local row ``r`` is global row ``r0 + r`` — so a local IPORT
  tuple claims the *global* input port (and IBUS) of that row;
- local column ``c`` is global column ``c0 + c`` — local OPORT/OBUS
  claims translate the same way;
- a local PE ``(r, c)`` is the global PE ``(r0 + r, c0 + c)``.

Because regions are contiguous blocks, every single-hop relation the
conflict rules reason about is preserved by translation: same-PE stays
same-PE, same-local-row is same-global-row, and a local NSEW neighbour
is a global neighbour.  What translation does NOT preserve is
*exclusivity* of row/column buses and ports — two regions side by side
share the rows they span (one above the other share columns).  Those
shared scopes are exactly what `comap.arbiter` arbitrates and what the
merged replay through `core.validate` re-checks globally.

The partitioner is a deterministic guillotine split: the kernel list is
divided into two weight-balanced halves, the rectangle is cut across its
longer axis proportionally to the halves' weights, and each half recurses
into its sub-rectangle.  Weights are op counts (see
`core.workloads.op_weight`), clamped so every kernel receives at least a
1x1 region.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import CGRAConfig
from repro_torch.core.conflict import QUAD, TIN, TOUT, Vertex
from repro_torch.core.tec import COL, ROW


@dataclasses.dataclass(frozen=True)
class Region:
    """An axis-aligned ``rows x cols`` block anchored at ``(r0, c0)``."""
    r0: int
    c0: int
    rows: int
    cols: int

    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    @property
    def row_span(self) -> range:
        return range(self.r0, self.r0 + self.rows)

    @property
    def col_span(self) -> range:
        return range(self.c0, self.c0 + self.cols)

    def config(self, base: CGRAConfig, *,
               grf: int | None = None) -> CGRAConfig:
        """Local CGRA view of this region (see ``CGRAConfig.view``)."""
        return base.view(self.rows, self.cols, grf=grf)

    def overlaps(self, other: "Region") -> bool:
        return not (self.r0 + self.rows <= other.r0
                    or other.r0 + other.rows <= self.r0
                    or self.c0 + self.cols <= other.c0
                    or other.c0 + other.cols <= self.c0)

    # ------------------------------------------------------- translation
    def to_global_pe(self, pe: tuple[int, int]) -> tuple[int, int]:
        return (pe[0] + self.r0, pe[1] + self.c0)

    def translate_vertex(self, v: Vertex, op: int | None = None) -> Vertex:
        """Local placement vertex -> global coordinates.

        ``op`` optionally renumbers the op id (the merged DFG re-ids ops
        so kernels stay disjoint).  The vertex ``idx`` is meaningless
        outside its local conflict graph and is dropped to -1."""
        kw = dict(idx=-1, op=v.op if op is None else op)
        if v.kind == TIN:
            kw["port"] = v.port + self.r0
        elif v.kind == TOUT:
            kw["port"] = v.port + self.c0
        elif v.kind == QUAD:
            kw["pe"] = self.to_global_pe(v.pe)
            if v.drive is not None:
                scope, idx = v.drive
                kw["drive"] = (scope, idx + self.r0 if scope == ROW
                               else idx + self.c0)
        return dataclasses.replace(v, **kw)

    def __str__(self) -> str:
        return (f"[{self.r0}:{self.r0 + self.rows}, "
                f"{self.c0}:{self.c0 + self.cols}]")


def partition(cgra: CGRAConfig, weights: list[float]) -> list[Region]:
    """Deterministic guillotine partition of the PEA into one region per
    weight, areas roughly proportional to the weights.

    Returns regions in the same order as ``weights``.  Raises when the
    array cannot give every kernel at least one PE."""
    k = len(weights)
    if k == 0:
        return []
    if k > cgra.n_pes:
        raise ValueError(f"{k} kernels cannot share {cgra.n_pes} PEs")
    weights = [max(float(w), 1.0) for w in weights]
    out: list[Region | None] = [None] * k

    def split(r0: int, c0: int, rows: int, cols: int,
              items: list[tuple[int, float]]) -> None:
        if len(items) == 1:
            out[items[0][0]] = Region(r0, c0, rows, cols)
            return
        # Weight-balanced bipartition of the (order-preserved) item list.
        total = sum(w for _, w in items)
        acc, cut = 0.0, 1
        for i, (_, w) in enumerate(items[:-1]):
            acc += w
            cut = i + 1
            if acc >= total / 2:
                break
        left, right = items[:cut], items[cut:]
        frac = sum(w for _, w in left) / total
        if rows >= cols:
            # Cut across rows, proportional to the halves' weights but
            # clamped so each side can still host its kernel count.
            lo = -(-len(left) // cols)
            hi = rows - (-(-len(right) // cols))
            if lo > hi:
                raise ValueError("partition: kernels outnumber rows")
            r_left = min(max(int(round(rows * frac)), lo, 1),
                         max(hi, 1), rows - 1)
            split(r0, c0, r_left, cols, left)
            split(r0 + r_left, c0, rows - r_left, cols, right)
        else:
            lo = -(-len(left) // rows)
            hi = cols - (-(-len(right) // rows))
            if lo > hi:
                raise ValueError("partition: kernels outnumber columns")
            c_left = min(max(int(round(cols * frac)), lo, 1),
                         max(hi, 1), cols - 1)
            split(r0, c0, rows, c_left, left)
            split(r0, c0 + c_left, rows, cols - c_left, right)

    split(0, 0, cgra.rows, cgra.cols, list(enumerate(weights)))
    regions = [r for r in out if r is not None]
    assert len(regions) == k
    return regions
