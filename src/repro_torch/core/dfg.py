"""Data-flow graph (DFG) abstraction for CGRA mapping.

D(V_D, E_D) with V_D = V_r (computing ops) ∪ V_s (virtual ops),
V_s = V_i (virtual input ops, VIO) ∪ V_o (virtual output ops, VOO).
Edges carry an iteration ``distance`` (0 = intra-iteration) so RecMII can be
computed for loop-carried dependencies (CnKm kernels are acyclic, distance 0).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable


class OpKind(enum.Enum):
    COMPUTE = "compute"   # V_r: executes on a PE
    VIN = "vin"           # V_i: virtual input operation (VIO), occupies IPORT
    VOUT = "vout"         # V_o: virtual output operation (VOO), occupies OPORT
    ROUTE = "route"       # routing operation inserted in phases 2/4 (occupies a PE)


@dataclasses.dataclass
class Op:
    op_id: int
    kind: OpKind
    name: str = ""
    latency: int = 1
    # For VIO clones created by bandwidth allocation (Fig. 2(c)(e)): clone
    # group id shared by all copies of the same datum.  -1 = not a clone.
    clone_of: int = -1

    def __hash__(self) -> int:
        return self.op_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Op({self.op_id},{self.kind.value},{self.name})"


@dataclasses.dataclass
class Edge:
    src: int
    dst: int
    distance: int = 0  # iteration distance for loop-carried deps


class DFG:
    """Mutable DFG.  Ops are indexed by integer id."""

    def __init__(self) -> None:
        self.ops: dict[int, Op] = {}
        self.edges: list[Edge] = []
        self._next_id = 0

    # ---------------------------------------------------------------- build
    def add_op(self, kind: OpKind, name: str = "", latency: int = 1,
               clone_of: int = -1) -> int:
        oid = self._next_id
        self._next_id += 1
        self.ops[oid] = Op(oid, kind, name or f"{kind.value}{oid}", latency,
                           clone_of)
        return oid

    def add_edge(self, src: int, dst: int, distance: int = 0) -> None:
        assert src in self.ops and dst in self.ops
        self.edges.append(Edge(src, dst, distance))

    def remove_edge(self, src: int, dst: int) -> None:
        self.edges = [e for e in self.edges if not (e.src == src and e.dst == dst)]

    # ---------------------------------------------------------------- views
    @property
    def v_r(self) -> list[int]:
        return [i for i, o in self.ops.items()
                if o.kind in (OpKind.COMPUTE, OpKind.ROUTE)]

    @property
    def v_i(self) -> list[int]:
        return [i for i, o in self.ops.items() if o.kind == OpKind.VIN]

    @property
    def v_o(self) -> list[int]:
        return [i for i, o in self.ops.items() if o.kind == OpKind.VOUT]

    @property
    def v_s(self) -> list[int]:
        return self.v_i + self.v_o

    def successors(self, oid: int) -> list[int]:
        return [e.dst for e in self.edges if e.src == oid]

    def predecessors(self, oid: int) -> list[int]:
        return [e.src for e in self.edges if e.dst == oid]

    def out_edges(self, oid: int) -> list[Edge]:
        return [e for e in self.edges if e.src == oid]

    def in_edges(self, oid: int) -> list[Edge]:
        return [e for e in self.edges if e.dst == oid]

    # ---------------------------------------------------------- reuse degree
    def rd(self, oid: int) -> int:
        """Spatial reuse degree RD(op) for op ∈ V_s.

        For a VIO it is the number of computing consumers that need the datum
        (the fan-out); for a VOO it is 1 (output data has no spatial reuse).
        """
        op = self.ops[oid]
        if op.kind == OpKind.VIN:
            return len(self.successors(oid))
        return 1

    # ------------------------------------------------------------- analysis
    def topo_order(self) -> list[int]:
        """Topological order ignoring loop-carried (distance>0) edges."""
        indeg = {i: 0 for i in self.ops}
        for e in self.edges:
            if e.distance == 0:
                indeg[e.dst] += 1
        ready = [i for i, d in indeg.items() if d == 0]
        order: list[int] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for e in self.edges:
                if e.distance == 0 and e.src == n:
                    indeg[e.dst] -= 1
                    if indeg[e.dst] == 0:
                        ready.append(e.dst)
        if len(order) != len(self.ops):
            raise ValueError("DFG has an intra-iteration cycle")
        return order

    def heights(self) -> dict[int, int]:
        """Longest path (in latencies) from each op to any sink; scheduling
        priority."""
        h = {i: 0 for i in self.ops}
        for oid in reversed(self.topo_order()):
            succ = [e.dst for e in self.edges if e.src == oid and e.distance == 0]
            h[oid] = self.ops[oid].latency + (max((h[s] for s in succ), default=0))
        return h

    def rec_mii(self) -> int:
        """Recurrence-constrained MII = max over cycles of
        ceil(sum(latency)/sum(distance)).  Uses a simple DFS cycle
        enumeration; CnKm DFGs are acyclic so this is usually 1."""
        # Build adjacency incl. distances
        adj: dict[int, list[Edge]] = {i: [] for i in self.ops}
        for e in self.edges:
            adj[e.src].append(e)
        best = 1
        # Bounded cycle search (graphs here are small); detect back edges
        for start in self.ops:
            stack = [(start, 0, 0, {start})]
            while stack:
                node, lat, dist, seen = stack.pop()
                for e in adj[node]:
                    nl = lat + self.ops[node].latency
                    nd = dist + e.distance
                    if e.dst == start and nd > 0:
                        best = max(best, -(-nl // nd))
                    elif e.dst not in seen and len(seen) < 12:
                        stack.append((e.dst, nl, nd, seen | {e.dst}))
        return best

    def clone_vio(self, oid: int, consumers: Iterable[int]) -> int:
        """Create a VIO clone representing the same datum (Fig. 2(c)(e)) and
        move ``consumers`` onto it.  Each clone occupies its own port."""
        op = self.ops[oid]
        assert op.kind == OpKind.VIN
        group = op.clone_of if op.clone_of >= 0 else oid
        self.ops[oid].clone_of = group
        new = self.add_op(OpKind.VIN, f"{op.name}'", op.latency, clone_of=group)
        for c in list(consumers):
            # Preserve each edge's iteration distance: an inter-iteration
            # consumer stays inter-iteration on the clone's port.
            dists = [e.distance for e in self.edges
                     if e.src == oid and e.dst == c]
            self.remove_edge(oid, c)
            self.add_edge(new, c, distance=max(dists, default=0))
        return new

    def copy(self) -> "DFG":
        d = DFG()
        d.ops = {i: dataclasses.replace(o) for i, o in self.ops.items()}
        d.edges = [dataclasses.replace(e) for e in self.edges]
        d._next_id = self._next_id
        return d

    def __repr__(self) -> str:  # pragma: no cover
        return (f"DFG(|V_r|={len(self.v_r)}, |V_i|={len(self.v_i)}, "
                f"|V_o|={len(self.v_o)}, |E|={len(self.edges)})")
