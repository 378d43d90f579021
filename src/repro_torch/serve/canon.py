"""Isomorphism-invariant canonical DFG form for the serving cache.

Two mapping requests whose DFGs differ only by a vertex relabeling are
the *same* mapping problem: the conflict graph, the certificates and the
portfolio search all depend on structure alone.  This module turns a
`core.dfg.DFG` into a :class:`CanonicalForm` — a canonical vertex order,
a serialized canonical graph (``blob``) and its SHA-256 ``digest`` — so
the cache (`serve.cache`) can key mappings by structure and replay a
cached placement onto any isomorphic request.

Algorithm: Weisfeiler-Lehman colour refinement with individualization.

1. Initial colours from permutation-invariant op features: (kind,
   latency, clone-group flag).  VIO/VOO roles are part of ``kind``.
2. Refinement: each round, a vertex's signature is (own colour, sorted
   multiset of (predecessor colour, edge distance), sorted multiset of
   (successor colour, edge distance)); new colours are the ranks of the
   *sorted* distinct signatures, so colour values are themselves
   canonical and rounds compose permutation-invariantly.  Iterate until
   the partition stops splitting.
3. Individualization: while some colour class has > 1 member, give one
   member a fresh unique colour and re-refine.  WL ties in the DFG
   families served here are automorphisms (symmetric chains, stencil
   lanes, reduction subtrees), and individualizing *any* member of an
   automorphic class yields the identical canonical serialization — so
   the choice (lowest op id) does not leak the input labeling into the
   blob.  Should a tie ever be a non-automorphism (WL is incomplete),
   two permutations of one DFG could canonicalize differently: that
   costs a cache miss, never a wrong hit, because the cache compares
   full ``blob`` bytes before reusing an entry.

Equal ``blob`` bytes mean the two canonical forms are identical *as
labeled graphs*, so composing their relabeling maps is a true DFG
isomorphism — which is what makes negative (II-infeasibility) cache
hits sound, not just heuristic.
"""

from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core.bandmap import MappingResult
from repro_torch.core.dfg import DFG, Edge
from repro_torch.core.schedule import ScheduledDFG

CANON_VERSION = 1


@dataclasses.dataclass
class CanonicalForm:
    """Canonical view of one DFG."""
    digest: str                 # sha256 hex of ``blob``
    blob: bytes                 # serialized canonical graph
    canon_of: dict[int, int]    # op id -> canonical index
    op_of: list[int]            # canonical index -> op id

    @property
    def n(self) -> int:
        return len(self.op_of)


def _refine(n: int, colors: list[int], in_adj: list[list[tuple[int, int]]],
            out_adj: list[list[tuple[int, int]]]) -> list[int]:
    """WL refinement to a stable partition.  Adjacency lists hold vertex
    *positions*; colours are read at signature time.  New colour values
    are ranks of the sorted distinct signatures, hence permutation-
    invariant at every round."""
    while True:
        sigs = []
        for v in range(n):
            sigs.append((
                colors[v],
                tuple(sorted((colors[u], d) for u, d in in_adj[v])),
                tuple(sorted((colors[u], d) for u, d in out_adj[v])),
            ))
        rank = {s: i for i, s in enumerate(sorted(set(sigs)))}
        new = [rank[s] for s in sigs]
        if len(rank) == len(set(colors)):
            return new
        colors = new


def canonical_form(dfg: DFG) -> CanonicalForm:
    """Compute the canonical form of ``dfg`` (see module docstring)."""
    ids = sorted(dfg.ops)
    n = len(ids)
    pos = {oid: i for i, oid in enumerate(ids)}
    in_adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    out_adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for e in dfg.edges:
        out_adj[pos[e.src]].append((pos[e.dst], e.distance))
        in_adj[pos[e.dst]].append((pos[e.src], e.distance))
    feats = sorted({(dfg.ops[o].kind.value, dfg.ops[o].latency,
                     dfg.ops[o].clone_of >= 0) for o in ids})
    frank = {f: i for i, f in enumerate(feats)}
    colors = [frank[(dfg.ops[o].kind.value, dfg.ops[o].latency,
                     dfg.ops[o].clone_of >= 0)] for o in ids]

    colors = _refine(n, colors, in_adj, out_adj)
    n_indiv = 0
    while len(set(colors)) < n:
        # Smallest tied colour; lowest-op-id member (automorphic ties
        # make the resulting blob independent of this choice).
        classes: dict[int, list[int]] = {}
        for v, c in enumerate(colors):
            classes.setdefault(c, []).append(v)
        c = min(k for k, vs in classes.items() if len(vs) > 1)
        v = min(classes[c], key=lambda w: ids[w])
        colors[v] = n + n_indiv      # fresh colour, unique by construction
        n_indiv += 1
        colors = _refine(n, colors, in_adj, out_adj)

    canon_of = {ids[v]: colors[v] for v in range(n)}
    op_of = [0] * n
    for oid, ci in canon_of.items():
        op_of[ci] = oid

    ops_part = []
    for ci in range(n):
        op = dfg.ops[op_of[ci]]
        clone = canon_of[op.clone_of] if op.clone_of in canon_of else -1
        ops_part.append((op.kind.value, op.latency, clone))
    edges_part = sorted((canon_of[e.src], canon_of[e.dst], e.distance)
                        for e in dfg.edges)
    blob = repr((CANON_VERSION, tuple(ops_part),
                 tuple(edges_part))).encode()
    return CanonicalForm(digest=hashlib.sha256(blob).hexdigest(),
                         blob=blob, canon_of=canon_of, op_of=op_of)


def canonical_hash(dfg: DFG) -> str:
    """Hex digest of the canonical form (convenience)."""
    return canonical_form(dfg).digest


def canonical_dfg(dfg: DFG, canon: CanonicalForm) -> DFG:
    """The canonically-relabeled copy of ``dfg``: op id = canonical
    index, ops inserted in canonical order, edges sorted.

    Two isomorphic requests with equal canonical ``blob``s produce
    *bit-identical* copies — same ids, same dict insertion order, same
    edge order — so every downstream stage (scheduling tie-breaks, RNG
    draws, certificate search) behaves identically.  The serving
    scheduler maps this copy instead of the request's own labeling:
    that determinism is what makes cached negative results sound for
    any isomorphic request (`serve.cache`)."""
    out = DFG()
    for ci in range(canon.n):
        op = dfg.ops[canon.op_of[ci]]
        out.ops[ci] = dataclasses.replace(
            op, op_id=ci,
            clone_of=canon.canon_of[op.clone_of]
            if op.clone_of in canon.canon_of else -1)
    out.edges = [Edge(*t) for t in sorted(
        (canon.canon_of[e.src], canon.canon_of[e.dst], e.distance)
        for e in dfg.edges)]
    out._next_id = canon.n
    return out


# --------------------------------------------------------------- relabel
def relabel_result(res: MappingResult, id_map: dict[int, int]
                   ) -> MappingResult:
    """Relabel a mapping result's op ids through ``id_map``.

    ``id_map`` must cover the ops of the *request* DFG the result was
    produced for; ops the scheduler added on top (VIO clones, routing
    ops) are assigned fresh ids past ``max(id_map.values())``, in sorted
    source-id order, so the relabeling is deterministic.  Everything op-
    keyed is remapped: the scheduled DFG (ops, clone groups, edges),
    schedule times, delivery modes, allocated ports, the placement (and
    each `Vertex.op`).  The stale `report` is dropped — the cache
    revalidates every replayed placement (`serve.cache` docstring)."""
    assert len(set(id_map.values())) == len(id_map), "id_map not injective"
    if res.sched is None:
        return dataclasses.replace(
            res, placement={}, report=None,
            ports_per_vio={id_map.get(k, k): v
                           for k, v in res.ports_per_vio.items()})
    full = dict(id_map)
    nxt = max(full.values(), default=-1) + 1
    for oid in sorted(res.sched.dfg.ops):
        if oid not in full:
            full[oid] = nxt
            nxt += 1
    d = DFG()
    for oid in sorted(res.sched.dfg.ops, key=lambda o: full[o]):
        op = res.sched.dfg.ops[oid]
        d.ops[full[oid]] = dataclasses.replace(
            op, op_id=full[oid],
            clone_of=full[op.clone_of] if op.clone_of >= 0 else -1)
    d.edges = [Edge(full[e.src], full[e.dst], e.distance)
               for e in res.sched.dfg.edges]
    d._next_id = nxt
    sched = ScheduledDFG(
        d, res.sched.ii, res.sched.mii,
        {full[k]: v for k, v in res.sched.time.items()},
        {full[k]: v for k, v in res.sched.delivery.items()},
        {full[k]: v for k, v in res.sched.ports_allocated.items()})
    placement = {full[k]: dataclasses.replace(v, op=full[k])
                 for k, v in res.placement.items()}
    return dataclasses.replace(
        res, sched=sched, placement=placement, report=None,
        ports_per_vio={full[k]: v for k, v in res.ports_per_vio.items()})
