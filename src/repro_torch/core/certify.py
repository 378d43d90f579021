"""Cheap II-infeasibility certificates for the binding phase.

Before `bandmap.map_dfg` spends a full portfolio budget (K seeds × 20k
SBTS iterations × repair retries) on one (II, jitter) schedule, this
module tries to *prove* that no complete binding exists, in three stages
of increasing strength (and cost):

1. **Resource-slot counting** — per modulo slot, the number of ops whose
   every candidate occupies one resource class (PE / IPORT / OPORT
   instances) against the class capacity.  Pure arithmetic over the
   schedule; catches over-packed hand-built schedules in microseconds.
2. **Greedy clique extension** — each op's candidate set is a clique; its
   greedy extension is the set of vertices adjacent to *every* candidate
   (one AND-reduction over the packed adjacency rows).  If another op's
   whole candidate set lies inside that extension, the two op-cliques
   merge: a clique cover of the vertex set with fewer cliques than ops,
   so MIS < |ops| and the schedule is unbindable.  Vectorised over the
   ``uint64 [n, words]`` rows; milliseconds.
3. **Bounded exhaustive search** — exact CSP over (op → candidate) with
   most-constrained-op ordering and forward checking through the unpacked
   row cache.  Exhausting the space *is* the certificate: no complete
   independent placement exists.  The node budget keeps the worst case
   bounded; past it the result is "unknown", never a false certificate.
   The search runs in two phases: a cheap plain pass with a small node
   budget (feasible schedules usually resolve in tens of nodes), then —
   only on escalation — a symmetry-pruned pass that branches solely on
   orbit representatives: the homogeneous PEA makes the conflict graph
   invariant under row and column permutations, so candidates
   referencing only so-far-unused rows/columns are interchangeable
   under the stabilizer of the partial assignment.  That invariance is
   *verified* before use (every row/column transposition generator is
   checked against the unpacked adjacency; graphs that fail — e.g. a
   future heterogeneous PEA — silently fall back to the exact
   non-symmetric search), so the pruning can never manufacture a false
   certificate.  It is what turns the BusMap II=MII exhaustions from
   ~10^5 nodes into a few hundred.  Graphs past the engine's
   ROW_CACHE_LIMIT skip the unpacked cache (per-move row unpack, no
   symmetry) rather than materialising n^2 bytes.

What a certificate proves — and what it does not
------------------------------------------------
A certificate is a proof that **this scheduled DFG** (one II, one jitter,
one routing-op pre-allocation) admits no complete conflict-free binding
under the pairwise conflict rules the graph encodes (including the
bus-pressure edges when the caller built the graph with them — those are
themselves sound for complete placements, see `conflict.py`).  It is NOT
a proof that the II itself is infeasible for the kernel: a different
schedule at the same II (other jitter, other routing split) may bind, and
`map_dfg` accordingly skips only the certified (II, jitter) combination.
The converse also does not hold: stage-3 *finding* a complete placement
does not certify the II feasible — the validator may still reject it on
the capacity structure a pairwise graph cannot express (flexible
bus-instance packing, LRF/GRF residency), in which case the portfolio
search proceeds exactly as before.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from repro_torch.obs.trace import live

from .cgra import CGRAConfig
from .conflict import QUAD, TIN, TOUT, ConflictGraph
from .dfg import OpKind
from .mis import ROW_CACHE_LIMIT
from .schedule import ScheduledDFG

# Node budget of the plain first pass; symmetry verification (an
# O((rows+cols) * n^2) check) is paid only when a schedule survives it.
_PLAIN_NODES_FIRST = 4096


@dataclasses.dataclass(frozen=True)
class IICertificate:
    """Witness that one (II, jitter) schedule admits no complete binding."""
    ii: int
    jitter: int
    # 'resource-count' | 'clique-merge' | 'exhausted', plus
    # 'static-demand' for the schedule-free pre-pass bounds
    # (`repro.analysis`): those carry jitter=-1, meaning the claim
    # covers every jitter of the II at once.
    stage: str
    detail: str      # human-readable witness
    nodes: int       # stage-3 search nodes spent (0 for stages 1-2)
    wall_s: float

    def summary(self) -> str:
        return (f"II={self.ii} jitter={self.jitter} infeasible "
                f"[{self.stage}] {self.detail} "
                f"({self.nodes} nodes, {self.wall_s * 1e3:.1f} ms)")


def _resource_count_bound(sched: ScheduledDFG,
                          cgra: CGRAConfig) -> str | None:
    """Stage 1: per-slot op counts vs resource-class capacity."""
    ii = sched.ii
    classes = {OpKind.COMPUTE: "pe", OpKind.ROUTE: "pe",
               OpKind.VIN: "iport", OpKind.VOUT: "oport"}
    caps = {"pe": cgra.n_pes, "iport": cgra.n_iports,
            "oport": cgra.n_oports}
    counts: dict[tuple, int] = {}
    for oid, op in sched.dfg.ops.items():
        key = (classes[op.kind], sched.time[oid] % ii)
        counts[key] = counts.get(key, 0) + 1
    for (cls, m), c in counts.items():
        if c > caps[cls]:
            return f"{c} ops need {caps[cls]} {cls} instances at slot {m}"
    return None


def _clique_merge_bound(cg: ConflictGraph) -> str | None:
    """Stage 2: greedy clique extension over packed rows — two ops whose
    candidate cliques merge into one clique can never both be placed."""
    ops = sorted(cg.op_vertices)
    k = len(ops)
    if k < 2 or cg.n == 0:
        return None
    words = cg.bits.words
    ext = np.empty((k, words), dtype=np.uint64)   # adj to ALL candidates
    dom = np.zeros((k, words), dtype=np.uint64)   # candidate bitset
    for i, o in enumerate(ops):
        ids = np.asarray(cg.op_vertices[o], dtype=np.int64)
        if ids.size == 0:
            return f"op {o} has no candidates"
        ext[i] = np.bitwise_and.reduce(cg.bits.rows[ids], axis=0)
        np.bitwise_or.at(dom[i], ids >> 6,
                         np.uint64(1) << (ids & 63).astype(np.uint64))
    # ops i, j merge iff dom[j] ⊆ ext[i]: every candidate of j conflicts
    # with every candidate of i.  One [k, k, words] broadcast.
    outside = (dom[None, :, :] & ~ext[:, None, :]).any(axis=2)
    np.fill_diagonal(outside, True)
    hit = np.argwhere(~outside)
    if hit.size:
        i, j = hit[0]
        return (f"ops {ops[int(i)]} and {ops[int(j)]} are mutually "
                f"exclusive (their candidate cliques merge)")
    return None


def _vertex_key(v) -> tuple:
    return (v.op, v.kind, v.port, v.mode, v.pe, v.drive)


def _axis_swap_perm(vertices, axis: str, a: int, b: int) -> np.ndarray | None:
    """Vertex permutation induced by swapping rows (axis='row') or
    columns (axis='col') ``a`` and ``b`` of the PEA, or None when some
    vertex has no image (a non-uniform candidate set)."""
    from .tec import COL, ROW

    def sw(x):
        return b if x == a else a if x == b else x

    index = {_vertex_key(v): v.idx for v in vertices}
    perm = np.empty(len(vertices), dtype=np.int64)
    for v in vertices:
        port, pe, drive = v.port, v.pe, v.drive
        if axis == "row":
            if v.kind == TIN:
                port = sw(port)
            if v.kind == QUAD:
                pe = (sw(pe[0]), pe[1])
                if drive is not None and drive[0] == ROW:
                    drive = (ROW, sw(drive[1]))
        else:
            if v.kind == TOUT:
                port = sw(port)
            if v.kind == QUAD:
                pe = (pe[0], sw(pe[1]))
                if drive is not None and drive[0] == COL:
                    drive = (COL, sw(drive[1]))
        img = index.get((v.op, v.kind, port, v.mode, pe, drive))
        if img is None:
            return None
        perm[v.idx] = img
    return perm


def _symmetry_attrs(cg: ConflictGraph, cgra: CGRAConfig | None,
                    u8: np.ndarray) -> tuple | None:
    """Row/column references per vertex, iff the graph is verified
    invariant under every row/column transposition generator."""
    vertices = getattr(cg, "vertices", None)
    if vertices is None or cgra is None:
        return None
    from .tec import ROW
    for axis, count in (("row", cgra.rows), ("col", cgra.cols)):
        for x in range(1, count):
            perm = _axis_swap_perm(vertices, axis, 0, x)
            if perm is None or not (u8[perm][:, perm] == u8).all():
                return None
    n = cg.n
    vrow = np.full(n, -1, dtype=np.int64)
    vcol = np.full(n, -1, dtype=np.int64)
    vdrv = np.full(n, -1, dtype=np.int64)
    for v in vertices:
        if v.kind == TIN:
            vrow[v.idx] = v.port
        elif v.kind == TOUT:
            vcol[v.idx] = v.port
        else:
            vrow[v.idx], vcol[v.idx] = v.pe
            if v.drive is not None:
                vdrv[v.idx] = 0 if v.drive[0] == ROW else 1
    return vrow, vcol, vdrv


def _search_complete(cg: ConflictGraph, node_budget: int,
                     row_cache: np.ndarray | None = None,
                     cgra: CGRAConfig | None = None,
                     n_solutions: int = 1,
                     row_cache_limit: int | None = None,
                     on_solution=None, cancel=None, tracer=None,
                     ) -> tuple[bool | None, list[np.ndarray], int]:
    """Stage 3: exact bounded CSP.  Returns (verdict, placements, nodes):
    verdict False = proven infeasible, True = ``placements`` holds up to
    ``n_solutions`` distinct complete independent placements (bool [n]
    memberships, found by continuing the backtracking past the first
    hit), None = budget exhausted before either outcome.

    Enumerating several placements is what closes the residual slow
    path in `map_dfg`: when the validator rejects the first placement's
    bus packing, the next candidates are already in hand — the search
    yields them for a few extra nodes — instead of falling back to the
    full portfolio.

    ``on_solution`` turns the enumeration into an online decision
    procedure (the exact backend's mode, `repro.exact`): each complete
    placement is handed to the callback as a bool [n] membership; a
    True return accepts it and stops the search (verdict True, the
    placement recorded), a False return discards it and the search
    *continues exhausting the space*.  Exhaustion with every placement
    discarded is verdict False: no complete conflict-free placement the
    callback accepts exists.  Under the symmetry-pruned pass that claim
    extends to the full space only when the callback is equivariant
    under the verified row/column automorphisms — `validate_mapping`
    is (it reads row/column indices only as labels, and its restart
    RNG sequence is index-independent), which is what lets the exact
    backend treat an all-rejected exhaustion as UNSAT.

    ``cancel`` (a `core.cancel.CancelToken`) is polled every 64 nodes;
    a cancelled search returns verdict None (unknown), never a proof.
    """
    n = cg.n
    ops = sorted(cg.op_vertices)
    k = len(ops)
    if k == 0:
        return True, [np.zeros(0, dtype=bool)], 0
    # Unpacked rows: share the caller's cache, or materialise one only
    # within the engine's cache bound; past it fall back to per-move
    # row unpack (O(n/8) per expansion, no n^2 allocation).  uint8 rows
    # add directly into the int16 banned stack — no widened copy.
    cache_limit = ROW_CACHE_LIMIT if row_cache_limit is None \
        else row_cache_limit
    if row_cache is not None:
        u8 = row_cache
    elif 0 < n * n <= cache_limit:
        u8 = cg.bits.rows_u8(np.arange(n))
    else:
        u8 = None

    def row(v: int) -> np.ndarray:
        return u8[v] if u8 is not None else cg.bits.row_u8(v)

    op_code = np.empty(n, dtype=np.int64)
    doms = []
    offsets = np.empty(k, dtype=np.int64)
    for i, o in enumerate(ops):
        ids = np.asarray(cg.op_vertices[o], dtype=np.int64)
        op_code[ids] = i
        doms.append(ids)
        offsets[i] = ids[0] if ids.size else 0
    # build_conflict_graph lays candidates out op-contiguously, which
    # turns the per-op alive counts into one reduceat; fall back to
    # bincount for graphs assembled differently.
    contiguous = (all(d.size and (np.diff(d) == 1).all() for d in doms)
                  and (np.diff(offsets) > 0).all() and offsets[0] == 0
                  and doms[-1][-1] == n - 1)
    # MRV tie-break: among equally small domains, expand the op whose
    # candidates are the most constraining (highest mean degree) first —
    # its contradictions surface higher in the tree.  Empirically this
    # cuts the exhaustion on the tight BusMap II=MII instances by 1-2
    # orders of magnitude versus plain MRV.
    tb = np.array([float(np.bitwise_count(cg.bits.rows[d]).sum())
                   / max(d.size, 1) for d in doms])
    tb = -0.9 * tb / (tb.max() + 1.0)
    # Orbit-pruning hits, accumulated locally (one list append per skip
    # would be tracer traffic inside the node loop; one count at the
    # end is free) and published as the `certify.orbit_skips` counter.
    orbit_skips = [0]

    def run(sym: tuple | None, budget: int,
            ) -> tuple[bool | None, list[np.ndarray], int]:
        unassigned = np.ones(k, dtype=bool)
        chosen = np.full(k, -1, dtype=np.int64)
        stack = np.zeros((k + 2, n), dtype=np.int16)
        nodes = [0]
        solutions: list[np.ndarray] = []

        def dfs(depth: int, used_rows: frozenset,
                used_cols: frozenset) -> bool | None:
            nodes[0] += 1
            if nodes[0] > budget:
                return None
            if cancel is not None and not nodes[0] & 63 \
                    and cancel.is_set():
                return None
            if not unassigned.any():
                if on_solution is not None:
                    # Online mode: accept (stop) or discard (keep
                    # exhausting) — see the docstring's UNSAT claim.
                    memb = np.zeros(n, dtype=bool)
                    memb[chosen[chosen >= 0]] = True
                    if on_solution(memb):
                        solutions.append(chosen.copy())
                        return True
                    return False
                # Complete placement: record it and keep backtracking
                # (returning False) until the requested count is in hand.
                solutions.append(chosen.copy())
                return len(solutions) >= n_solutions
            banned = stack[depth]
            alive = banned == 0
            if contiguous:
                counts = np.add.reduceat(alive,
                                         offsets).astype(np.float64)
            else:
                counts = np.bincount(op_code[alive],
                                     minlength=k).astype(np.float64)
            counts += tb
            counts[~unassigned] = np.inf
            i = int(np.argmin(counts))
            if counts[i] < 0.0:
                return False
            unassigned[i] = False
            dom = doms[i]
            seen: set = set()
            result: bool | None = False
            for v in dom[alive[dom]]:
                nur, nuc = used_rows, used_cols
                if sym is not None:
                    # Orbit representative: under the stabilizer of the
                    # partial assignment (which references only used
                    # rows/cols), all still-unused rows are
                    # interchangeable, and likewise columns — one
                    # candidate per (drive-kind, row-or-fresh,
                    # col-or-fresh) key suffices.
                    vrow, vcol, vdrv = sym
                    r_ref, c_ref = int(vrow[v]), int(vcol[v])
                    key = (int(vdrv[v]),
                           r_ref if r_ref < 0 or r_ref in used_rows
                           else -2,
                           c_ref if c_ref < 0 or c_ref in used_cols
                           else -2)
                    if key in seen:
                        orbit_skips[0] += 1
                        continue
                    seen.add(key)
                    if r_ref >= 0:
                        nur = used_rows | {r_ref}
                    if c_ref >= 0:
                        nuc = used_cols | {c_ref}
                chosen[i] = v
                np.add(banned, row(v), out=stack[depth + 1])
                r = dfs(depth + 1, nur, nuc)
                if r is None or r:
                    result = r
                    break
            else:
                chosen[i] = -1
            unassigned[i] = True
            return result

        verdict = dfs(0, frozenset(), frozenset())
        return verdict, solutions, nodes[0]

    # Phase 1: plain search under a small budget — feasible schedules
    # usually resolve here, skipping the symmetry verification cost.
    # Graphs past the row-cache bound stop here too: without the u8
    # cache every node pays an O(n) row unpack and the symmetry
    # verification (which needs the full cache) is unavailable, so a
    # six-figure node budget burns seconds per (II, jitter) with no
    # realistic chance of exhausting a |V_C| ~ 10^4 space — "unknown"
    # after the cheap pass is the honest verdict at that scale.
    budget1 = min(node_budget, _PLAIN_NODES_FIRST)
    verdict, sols, spent = run(None, budget1)
    if verdict is None and not sols and node_budget > budget1 \
            and u8 is not None:
        sym = _symmetry_attrs(cg, cgra, u8) if u8 is not None else None
        verdict, sols, spent2 = run(sym, node_budget - spent)
        spent += spent2
    placements = []
    for chosen in sols:
        p = np.zeros(n, dtype=bool)
        p[chosen[chosen >= 0]] = True
        placements.append(p)
    if placements:
        # An exhausted (False) or budget-out (None) sweep that still
        # recorded placements is a feasibility witness, not a proof.
        verdict = True
    trc = live(tracer)
    trc.count("certify.csp_nodes", spent)
    trc.count("certify.orbit_skips", orbit_skips[0])
    return verdict, placements, spent


def certify_ii_infeasible(cg: ConflictGraph, sched: ScheduledDFG,
                          cgra: CGRAConfig, *, jitter: int = 0,
                          node_budget: int = 200_000,
                          row_cache: np.ndarray | None = None,
                          n_placements: int = 1,
                          row_cache_limit: int | None = None,
                          on_solution=None, cancel=None, tracer=None,
                          ) -> tuple[IICertificate | None,
                                     list[np.ndarray] | None]:
    """Run the certificate stages against one scheduled DFG.

    Returns ``(certificate, placements)``: a certificate when the
    schedule is proven unbindable (placements is None); otherwise
    ``certificate`` is None and ``placements`` holds up to
    ``n_placements`` complete conflict-free membership vectors stage 3
    enumerated within budget for the caller to validate directly (the
    list is empty when the budget ran out before any was found).

    ``on_solution``/``cancel`` are forwarded to `_search_complete` (see
    its docstring): with a callback installed, an exhausted search whose
    every placement was discarded still certifies the schedule — the
    certificate detail records that the claim covers callback-accepted
    placements, not just conflict-free ones."""
    trc = live(tracer)
    with trc.span("certify", ii=sched.ii, jitter=jitter,
                  n_ops=len(cg.op_vertices), n_vertices=cg.n) as sp:
        t0 = _time.perf_counter()
        detail = _resource_count_bound(sched, cgra)
        if detail is not None:
            sp.set(stage="resource-count", nodes=0)
            return IICertificate(sched.ii, jitter, "resource-count",
                                 detail, 0,
                                 _time.perf_counter() - t0), None
        detail = _clique_merge_bound(cg)
        if detail is not None:
            sp.set(stage="clique-merge", nodes=0)
            return IICertificate(sched.ii, jitter, "clique-merge",
                                 detail, 0,
                                 _time.perf_counter() - t0), None
        skips0 = trc.counter_value("certify.orbit_skips")
        verdict, placements, nodes = _search_complete(
            cg, node_budget, row_cache=row_cache, cgra=cgra,
            n_solutions=n_placements, row_cache_limit=row_cache_limit,
            on_solution=on_solution, cancel=cancel, tracer=tracer)
        sp.set(nodes=nodes,
               orbit_skips=trc.counter_value("certify.orbit_skips")
               - skips0)
        if verdict is False:
            what = "validator-accepted" if on_solution is not None \
                else "complete independent"
            detail = (f"exhaustive search: no {what} placement "
                      f"of {len(cg.op_vertices)} ops over "
                      f"{cg.n} candidates")
            sp.set(stage="exhausted")
            return IICertificate(sched.ii, jitter, "exhausted", detail,
                                 nodes, _time.perf_counter() - t0), None
        sp.set(stage="open" if verdict is None else "placed")
        return None, placements
