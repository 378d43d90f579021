"""Phase 3a: the mixed tuple/quadruple resource-occupation conflict graph
CG(V_C, E_C) (paper §III-B).

Vertices are *placement candidates*:

- tuples  (port_n^t, op_s^t)  for virtual ops: every (VIO, IPORT) and
  (VOO, OPORT) combination at the op's scheduled modulo slot;
- quadruples (pe_{i,j}^t, op_r^t, bus_{i,x}^t, bus_{j,y}^t) for computing and
  routing ops: every PE position (and, for routing ops, the bus scope the op
  re-drives: its row or its column).

Edges = resource-occupation conflicts, the paper's three rules:

1. tuple–tuple: two virtual ops on one port at the same modulo time, or one
   op on two ports (we encode the latter as the universal "same op twice"
   rule, which also makes MIS pick exactly one candidate per op; VIO clones
   created by bandwidth allocation are distinct ops, so multi-port binding
   stays conflict-free — exactly Fig. 2(c)(e));
2. tuple–quadruple: the port's hardwired bus is simultaneously re-driven for
   bus routing by a routing op, or the PE consuming (producing) the tuple's
   datum is not attached to a bus the port drives (row mismatch for VIOs,
   column mismatch for VOOs);
3. quadruple–quadruple: two ops on one PE instance, one op on two PEs, bus
   driver clashes, or an unroutable dependency (producer/consumer neither
   co-located nor sharing a row/column).

Flexible bus-index assignment (which of the two row/column buses carries a
PE→PE transfer, and in which cycle) is resolved after MIS by the validator
(`validate.py`) — a pairwise conflict graph cannot express those capacity-2
constraints exactly; the paper's phase-4 retry loop covers the same gap.

`bus_pressure_edges` (flag-gated in :func:`build_conflict_graph`, enabled
by the `bandmap.map_dfg` pipeline) folds the *provable* part of that
validator structure back into the pairwise graph: schedule-level facts pin
some bus cells as occupied in **every** complete placement (all input
ports bus-driven at a slot ⇒ every IBUS_r bus 0 taken; all output ports
exporting at a slot ⇒ every OBUS_c bus 0 taken), and a routing op with a
consumer scheduled in its own modulo slot can never co-locate with that
consumer, so it must drive its bus within a schedule-fixed window.  When
the surviving (bus, cycle) cells for such a forced drive are exhausted or
collapse to a single cell contested by another forced driver, the
corresponding pair is infeasible in every complete placement and becomes a
regular conflict edge — SBTS stops proposing placements `_assign_buses`
is guaranteed to reject, without ever excluding a validatable placement.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bitset import BitsetGraph
from .cgra import CGRAConfig
from .dfg import OpKind
from .schedule import ScheduledDFG
from .tec import COL, ROW

TIN, TOUT, QUAD = "tin", "tout", "quad"


@dataclasses.dataclass(frozen=True)
class Vertex:
    idx: int
    op: int
    kind: str                      # tin | tout | quad
    t: int                         # scheduled time
    m: int                         # modulo slot
    port: int = -1                 # tin: row; tout: col
    mode: str = ""                 # tin: 'bus' | 'grf'
    pe: tuple[int, int] = (-1, -1)
    drive: tuple[str, int] | None = None  # routing ops: (ROW,r) or (COL,c)


@dataclasses.dataclass
class ConflictGraph:
    vertices: list[Vertex]
    bits: BitsetGraph              # packed adjacency, uint64 [n, words]
    op_vertices: dict[int, list[int]]
    n_ops: int
    _adj: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _u8_cache: np.ndarray | None = dataclasses.field(default=None,
                                                     repr=False)

    @property
    def n(self) -> int:
        return len(self.vertices)

    @property
    def n_edges(self) -> int:
        return self.bits.n_edges

    @property
    def adj(self) -> np.ndarray:
        """Dense bool view, materialised on first use (oracle/debug paths
        only — the solver operates on ``bits``)."""
        if self._adj is None:
            self._adj = self.bits.to_dense()
        return self._adj

    @property
    def op_of(self) -> np.ndarray:
        """Vertex -> op id, ``int64 [n]`` (what the portfolio's group
        moves and the repair pass key their clusters on)."""
        return np.fromiter((v.op for v in self.vertices),
                           dtype=np.int64, count=self.n)

    def row_cache(self, limit: int | None = None) -> np.ndarray | None:
        """Memoized unpacked 0/1 adjacency ``uint8 [n, n]``, shared by
        the certificate search, every portfolio construction and the
        repair retries over this graph — one unpackbits per conflict
        graph instead of one per consumer (the PR 8-traced
        portfolio-init hotspot on 16x16 fabrics).  Returns None when
        the dense cache would exceed ``limit`` bytes (pass the
        engine's ``row_cache_limit``); ``limit=None`` always
        materialises."""
        if self._u8_cache is None:
            if limit is not None and not 0 < self.n * self.n <= limit:
                return None
            self._u8_cache = self.bits.rows_u8(np.arange(self.n))
        return self._u8_cache


def _occupancy(v: Vertex, ii: int) -> list[tuple]:
    """Unconditional resource instances occupied by a candidate."""
    occ: list[tuple] = []
    if v.kind == TIN:
        occ.append(("iport", v.port, v.m))
        if v.mode == "bus":
            # IPORT_r drives IBUS_r = (ROW, r, 0) at the delivery slot.
            occ.append(("bus", ROW, v.port, 0, v.m))
    elif v.kind == TOUT:
        occ.append(("oport", v.port, v.m))
        # The export drive occupies OBUS_c = (COL, c, 0) at the VOO's slot.
        occ.append(("bus", COL, v.port, 0, v.m))
    else:
        occ.append(("pe", v.pe, v.m))
    return occ


def _dep_ok(prod: Vertex, cons: Vertex) -> bool:
    """Relational realizability of DFG edge prod.op -> cons.op under the two
    placements (single-hop; multi-hop paths exist only through explicit
    routing ops)."""
    if prod.kind == TIN:
        if prod.mode == "grf":
            return True  # GRF is readable by all PEs
        # Bus delivery: the consumer PE must sit on the port's row.
        return cons.pe[0] == prod.port
    if cons.kind == TOUT:
        # Producer drives OBUS_c: must sit on the OPORT's column.
        return prod.pe[1] == cons.port
    # quad -> quad
    if prod.drive is not None:
        scope, idx = prod.drive
        if scope == ROW:
            return cons.pe == prod.pe or cons.pe[0] == idx
        return cons.pe == prod.pe or cons.pe[1] == idx
    # plain compute producer: same PE (LRF), same row or same column (bus).
    return (cons.pe == prod.pe or cons.pe[0] == prod.pe[0]
            or cons.pe[1] == prod.pe[1])


def build_conflict_graph(sched: ScheduledDFG, cgra: CGRAConfig,
                         use_kernel: bool | str = False,
                         bus_pressure: bool = False,
                         tracer=None, device=None) -> ConflictGraph:
    """Build the mixed conflict graph.  With ``bus_pressure=False``
    (default) the adjacency is byte-identical to the seed formulation
    (`dense_conflicts_python` + `_dep_ok`); ``bus_pressure=True``
    additionally folds the provable bus-capacity structure in via
    :func:`bus_pressure_edges` (the pipeline default — see map_dfg).

    ``use_kernel`` selects the occupancy/clique formulation: False =
    packed bitset rows on the host (default, and what `map_dfg` uses),
    True = the dense-bool numpy oracle then `BitsetGraph.from_dense`,
    "packed" = the oracle then the pack, "packed-cuda" = the packed-word
    CUDA kernel (`kernels.conflict_matrix`) on ``device`` (default None,
    meaning ``cuda``), whose int32 words are viewed as the uint64 rows
    `BitsetGraph` holds — no python pack step; it raises where there is
    no GPU.  The reference's "packed-pallas" raises ValueError naming
    "packed-cuda": there is no silent alias.  ``device`` is read by the
    "packed-cuda" route only.

    ``tracer`` (default None) records the build as a "conflict-build"
    span; the edge popcount for the span attrs is only paid on a live
    tracer."""
    from repro_torch.obs.trace import live
    with live(tracer).span("conflict-build", ii=sched.ii) as sp:
        cg = _build_conflict_graph(sched, cgra, use_kernel, bus_pressure,
                                   device)
        if tracer is not None:
            sp.set(n_vertices=cg.n,
                   n_edges=int(np.bitwise_count(cg.bits.rows).sum()) // 2)
        return cg


def _build_conflict_graph(sched: ScheduledDFG, cgra: CGRAConfig,
                          use_kernel: bool | str = False,
                          bus_pressure: bool = False,
                          device=None) -> ConflictGraph:
    dfg, ii = sched.dfg, sched.ii
    vertices: list[Vertex] = []
    op_vertices: dict[int, list[int]] = {}

    def add(v: Vertex) -> None:
        op_vertices.setdefault(v.op, []).append(v.idx)
        vertices.append(v)

    for oid, op in dfg.ops.items():
        t = sched.time[oid]
        m = t % ii
        if op.kind == OpKind.VIN:
            mode = sched.delivery.get(oid, "bus")
            for r in range(cgra.rows):
                add(Vertex(len(vertices), oid, TIN, t, m, port=r, mode=mode))
        elif op.kind == OpKind.VOUT:
            for c in range(cgra.cols):
                add(Vertex(len(vertices), oid, TOUT, t, m, port=c))
        elif op.kind == OpKind.ROUTE:
            for r in range(cgra.rows):
                for c in range(cgra.cols):
                    add(Vertex(len(vertices), oid, QUAD, t, m, pe=(r, c),
                               drive=(ROW, r)))
                    add(Vertex(len(vertices), oid, QUAD, t, m, pe=(r, c),
                               drive=(COL, c)))
        else:
            for r in range(cgra.rows):
                for c in range(cgra.cols):
                    add(Vertex(len(vertices), oid, QUAD, t, m, pe=(r, c)))

    # Group part (per-op cliques + occupancy clashes), emitted as packed
    # bitset rows directly: each group is one row-OR of its member mask,
    # never touching an n² bool matrix.  `dense_conflicts_python` below is
    # kept as the loop oracle for the equivalence tests; the conflict-
    # matrix kernels (kernels/conflict_matrix, CUDA) are the device
    # formulation of the same rules, held byte-equal to this build in
    # tests/test_torch_conflict_matrix.py and chip_smoke.py.
    if use_kernel == "packed-pallas":
        raise ValueError(
            "build_conflict_graph(use_kernel='packed-pallas'): the port "
            "has no Pallas kernel; its packed-word kernel is "
            "use_kernel='packed-cuda'")
    if use_kernel in ("packed", "packed-cuda"):
        from repro_torch.kernels.conflict_matrix.ops import \
            conflict_matrix_packed
        bits = BitsetGraph(len(vertices))
        bits.rows = conflict_matrix_packed(
            vertices, use_cuda=use_kernel == "packed-cuda", device=device)
    elif use_kernel:
        from repro_torch.kernels.conflict_matrix.ops import conflict_matrix
        bits = BitsetGraph.from_dense(
            np.asarray(conflict_matrix(vertices, use_cuda=False)))
    else:
        bits = bitset_group_conflicts(vertices, op_vertices, ii)

    # Routing ops re-driving IBUS_r clash with any port tuple on IBUS_r at
    # the same slot (edge rule 2, first clause).  A route with drive (ROW, r)
    # *may* use either row bus; only the pairing with (ROW, r, 0) while the
    # port tuple holds it is forbidden when the route's row routing bus is
    # also taken — that capacity split is validated post-MIS.  Here we only
    # forbid the guaranteed clash: two routing ops driving the same scope at
    # the same slot PLUS a port tuple would exceed the two buses; pairwise we
    # encode the port-vs-route clash only when both demand the same single
    # remaining bus, which cannot be decided pairwise — so it is left to the
    # validator by design.

    # Dependency realizability (rules 2b and 3b), vectorised per DFG edge
    # over the producer x consumer candidate block.
    _add_dep_conflicts(bits, vertices, op_vertices, dfg)

    if bus_pressure:
        bus_pressure_edges(bits, vertices, op_vertices, sched, cgra)

    return ConflictGraph(vertices, bits, op_vertices, len(dfg.ops))


def _forced_drive_slots(sched, oid: int, m: int) -> list[int] | None:
    """Modulo slots available to the mandatory bus drive of routing op
    ``oid`` (scheduled in slot ``m``), or ``None`` when no drive is
    provably required.

    A consumer scheduled in the same modulo slot can never share the
    route's PE (PE-instance occupancy), and routed producers reach
    non-co-located consumers only over their driven bus (no neighbour
    link), so at least one drive is forced.  Per-edge drive windows are
    schedule-fixed ([ready, use] clipped to one II) and all start at the
    route's ready cycle, so the nested windows always share a stab cycle:
    one broadcast drive inside the intersection serves every forced
    listener — the forced demand is exactly one drive in the slots of
    ``[t_ready, min over forced edges of window-end]``."""
    dfg, ii = sched.dfg, sched.ii
    t_ready = sched.time[oid] + dfg.ops[oid].latency
    hi = None
    for e in dfg.out_edges(oid):
        if dfg.ops[e.dst].kind == OpKind.VOUT:
            continue  # exports ride the VOO's own fixed OBUS drive
        t_use = sched.time[e.dst] + e.distance * ii
        if t_use % ii != m or t_use < t_ready:
            continue
        end = min(t_use, t_ready + ii - 1)
        hi = end if hi is None else min(hi, end)
    if hi is None:
        return None
    return sorted({t % ii for t in range(t_ready, hi + 1)})


def bus_pressure_edges(bits: BitsetGraph, vertices, op_vertices,
                       sched: ScheduledDFG, cgra: CGRAConfig) -> int:
    """Fold the provable bus-capacity structure into the pairwise graph.

    Every added edge is *sound with respect to complete placements*: if
    both endpoints are selected and every op receives some placement, the
    validator's `_assign_buses` is guaranteed to fail.  Three ingredients:

    1. **Saturated cells.**  If every input port at slot ``m`` carries a
       bus-mode VIO, the ports cover all rows, so every ``(ROW, r, 0, m)``
       cell is driven in any complete placement; likewise all VOO exports
       at a slot saturate ``(COL, c, 0, m)`` for every column.
    2. **Forced drives.**  A routing-op vertex whose op has a consumer in
       its own modulo slot must place one broadcast drive in a
       schedule-fixed window (see `_forced_drive_slots`).
    3. **Cell exhaustion.**  Subtracting (1) from a forced drive's
       ``buses_per_scope × window`` cell grid leaves its feasible cells.
       No cell left ⇒ the route vertex is infeasible against *every*
       candidate of its same-slot consumers (they can never co-locate).
       Exactly one cell left ⇒ two such vertices of different ops pinned
       to the same cell (or a port tuple hard-wired to it) are mutually
       exclusive — drives of distinct producers never share a
       (bus, cycle).

    Returns the number of vertex pairs added (0 when the schedule has no
    provable pressure — the common case on loose instances, where the
    graph stays byte-identical to the oracle rules).
    """
    dfg, ii = sched.dfg, sched.ii
    n_buses = cgra.buses_per_scope

    # --- 1. schedule-level saturation of the hardwired bus-0 cells ----
    vin_bus = [0] * ii
    vout = [0] * ii
    for oid, op in dfg.ops.items():
        m = sched.time[oid] % ii
        if op.kind == OpKind.VIN and sched.delivery.get(oid, "bus") == "bus":
            vin_bus[m] += 1
        elif op.kind == OpKind.VOUT:
            vout[m] += 1
    sat = {ROW: [vin_bus[m] >= cgra.rows for m in range(ii)],
           COL: [vout[m] >= cgra.cols for m in range(ii)]}

    # --- 2. forced drives per routing op --------------------------------
    forced_slots: dict[int, list[int]] = {}
    forced_consumers: dict[int, list[int]] = {}
    for oid, op in dfg.ops.items():
        if op.kind != OpKind.ROUTE:
            continue
        m = sched.time[oid] % ii
        slots = _forced_drive_slots(sched, oid, m)
        if slots is None:
            continue
        forced_slots[oid] = slots
        forced_consumers[oid] = [
            e.dst for e in dfg.out_edges(oid)
            if dfg.ops[e.dst].kind != OpKind.VOUT
            and (sched.time[e.dst] + e.distance * ii) % ii == m]

    # --- 3. cell exhaustion ---------------------------------------------
    n_pairs = 0
    pinned: dict[tuple, list[int]] = {}   # (scope, idx, bus, slot) -> verts
    dead: list[tuple[int, int]] = []      # (vertex, doomed consumer op)
    for oid, slots in forced_slots.items():
        for vi in op_vertices[oid]:
            v = vertices[vi]
            if v.drive is None:
                continue
            scope, idx = v.drive
            cells = [(k, s) for k in range(n_buses) for s in slots
                     if not (k == 0 and sat[scope][s])]
            if not cells:
                dead.extend((vi, c) for c in forced_consumers[oid])
            elif len(cells) == 1:
                k, s = cells[0]
                pinned.setdefault((scope, idx, k, s), []).append(vi)

    if dead:
        src = []
        dst = []
        for vi, cons_op in dead:
            for wj in op_vertices[cons_op]:
                src.append(vi)
                dst.append(wj)
        bits.add_edges(np.asarray(src), np.asarray(dst))
        n_pairs += len(src)

    # Port tuples hard-wired to a contested cell (only reachable when
    # buses_per_scope == 1, but kept general).
    fixed_cell: dict[tuple, list[int]] = {}
    for v in vertices:
        if v.kind == TIN and v.mode == "bus":
            fixed_cell.setdefault((ROW, v.port, 0, v.m), []).append(v.idx)
        elif v.kind == TOUT:
            fixed_cell.setdefault((COL, v.port, 0, v.m), []).append(v.idx)

    cliques = []
    for cell, vis in pinned.items():
        group = vis + fixed_cell.get(cell, [])
        ops_in = {vertices[i].op for i in group}
        if len(ops_in) > 1:
            cliques.append(group)
            n_pairs += len(group) * (len(group) - 1) // 2
    for group in cliques:
        bits.add_clique(group)
    if cliques:
        bits.clear_diagonal()
    return n_pairs


def bitset_group_conflicts(vertices, op_vertices, ii: int) -> BitsetGraph:
    """Per-op cliques + resource-occupancy cliques as packed rows.

    Occupancy groups include same-op pairs that `dense_conflicts_python`
    skips, but those pairs are already edges of the op's clique, so the
    union is byte-identical to the oracle.
    """
    g = BitsetGraph(len(vertices))
    for ids in op_vertices.values():
        g.add_clique(ids)
    by_res: dict[tuple, list[int]] = {}
    for v in vertices:
        for res in _occupancy(v, ii):
            by_res.setdefault(res, []).append(v.idx)
    for ids in by_res.values():
        g.add_clique(ids)
    g.clear_diagonal()
    return g


def _vertex_attrs(vertices) -> dict[str, np.ndarray]:
    """Columnar vertex attributes for the vectorised `_dep_ok` block."""
    n = len(vertices)
    kind = np.empty(n, np.int8)        # 0 = tin, 1 = tout, 2 = quad
    port = np.empty(n, np.int32)
    grf = np.empty(n, bool)
    pe_r = np.empty(n, np.int32)
    pe_c = np.empty(n, np.int32)
    drv = np.empty(n, np.int8)         # -1 = none, 0 = ROW, 1 = COL
    drv_idx = np.empty(n, np.int32)
    code = {TIN: 0, TOUT: 1, QUAD: 2}
    for i, v in enumerate(vertices):
        kind[i] = code[v.kind]
        port[i] = v.port
        grf[i] = v.mode == "grf"
        pe_r[i], pe_c[i] = v.pe
        if v.drive is None:
            drv[i], drv_idx[i] = -1, -1
        else:
            drv[i] = 0 if v.drive[0] == ROW else 1
            drv_idx[i] = v.drive[1]
    return dict(kind=kind, port=port, grf=grf, pe_r=pe_r, pe_c=pe_c,
                drv=drv, drv_idx=drv_idx)


def _dep_ok_block(at: dict[str, np.ndarray], prod: np.ndarray,
                  cons: np.ndarray) -> np.ndarray:
    """Vectorised `_dep_ok` over the |prod| x |cons| candidate block."""
    pi = {k: v[prod][:, None] for k, v in at.items()}
    cj = {k: v[cons][None, :] for k, v in at.items()}
    same_pe = (pi["pe_r"] == cj["pe_r"]) & (pi["pe_c"] == cj["pe_c"])
    drive_ok = same_pe | np.where(pi["drv"] == 0,
                                  cj["pe_r"] == pi["drv_idx"],
                                  cj["pe_c"] == pi["drv_idx"])
    plain_ok = (pi["pe_r"] == cj["pe_r"]) | (pi["pe_c"] == cj["pe_c"])
    quad_ok = np.where(pi["drv"] >= 0, drive_ok, plain_ok)
    tin_ok = pi["grf"] | (cj["pe_r"] == pi["port"])
    tout_ok = pi["pe_c"] == cj["port"]
    return np.where(pi["kind"] == 0, tin_ok,
                    np.where(cj["kind"] == 1, tout_ok, quad_ok))


def _add_dep_conflicts(bits: BitsetGraph, vertices, op_vertices,
                       dfg) -> None:
    at = _vertex_attrs(vertices)
    dep_pairs = {(e.src, e.dst) for e in dfg.edges}
    for src, dst in dep_pairs:
        prod = np.asarray(op_vertices[src], dtype=np.int64)
        cons = np.asarray(op_vertices[dst], dtype=np.int64)
        bad_i, bad_j = np.nonzero(~_dep_ok_block(at, prod, cons))
        if bad_i.size:
            bits.add_edges(prod[bad_i], cons[bad_j])


def dense_conflicts_python(vertices, op_vertices, ii: int) -> np.ndarray:
    """Reference python-loop formulation of the dense conflict rules
    (per-op cliques + occupancy) — oracle for the bitset/kernel
    equivalence tests; build_conflict_graph emits packed bitset rows."""
    n = len(vertices)
    adj = np.zeros((n, n), dtype=bool)

    def connect(i, j):
        adj[i, j] = True
        adj[j, i] = True

    for ids in op_vertices.values():
        for a in range(len(ids)):
            for b in range(a + 1, len(ids)):
                connect(ids[a], ids[b])
    by_res: dict[tuple, list[int]] = {}
    for v in vertices:
        for res in _occupancy(v, ii):
            by_res.setdefault(res, []).append(v.idx)
    for ids in by_res.values():
        for a in range(len(ids)):
            va = vertices[ids[a]]
            for b in range(a + 1, len(ids)):
                vb = vertices[ids[b]]
                if va.op != vb.op:
                    connect(ids[a], ids[b])
    return adj


def constructive_init(cg: ConflictGraph, sched: ScheduledDFG,
                      cgra: CGRAConfig, seed: int = 0) -> np.ndarray:
    """Structure-aware greedy placement used to warm-start SBTS.

    Ops are placed in scheduled-time order (VIOs before same-time compute).
    Quad candidates are scored by affinity to already-placed predecessors
    AND successors: same PE (LRF forward) > NSEW neighbour (dedicated link)
    > same column > same row (bus hop, capacity-limited) > disconnected.
    VIO rows are scored by how well their consumers can extend the placed
    chain predecessors (adjacent rows preferred).  Only conflict-free picks
    are kept, so the result is an independent set SBTS can repair/extend.
    """
    rng = np.random.default_rng(seed)
    dfg = sched.dfg
    in_s = np.zeros(cg.n, dtype=bool)
    conf = np.zeros(cg.n, dtype=np.int64)
    placed: dict[int, Vertex] = {}

    def pe_affinity(v_pe, o_pe) -> float:
        if v_pe == o_pe:
            return 0.0
        dr, dc = abs(v_pe[0] - o_pe[0]), abs(v_pe[1] - o_pe[1])
        if dr + dc == 1:
            return 0.5                       # neighbour link, bus-free
        if dc == 0:
            return 1.0                       # column bus
        if dr == 0:
            return 2.0                       # row bus
        return 4.0

    def bias_for(oid: int):
        nbrs = [placed[p] for p in
                (dfg.predecessors(oid) + dfg.successors(oid)) if p in placed]
        quads = [p for p in nbrs if p.kind == QUAD]
        kind = dfg.ops[oid].kind

        def bias(v: Vertex) -> float:
            if v.kind == TIN:
                # Row scored by adjacency of the VIO's consumers' chain
                # predecessors: a consumer extending a chain at row r wants
                # delivery on r (same PE/LRF) or r±1 (neighbour link).
                score = 0.0
                for c in dfg.successors(oid):
                    best = 0.5
                    for p in dfg.predecessors(c):
                        if p != oid and p in placed and \
                                placed[p].kind == QUAD:
                            d = abs(placed[p].pe[0] - v.port)
                            best = min(best, 0.0 if d <= 1 else float(d))
                    score += best
                return score
            if v.kind == TOUT:
                # Column forced to the producer by _dep_ok; neutral here.
                return 0.0
            if not quads:
                return 0.0
            return sum(pe_affinity(v.pe, p.pe) for p in quads) / len(quads)
        return bias

    order = sorted(dfg.ops, key=lambda o: (sched.time[o],
                                           dfg.ops[o].kind != OpKind.VIN))
    for oid in order:
        cands = [i for i in cg.op_vertices[oid] if conf[i] == 0]
        if not cands:
            continue
        bias = bias_for(oid)
        scored = [bias(cg.vertices[i]) + 1e-3 * rng.random() for i in cands]
        best = cands[int(np.argmin(scored))]
        in_s[best] = True
        conf += cg.bits.row_u8(best)
        placed[oid] = cg.vertices[best]
    return in_s
