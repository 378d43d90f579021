"""Synthetic workload generator: parameterized DFG families beyond CnKm.

Every kernel the repo shipped so far (CnKm, §IV-A) is acyclic, so the
loop-carried (distance > 0) RecMII path in `dfg.py` / `schedule.py` had no
workload exercising it, and nothing stressed the engine at 16x16-scale
candidate counts (|V_C| ~ 10^4).  This module generates seeded DFG
families that open both axes:

- **loop**    — random loop kernels with loop-carried accumulator cycles
  (distance >= 1): RecMII > 1 for tight recurrences, plus optional
  inter-iteration VIO consumers (the GRF park-window case).
- **stencil** — sliding-window kernels: ``points`` outputs, each a chain
  of ``taps`` MACs over a shared shifted input window, giving the
  non-uniform spatial-reuse profile (RD varies per VIO) the bandwidth
  allocator has to split unevenly.
- **reduction** — ``width``-wide ``arity``-ary reduction trees draining
  to one output: deep dependence chains, low reuse.
- **cnkm**    — the paper's family, included so sweeps can mix it in.

All builders are deterministic in ``seed``.  :func:`sweep_specs` yields
size sweeps up to 16x16-scale op counts; :func:`generate` builds a DFG
from a family name + params (the registry the co-mapper and benches
drive)."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from .dfg import DFG, OpKind
from .kernels_cnkm import make_cnkm


def _assert_invariants(d: DFG) -> DFG:
    """Checked form of the generator-family invariants every builder in
    this module upholds — <= 1 VIO predecessor per op, one distinct
    producer per VOO.  The rule definitions (and the why) live in one
    place, `analysis.dfglint.generator_invariant_findings`; this
    assertion and the lint pass share them verbatim."""
    from repro_torch.analysis.dfglint import generator_invariant_findings
    bad = generator_invariant_findings(d)
    assert not bad, "generator invariant violated: " + \
        "; ".join(f.summary() for f in bad)
    return d


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A named, reproducible workload: family + params."""
    name: str
    family: str
    params: dict

    def build(self) -> DFG:
        return generate(self.family, **self.params)


def make_loop_kernel(n_chains: int = 4, chain_len: int = 4,
                     n_inputs: int = 3, n_outputs: int = 2, *,
                     n_carries: int = 1, max_distance: int = 2,
                     cross_links: int = 1, vin_carry_distance: int = 0,
                     seed: int = 0) -> DFG:
    """Random loop kernel in the fabric-realizable chain shape:
    generalized CnKm with loop-carried accumulators.

    ``n_chains`` dependent chains of ``chain_len`` compute ops (a chain
    binds naturally to a column of the PEA, its levels to rows).  Each
    level draws one VIO shared by every chain at that level — the
    CnKm-style spatial reuse the bandwidth allocator splits — with the
    level→VIO assignment shuffled by ``seed``.  ``n_carries`` chains
    close a loop-carried back edge (distance 1..``max_distance``) from
    their last op to their first: RecMII = ceil(chain latency /
    distance), the recurrence shape no shipped CnKm kernel produces.
    ``cross_links`` adds stencil-style links between adjacent chains at
    a shared level.  With ``vin_carry_distance`` > 0 one VIO edge is
    rewired to that iteration distance — the inter-iteration-consumer
    case that exercises the GRF/LRF park window.

    Why chains and not a random DAG: bus delivery pins all consumers of
    a VIO (clone) to one row, and a plain producer reaches only its
    row/column — a uniformly random DAG funnels whole kernels into a
    single column where same-(row, slot) ops collide, which is
    *provably* unbindable (the certificate stages exhaust it), not just
    hard.  Chain-structured kernels with per-level reuse and sparse
    cross-links are both realistic (MAC lattices, stencils) and
    fabric-realizable.
    """
    assert n_carries <= n_chains
    rng = np.random.default_rng(seed)
    d = DFG()
    # Only chain_len levels exist to consume inputs, so more VIOs than
    # levels would leave dangling ports — clamp instead.
    n_inputs = min(n_inputs, chain_len)
    vins = [d.add_op(OpKind.VIN, f"in{i}") for i in range(n_inputs)]
    # Level -> VIO assignment: every input covered, remainder random.
    levels = list(range(n_inputs)) + [
        int(rng.integers(0, n_inputs))
        for _ in range(chain_len - n_inputs)]
    rng.shuffle(levels)

    chains = [[d.add_op(OpKind.COMPUTE, f"c{j}_{l}")
               for l in range(chain_len)] for j in range(n_chains)]
    # Level-major VIO edges keep each VIO's consumer list in chain
    # order, so a multi-port split clones contiguous chain groups.
    for l in range(chain_len):
        if l < len(levels):
            for j in range(n_chains):
                d.add_edge(vins[levels[l]], chains[j][l])
    for j in range(n_chains):
        for a, b in zip(chains[j], chains[j][1:]):
            d.add_edge(a, b)

    # Loop-carried accumulators on the first n_carries chains.
    for j in range(n_carries):
        dist = int(rng.integers(1, max_distance + 1))
        d.add_edge(chains[j][-1], chains[j][0], distance=dist)

    # Stencil-style cross links: adjacent chains at one level.
    for _ in range(cross_links):
        if n_chains < 2:
            break
        j = int(rng.integers(0, n_chains - 1))
        l = int(rng.integers(0, chain_len - 1))
        d.add_edge(chains[j][l], chains[j + 1][l + 1])

    if vin_carry_distance > 0:
        # Inter-iteration VIO consumer: rewire one VIO edge to the
        # given distance (keeping the one-VIO-pred-per-op invariant).
        vin = vins[levels[-1]] if levels else vins[-1]
        late = chains[-1][len(levels) - 1 if levels else -1]
        d.remove_edge(vin, late)
        d.add_edge(vin, late, distance=vin_carry_distance)

    # One VOO per chain end (the shared-voo-producer invariant —
    # rationale in `analysis.dfglint.generator_invariant_findings`).
    for j in range(min(n_outputs, n_chains)):
        vo = d.add_op(OpKind.VOUT, f"out{j}")
        d.add_edge(chains[j][-1], vo)
    return _assert_invariants(d)


def make_stencil(points: int = 4, taps: int = 3, *, seed: int = 0) -> DFG:
    """1-D ``taps``-point stencil over ``points`` outputs.

    out[j] = sum_k w_k * in[j + k]: a sliding window of shared VIOs, so
    interior inputs are reused by up to ``taps`` MAC chains while edge
    inputs are reused less — the non-uniform RD profile.  ``seed`` is
    accepted for registry uniformity (the shape is deterministic)."""
    del seed
    d = DFG()
    n_inputs = points + taps - 1
    vins = [d.add_op(OpKind.VIN, f"in{i}") for i in range(n_inputs)]
    vouts = []
    for j in range(points):
        prev = None
        for k in range(taps):
            mac = d.add_op(OpKind.COMPUTE, f"mac{j}_{k}")
            d.add_edge(vins[j + k], mac)
            if prev is not None:
                d.add_edge(prev, mac)
            prev = mac
        vo = d.add_op(OpKind.VOUT, f"out{j}")
        d.add_edge(prev, vo)
        vouts.append(vo)
    return _assert_invariants(d)


def make_reduction(width: int = 8, arity: int = 2, *,
                   seed: int = 0) -> DFG:
    """Map-then-reduce: ``width`` inputs, one elementwise leaf op each,
    then an ``arity``-ary tree to one output.

    The leaf layer is what makes the shape bindable on the row/column
    fabric: a leaf sits on its own VIO's row, and sibling leaves meet
    their reducer through a shared column — a *raw* tree whose reducers
    consume two VIOs directly would need both ports on one row in one
    slot, which the port fabric cannot provide."""
    del seed
    assert arity >= 2
    d = DFG()
    frontier = []
    for i in range(width):
        vin = d.add_op(OpKind.VIN, f"in{i}")
        leaf = d.add_op(OpKind.COMPUTE, f"leaf{i}")
        d.add_edge(vin, leaf)
        frontier.append(leaf)
    level = 0
    while len(frontier) > 1:
        nxt = []
        for g in range(0, len(frontier), arity):
            group = frontier[g:g + arity]
            if len(group) == 1:
                nxt.extend(group)
                continue
            red = d.add_op(OpKind.COMPUTE, f"r{level}_{g // arity}")
            for s in group:
                d.add_edge(s, red)
            nxt.append(red)
        frontier = nxt
        level += 1
    vo = d.add_op(OpKind.VOUT, "out0")
    d.add_edge(frontier[0], vo)
    return _assert_invariants(d)


def make_tightly_coupled(n_vios: int = 8, fanout: int = 8,
                         cross_links: int = 2, n_outputs: int = 2, *,
                         link_run: int = 4, seed: int = 0) -> DFG:
    """Tightly-coupled kernel: high-fan-out VIOs whose consumer groups
    are chained *across* groups — the family that stalls the (1,1)-swap
    portfolio just below full coverage (the group-move regression
    fixture).

    ``n_vios`` VIOs each feed ``fanout`` consumers (one shared datum per
    group: bus delivery pins the whole group to the VIO's row).  With
    ``n_vios × fanout`` equal to the PE count, the consumer slot is
    exactly packed, so a cold-started SBTS packs computes first — each
    group's consumers scattered over many rows — and then no VIO has a
    row candidate conflicting with fewer than ~``fanout`` placements:
    the multi-vertex local minimum the ROADMAP describes ("a VIO whose
    placed consumers span rows"), escapable by a group move but not by
    (1,1) swaps.

    ``cross_links`` of the ``fanout`` lanes additionally chain consumer
    j of group i to consumer j of group i+1 over a run of ``link_run``
    consecutive groups, forcing those lanes to share a column across
    groups (cross-row consumer pressure).  Runs are kept short so that
    any full-coverage placement stays within the per-column bus budget
    at II=2 — ``link_run - 1`` chained transfers plus one VOO export fit
    ``2 × II`` (bus, cycle) cells even when no two linked groups land on
    adjacent rows (adjacent rows ride the free NSEW neighbour links).

    ``seed`` shuffles which lanes carry the cross links and where each
    run starts; the shape is otherwise deterministic.  The family
    invariants (see `_assert_invariants`) are checked on return.
    """
    assert cross_links <= fanout
    rng = np.random.default_rng(seed)
    d = DFG()
    vins = [d.add_op(OpKind.VIN, f"in{i}") for i in range(n_vios)]
    groups = [[d.add_op(OpKind.COMPUTE, f"g{i}_{j}")
               for j in range(fanout)] for i in range(n_vios)]
    for i in range(n_vios):
        for j in range(fanout):
            d.add_edge(vins[i], groups[i][j])
    lanes = list(range(fanout))
    rng.shuffle(lanes)
    run = min(link_run, n_vios)
    for j in lanes[:cross_links]:
        i0 = int(rng.integers(0, n_vios - run + 1))
        for i in range(i0, i0 + run - 1):
            d.add_edge(groups[i][j], groups[i + 1][j])
    for j in range(min(n_outputs, fanout)):
        vo = d.add_op(OpKind.VOUT, f"out{j}")
        d.add_edge(groups[-1][j], vo)
    return _assert_invariants(d)


FAMILIES: dict[str, Callable[..., DFG]] = {
    "loop": make_loop_kernel,
    "stencil": make_stencil,
    "reduction": make_reduction,
    "cnkm": make_cnkm,
    "tight": make_tightly_coupled,
}


def generate(family: str, **params) -> DFG:
    """Build a DFG from a family name + params (registry entry point)."""
    if family not in FAMILIES:
        raise KeyError(f"unknown workload family {family!r}; "
                       f"have {sorted(FAMILIES)}")
    return FAMILIES[family](**params)


def sweep_specs(scale: str = "4x4", *, seed: int = 0) -> list[WorkloadSpec]:
    """Seeded size sweep per PEA scale.

    ``scale`` picks the op-count regime: "4x4" stays at paper-kernel
    sizes; "8x8" roughly quadruples them; "16x16" pushes the compute-op
    count to the |V_C| ~ 10^4 candidate regime (ops x 256 PEs) the
    ROADMAP names as untried."""
    mult = {"4x4": 1, "8x8": 2, "16x16": 4}[scale]
    base = 10 * mult                 # 10 / 20 / 40-class op counts
    specs = [
        WorkloadSpec(f"loop{base}", "loop",
                     dict(n_chains=2 * mult, chain_len=5,
                          n_inputs=min(2 + mult, 8), n_outputs=2,
                          n_carries=mult, seed=seed)),
        WorkloadSpec(f"stencil{4 * mult}t3", "stencil",
                     dict(points=4 * mult, taps=3)),
        WorkloadSpec(f"reduce{8 * mult}", "reduction",
                     dict(width=8 * mult, arity=2)),
        WorkloadSpec("c2k6", "cnkm", dict(n=2, m=6)),
    ]
    return specs


def scale_16x16_loop(*, n_chains: int = 8, chain_len: int = 5,
                     seed: int = 0) -> DFG:
    """The |V_C| ~ 10^4 case: 40 compute ops on a 16x16 PEA give
    40 x 256 quad candidates (> 10^4 vertices), past the portfolio's
    default 32 MiB row-cache bound — the workload the per-move-unpack
    fallback is verified against."""
    return make_loop_kernel(
        n_chains=n_chains, chain_len=chain_len, n_inputs=5, n_outputs=4,
        n_carries=2, max_distance=2, cross_links=2, seed=seed)


def op_weight(d: DFG) -> int:
    """Region-area demand proxy used by the co-mapper's partitioner."""
    return max(len(d.v_r), 1)


# ----------------------------------------------------------- serving trace
def permute_dfg(d: DFG, *, seed: int = 0) -> DFG:
    """Random vertex relabeling of ``d``: the same mapping problem under
    a shuffled op-id assignment (and shuffled op/edge iteration order).

    This is what a client resubmitting a structurally-identical kernel
    looks like to the serving layer — the canonicalizer (`serve.canon`)
    must hash both labelings identically, and a cached placement must
    replay onto the permuted ids."""
    rng = np.random.default_rng(seed)
    ids = sorted(d.ops)
    shuffled = [ids[i] for i in rng.permutation(len(ids))]
    mapping = dict(zip(ids, shuffled))
    out = DFG()
    for oid in [ids[i] for i in rng.permutation(len(ids))]:
        op = d.ops[oid]
        nid = mapping[oid]
        out.ops[nid] = dataclasses.replace(
            op, op_id=nid,
            clone_of=mapping[op.clone_of] if op.clone_of >= 0 else -1)
    edges = [dataclasses.replace(e, src=mapping[e.src],
                                 dst=mapping[e.dst]) for e in d.edges]
    out.edges = [edges[i] for i in rng.permutation(len(edges))]
    out._next_id = max(out.ops, default=-1) + 1
    return out


def serve_catalog(scale: str = "8x8", *, seed: int = 0
                  ) -> list[WorkloadSpec]:
    """The distinct-kernel population a request trace draws from.

    Sized so each kernel maps in tens of milliseconds at its scale's
    fabric (the regime where a cache hit — canonicalize + relabel +
    validator replay, ~1 ms — is decisively cheaper than a fresh map),
    with enough variety that a Zipf tail still forces real misses."""
    mult = {"4x4": 1, "8x8": 2, "16x16": 4}[scale]
    specs = [
        WorkloadSpec("c2k4", "cnkm", dict(n=2, m=4)),
        WorkloadSpec("c2k6", "cnkm", dict(n=2, m=6)),
        WorkloadSpec("c3k6", "cnkm", dict(n=3, m=6)),
        WorkloadSpec("c4k4", "cnkm", dict(n=4, m=4)),
        WorkloadSpec("c4k8", "cnkm", dict(n=4, m=8)),
        WorkloadSpec("c5k5", "cnkm", dict(n=5, m=5)),
        WorkloadSpec("stencil4", "stencil", dict(points=4, taps=3)),
        WorkloadSpec(f"stencil{3 * mult}",
                     "stencil", dict(points=3 * mult, taps=3)),
        WorkloadSpec(f"reduce{8 * mult}",
                     "reduction", dict(width=8 * mult, arity=2)),
        WorkloadSpec("reduce6a3", "reduction", dict(width=6, arity=3)),
    ]
    for k in range(3):
        specs.append(WorkloadSpec(
            f"loop{mult}x{k}", "loop",
            dict(n_chains=2 * mult, chain_len=4,
                 n_inputs=min(2 + mult, 4), n_outputs=2,
                 n_carries=min(k, 2 * mult), max_distance=2,
                 seed=seed + k)))
    return specs


@dataclasses.dataclass
class TraceRequest:
    """One entry of a serving request trace."""
    name: str            # catalog spec the kernel was drawn from
    dfg: DFG             # freshly built (and usually permuted) instance
    deadline: float      # admission order hint (arrival index here)
    tenant: str | None = None


def make_request_trace(n_requests: int = 200, *, scale: str = "8x8",
                       zipf_s: float = 1.1, permute: bool = True,
                       seed: int = 0,
                       catalog: list[WorkloadSpec] | None = None
                       ) -> list[TraceRequest]:
    """Zipf-popularity request trace over the serving catalog.

    Kernel ``k`` (0-based catalog rank) is drawn with probability
    proportional to ``1 / (k+1)**zipf_s`` — the classic popularity skew
    under which a mapping cache earns its keep: a few hot kernels
    dominate the trace while the tail keeps producing compulsory
    misses.  With ``permute`` each instance carries a fresh random
    vertex relabeling, so hits are only reachable through canonical
    (isomorphism-invariant) hashing, never through accidental id
    equality.  Deterministic in ``seed``."""
    specs = catalog if catalog is not None else serve_catalog(scale)
    rng = np.random.default_rng(seed)
    p = np.arange(1, len(specs) + 1, dtype=float) ** -zipf_s
    p /= p.sum()
    draws = rng.choice(len(specs), size=n_requests, p=p)
    trace = []
    for t, k in enumerate(draws):
        d = specs[k].build()
        if permute:
            d = permute_dfg(d, seed=int(rng.integers(1 << 31)))
        trace.append(TraceRequest(specs[k].name, d, deadline=float(t)))
    return trace


# The canonical 16x16 co-mapping scenario: two loop kernels with
# loop-carried accumulators (RecMII 4 and 3) plus a 6-point stencil.
# The same specs as the JAX package's, for the co-mapper when it is
# ported (tests/test_torch_workloads.py holds the two equal).
COMAP_16X16_SPECS: list[WorkloadSpec] = [
    WorkloadSpec("loopA", "loop",
                 dict(n_chains=4, chain_len=4, n_inputs=3, n_outputs=2,
                      n_carries=2, max_distance=2, seed=0)),
    WorkloadSpec("loopB", "loop",
                 dict(n_chains=5, chain_len=3, n_inputs=3, n_outputs=2,
                      n_carries=1, max_distance=1, seed=1)),
    WorkloadSpec("stencil6", "stencil", dict(points=6, taps=3)),
]
