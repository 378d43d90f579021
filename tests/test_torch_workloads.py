"""The port's workload generator (`core.workloads`) and DFG lint
(`analysis.dfglint`) against the JAX package, and the 16x16 table that
`chip_smoke.py` pins against the reference's `map_dfg`.  Every
comparison is exact: ops, kinds, edges, distances, lint findings,
vertex counts and (II, routing PEs) pairs."""

from __future__ import annotations

import importlib.util
import os

import pytest

import repro.core as R  # noqa: E402
from repro.analysis import dfglint as ref_lint  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro.core.conflict import \
    build_conflict_graph as ref_build  # noqa: E402

pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.analysis import dfglint as lint  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.core.conflict import build_conflict_graph  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = ("4x4", "8x8", "16x16")


def _dfg_key(d) -> tuple:
    """Everything a DFG holds, in a form both packages' types share."""
    ops = [(oid, op.op_id, op.kind.value, op.name, op.latency, op.clone_of)
           for oid, op in d.ops.items()]
    edges = [(e.src, e.dst, e.distance) for e in d.edges]
    return ops, edges, d._next_id


def _both(build):
    """``build(lib)`` on the reference's and the port's core."""
    return build(R), build(P)


@pytest.mark.parametrize("scale", SCALES)
def test_sweep_specs_match_reference(scale):
    ref_specs, specs = _both(lambda lib: lib.sweep_specs(scale))
    assert [(s.name, s.family, s.params) for s in specs] == \
        [(s.name, s.family, s.params) for s in ref_specs]
    for ref_spec, spec in zip(ref_specs, specs):
        assert _dfg_key(spec.build()) == _dfg_key(ref_spec.build())


@pytest.mark.parametrize("build", [
    lambda lib: lib.scale_16x16_loop(),
    lambda lib: lib.make_tightly_coupled(),
    lambda lib: lib.make_tightly_coupled(n_vios=4, fanout=12, seed=3),
    lambda lib: lib.permute_dfg(lib.scale_16x16_loop(), seed=5),
    lambda lib: lib.permute_dfg(lib.make_cnkm(3, 6), seed=1),
    lambda lib: lib.generate("loop", n_chains=3, chain_len=4, n_carries=2,
                             max_distance=2, seed=7),
], ids=["scale_16x16_loop", "tightly_coupled", "tightly_coupled_s3",
        "permuted_16x16_loop", "permuted_c3k6", "generate_loop"])
def test_builders_match_reference(build):
    ref_dfg, dfg = _both(build)
    assert _dfg_key(dfg) == _dfg_key(ref_dfg)


@pytest.mark.parametrize("scale", SCALES)
def test_serve_catalog_and_request_trace_match_reference(scale):
    ref_cat, cat = _both(lambda lib: lib.serve_catalog(scale, seed=2))
    assert [(s.name, s.family, s.params) for s in cat] == \
        [(s.name, s.family, s.params) for s in ref_cat]
    ref_trace, trace = _both(lambda lib: lib.make_request_trace(
        24, scale=scale, seed=4))
    assert [(t.name, t.deadline, t.tenant) for t in trace] == \
        [(t.name, t.deadline, t.tenant) for t in ref_trace]
    for ref_req, req in zip(ref_trace, trace):
        assert _dfg_key(req.dfg) == _dfg_key(ref_req.dfg)


def test_comap_specs_match_reference():
    assert [(s.name, s.family, s.params)
            for s in workloads.COMAP_16X16_SPECS] == \
        [(s.name, s.family, s.params)
         for s in ref_workloads.COMAP_16X16_SPECS]
    with pytest.raises(KeyError):
        workloads.generate("nope")


# ------------------------------------------------------------ dfglint
def _base(lib):
    d = lib.DFG()
    v = d.add_op(lib.OpKind.VIN, "v")
    x = d.add_op(lib.OpKind.COMPUTE, "x")
    o = d.add_op(lib.OpKind.VOUT, "o")
    d.add_edge(v, x)
    d.add_edge(x, o)
    return d, v, x, o


def _dangling(lib):
    d, v, x, o = _base(lib)
    d.edges.append(type(d.edges[0])(src=x, dst=99, distance=0))
    return d


def _cycle(distance):
    def build(lib):
        d, v, x, o = _base(lib)
        y = d.add_op(lib.OpKind.COMPUTE, "y")
        d.add_edge(x, y)
        d.add_edge(y, x, distance=distance)
        return d
    return build


def _vin_has_pred(lib):
    d, v, x, o = _base(lib)
    b = d.add_op(lib.OpKind.VIN, "b")
    d.add_edge(x, b)
    return d


def _vout_has_succ(lib):
    d, v, x, o = _base(lib)
    y = d.add_op(lib.OpKind.COMPUTE, "y")
    d.add_edge(o, y)
    return d


def _unconsumed_and_error(lib):
    d = _vin_has_pred(lib)
    d.add_op(lib.OpKind.VIN, "lonely")
    return d


def _overfanout(lib):
    d, v, x, o = _base(lib)
    for i in range(lib.CGRAConfig().pes_per_ibus):
        y = d.add_op(lib.OpKind.COMPUTE, f"y{i}")
        d.add_edge(v, y)
    return d


def _multi_vio_pred(lib):
    d, v, x, o = _base(lib)
    v2 = d.add_op(lib.OpKind.VIN, "v2")
    d.add_edge(v2, x)
    y = d.add_op(lib.OpKind.COMPUTE, "y")
    d.add_edge(v2, y)
    return d


def _shared_voo(lib):
    d, v, x, o = _base(lib)
    o2 = d.add_op(lib.OpKind.VOUT, "o2")
    d.add_edge(x, o2)
    return d


LINT_CASES = {
    "dangling-edge": _dangling, "zero-distance-cycle": _cycle(0),
    "distance-1-cycle": _cycle(1), "vin-has-pred": _vin_has_pred,
    "vout-has-succ": _vout_has_succ,
    "unconsumed-and-error": _unconsumed_and_error,
    "overfanout": _overfanout, "multi-vio-pred": _multi_vio_pred,
    "shared-voo-producer": _shared_voo,
    **{f"{spec.name}@{scale}": (lambda lib, s=spec: s.build())
       for scale in ("4x4", "8x8") for spec in R.sweep_specs(scale)},
    **{f"permuted-{spec.name}": (lambda lib, s=spec: lib.permute_dfg(
        getattr(lib, "generate")(s.family, **s.params), seed=3))
       for spec in R.sweep_specs("4x4")},
}


def _findings(findings) -> list:
    return [(f.rule, f.severity, f.message, f.ops) for f in findings]


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_dfglint_findings_match_reference(case):
    ref_dfg, dfg = _both(LINT_CASES[case])
    for kwargs in ({}, {"max_bus_fanout": 1}):
        want = ref_lint.lint_dfg(ref_dfg, R.CGRAConfig(), **kwargs)
        got = lint.lint_dfg(dfg, P.CGRAConfig(), **kwargs)
        assert _findings(got) == _findings(want)
        assert _findings(lint.fatal_findings(got)) == \
            _findings(ref_lint.fatal_findings(want))
    assert _findings(lint.lint_dfg(dfg)) == \
        _findings(ref_lint.lint_dfg(ref_dfg))
    assert _findings(lint.generator_invariant_findings(dfg)) == \
        _findings(ref_lint.generator_invariant_findings(ref_dfg))


def test_generator_assertion_rejects_violation():
    d = _multi_vio_pred(P)
    with pytest.raises(AssertionError, match="multi-vio-pred"):
        workloads._assert_invariants(d)
    assert workloads._assert_invariants(workloads.generate("cnkm", n=2,
                                                           m=4))


# ----------------------------------------------------- 16x16 graphs
def _first_schedule(lib, dfg, cgra):
    start = lib.mii(dfg, cgra)
    for ii in range(start, start + 8):
        try:
            return lib.schedule_dfg(dfg, cgra, mode="bandmap", ii=ii,
                                    max_ii=ii, jitter=0, seed=0)
        except RuntimeError:
            continue
    raise AssertionError("no schedulable II")


def _workload(lib, name):
    if name == "scale_16x16_loop":
        return lib.scale_16x16_loop()
    return {s.name: s for s in lib.sweep_specs("16x16")}[name].build()


@pytest.mark.parametrize("name", ["scale_16x16_loop", "loop40",
                                  "stencil16t3", "reduce32", "c2k6"])
def test_16x16_conflict_graphs_match_reference(name):
    ref_cgra, cgra = R.CGRAConfig(rows=16, cols=16), \
        P.CGRAConfig(rows=16, cols=16)
    ref_sched = _first_schedule(R, _workload(R, name), ref_cgra)
    sched = _first_schedule(P, _workload(P, name), cgra)
    assert sched.ii == ref_sched.ii
    want = ref_build(ref_sched, ref_cgra, bus_pressure=True)
    got = build_conflict_graph(sched, cgra, bus_pressure=True)
    assert got.n == want.n > 3000
    assert got.bits.rows.tobytes() == want.bits.rows.tobytes()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_16x16_table_matches_reference_map_dfg():
    smoke = _chip_smoke()
    assert set(smoke.GOLDEN_16X16) <= set(smoke.WORKLOADS_16X16)
    cgra = R.CGRAConfig(rows=16, cols=16)
    for name, pair in smoke.GOLDEN_16X16.items():
        r = R.map_dfg(_workload(R, name), cgra)
        assert r.ok and r.ii == r.mii, name
        assert (r.ii, r.n_routing_pes) == pair, name
