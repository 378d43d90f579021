"""The port's co-mapper (`repro_torch.comap`) against the JAX package's
`repro.comap`, on the CPU.

Under ``engine="numpy"`` both packages run the same host code, so on
the tier-1 cases of tests/test_comap.py (8x8, and the 2x2 failure) the
`CoMapResult`s must be equal: the common II, the rounds, the regions
and their configs, every region's `MappingResult`, the arbiter's
report and the merged binding.  The region geometry and the arbiter
are compared on their own too.  On the port's default engine, run on
the CPU, `co_map` must give a merged binding the port's validator
accepts.  Every comparison is exact equality.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import repro.comap as ref_comap  # noqa: E402
import repro.core as ref  # noqa: E402
import repro_torch.comap as port_comap  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch.core.validate import validate_mapping  # noqa: E402

from _torch_compare import (assert_same_comap,  # noqa: E402
                            assert_same_result)


def _both(build):
    """The same DFG list built by each package's generators."""
    return build(ref), build(port)


def _two_kernels(pkg):
    return [pkg.make_cnkm(2, 4), pkg.make_stencil(points=4, taps=3)]


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("weights", [[1.0], [3, 5], [10, 7, 4], [1] * 6])
@pytest.mark.parametrize("side", [8, 16])
def test_partition_equals_reference(weights, side):
    want = ref_comap.partition(ref.CGRAConfig(rows=side, cols=side),
                               weights)
    got = port_comap.partition(port.CGRAConfig(rows=side, cols=side),
                               weights)
    assert [vars(r) for r in got] == [vars(r) for r in want]


def test_region_config_and_translation_equal_reference():
    from repro.core.conflict import QUAD, TIN, TOUT, Vertex
    from repro.core.tec import COL
    from repro_torch.core.conflict import Vertex as PortVertex

    big_r, big_p = ref.CGRAConfig(rows=16, cols=16), \
        port.CGRAConfig(rows=16, cols=16)
    reg_r = ref_comap.Region(r0=4, c0=8, rows=4, cols=8)
    reg_p = port_comap.Region(r0=4, c0=8, rows=4, cols=8)
    assert vars(reg_p.config(big_p, grf=2)) == \
        vars(reg_r.config(big_r, grf=2))
    for v in (Vertex(0, 7, TIN, 1, 1, port=2, mode="bus"),
              Vertex(1, 8, TOUT, 2, 0, port=3),
              Vertex(2, 9, QUAD, 2, 0, pe=(1, 5), drive=(COL, 5))):
        pv = PortVertex(**vars(v))
        assert vars(reg_p.translate_vertex(pv, op=42)) == \
            vars(reg_r.translate_vertex(v, op=42))


# ------------------------------------------------------------- arbiter
def _region_results(pkg, comap, cgra, regions, dfgs, ii):
    return [pkg.map_dfg(d, reg.config(cgra), min_ii=ii, max_ii=ii,
                        **({"engine": "numpy"} if pkg is port else {}))
            for d, reg in zip(dfgs, regions)]


@pytest.mark.parametrize("rows,cols,regions", [
    (8, 8, [(0, 0, 4, 4), (4, 4, 4, 4)]),       # diagonal: no clash
    (4, 8, [(0, 0, 4, 4), (0, 4, 4, 4)]),       # side by side: clash
])
def test_arbiter_equals_reference(rows, cols, regions):
    reports = []
    for pkg, comap in ((ref, ref_comap), (port, port_comap)):
        cgra = pkg.CGRAConfig(rows=rows, cols=cols)
        regs = [comap.Region(*r) for r in regions]
        results = _region_results(pkg, comap, cgra, regs,
                                  [pkg.make_cnkm(2, 4)] * 2, ii=1)
        assert all(r.ok for r in results)
        reports.append((comap.arbitrate(regs, results, cgra), results))
    (want, want_res), (got, got_res) = reports
    for g, w in zip(got_res, want_res):
        assert_same_result(g, w)
    assert vars(got) == vars(want)
    assert got.ok == (cols == 8 and rows == 8)


def test_merge_equals_reference_and_replays():
    merged = []
    for pkg, comap in ((ref, ref_comap), (port, port_comap)):
        cgra = pkg.CGRAConfig(rows=8, cols=8)
        regs = [comap.Region(0, 0, 4, 4), comap.Region(4, 4, 4, 4)]
        results = _region_results(pkg, comap, cgra, regs,
                                  [pkg.make_cnkm(2, 4), pkg.make_cnkm(1, 2)],
                                  ii=1)
        sched, placement = comap.merge_mappings(regs, results)
        merged.append((sched, placement))
    (ws, wp), (gs, gp) = merged
    assert gs.time == ws.time
    assert {o: vars(v) for o, v in gp.items()} == \
        {o: vars(v) for o, v in wp.items()}
    assert validate_mapping(gs, port.CGRAConfig(rows=8, cols=8), gp).ok


# ---------------------------------------------------------- end to end
def test_co_map_two_kernels_8x8_equals_reference():
    ref_dfgs, port_dfgs = _both(_two_kernels)
    want = ref_comap.co_map(ref_dfgs, ref.CGRAConfig(rows=8, cols=8),
                            max_ii=8)
    got = port_comap.co_map(port_dfgs, port.CGRAConfig(rows=8, cols=8),
                            max_ii=8, engine="numpy")
    assert got.ok and got.report.ok
    assert len({r.ii for r in got.results}) == 1
    assert_same_comap(got, want)
    assert got.summary() == want.summary()


def test_co_map_traced_and_recorded_equals_reference():
    """A traced, recorded run changes nothing, and emits the
    reference's co-mapping spans and events."""
    ref_dfgs, port_dfgs = _both(_two_kernels)
    want = ref_comap.co_map(ref_dfgs, ref.CGRAConfig(rows=8, cols=8),
                            max_ii=8)
    tr, rec = port_obs.Tracer(), port_obs.FlightRecorder()
    got = port_comap.co_map(port_dfgs, port.CGRAConfig(rows=8, cols=8),
                            max_ii=8, engine="numpy", tracer=tr,
                            record=rec)
    assert_same_comap(got, want)
    names = {s.name for s in tr.finished}
    assert {"comap-region", "arbitrate", "merge-replay"} <= names
    kinds = {e["kind"] for e in rec.dump()}
    assert {"comap-round", "comap-arbitrate"} <= kinds


def test_co_map_failure_equals_reference():
    ref_dfgs, port_dfgs = _both(lambda pkg: [pkg.make_cnkm(2, 6)] * 2)
    want = ref_comap.co_map(ref_dfgs, ref.CGRAConfig(rows=2, cols=2),
                            max_ii=3)
    got = port_comap.co_map(port_dfgs, port.CGRAConfig(rows=2, cols=2),
                            max_ii=3, engine="numpy")
    assert not got.ok and got.report is None and len(got.regions) == 2
    assert_same_comap(got, want)


def test_co_map_through_the_portfolio_equals_reference():
    """chip_smoke's co-mapping pair whose regions reach the portfolio
    (loop2x0 + reduce6a3 of the 8x8 serve catalog): the same rounds,
    regions and bindings as the reference under the numpy engine."""
    def pair(pkg):
        catalog = {s.name: s for s in pkg.serve_catalog("8x8")}
        return [catalog[name].build() for name in ("loop2x0", "reduce6a3")]

    ref_dfgs, port_dfgs = _both(pair)
    tr = port_obs.Tracer()
    want = ref_comap.co_map(ref_dfgs, ref.CGRAConfig(rows=8, cols=8),
                            max_ii=8)
    got = port_comap.co_map(port_dfgs, port.CGRAConfig(rows=8, cols=8),
                            max_ii=8, engine="numpy", tracer=tr)
    assert got.ok and tr.counter_value("portfolio.iters") > 0
    assert_same_comap(got, want)


def test_co_map_rejects_empty():
    with pytest.raises(ValueError):
        port_comap.co_map([], port.CGRAConfig(rows=16, cols=16),
                          engine="numpy")


def test_co_map_on_the_device_engine():
    """The port's default engine (on the CPU at the reference's device
    test sizes) co-maps the same pair at the reference's common II,
    into a merged binding the validator accepts."""
    ref_dfgs, port_dfgs = _both(_two_kernels)
    want = ref_comap.co_map(ref_dfgs, ref.CGRAConfig(rows=8, cols=8),
                            max_ii=8)
    cgra = port.CGRAConfig(rows=8, cols=8)
    tr = port_obs.Tracer()
    got = port_comap.co_map(port_dfgs, cgra, max_ii=8, device="cpu",
                            device_seeds=32, mis_iters=4000, tracer=tr)
    assert got.ok, got.summary()
    assert got.ii == want.ii
    assert validate_mapping(got.sched, cgra, got.placement).ok
    assert len(got.placement) == len(got.sched.dfg.ops)
    assert all(r.ok and r.mis_size == r.n_ops for r in got.results)


def test_co_map_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_comap.co_map(_two_kernels(port),
                          port.CGRAConfig(rows=8, cols=8), max_ii=8)
