"""The port's mapper (`repro_torch.core.map_dfg`) against the JAX
package's `repro.core.map_dfg`, on the CPU.

1. With the numpy engine asked for explicitly (``engine="numpy"``) the
   two packages run the same host code, so every result field except
   the wall time must be equal on every non-slow golden case.
2. The port's default engine, the GPU-resident `DeviceSBTS`, run on the
   CPU (``device="cpu"``, ``device_seeds=32``, ``iters=4000``, as the
   reference's own device test runs), must reproduce the golden
   (II, routing-PE) table.
All compared values are integers, strings or bools: the comparisons are
exact.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402

from test_golden_results import GOLDEN, SLOW  # noqa: E402

CASES = [case for case in GOLDEN if case not in SLOW]
SCALAR_FIELDS = ("ok", "mode", "ii", "mii", "n_routing_pes",
                 "ports_per_vio", "cg_size", "mis_size", "n_ops",
                 "attempts", "optimal", "proved_infeasible", "backend",
                 "flight")


def _placement(res) -> dict:
    return {op: vars(v) for op, v in res.placement.items()}


@pytest.mark.parametrize("n,m,mode", CASES)
def test_numpy_engine_equals_reference(n, m, mode):
    want = ref.map_dfg(ref.make_cnkm(n, m), ref.CGRAConfig(), mode=mode)
    got = port.map_dfg(port.make_cnkm(n, m), port.CGRAConfig(),
                       mode=mode, engine="numpy")
    for f in SCALAR_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert _placement(got) == _placement(want)
    assert [(c.ii, c.jitter, c.stage) for c in got.certificates] == \
        [(c.ii, c.jitter, c.stage) for c in want.certificates]
    assert got.sched.time == want.sched.time
    assert got.report.ok == want.report.ok


@pytest.mark.parametrize("n,m,mode", CASES)
def test_device_engine_on_cpu_reaches_golden_pairs(n, m, mode):
    opts = port.MapOptions(mode=mode, portfolio=port.PortfolioOptions(
        device_seeds=32, iters=4000))
    assert opts.portfolio.engine == "device"
    r = port.map_dfg(port.make_cnkm(n, m), port.CGRAConfig(), opts,
                     device="cpu")
    assert r.ok, f"{port.cnkm_name(n, m)}:{mode} failed: {r.summary()}"
    assert (r.ii, r.n_routing_pes) == GOLDEN[(n, m, mode)], r.summary()
    assert r.mis_size == r.n_ops


def test_device_engine_harvest_runs_the_engine():
    """C5K5 bandmap is the golden case whose certificate stage leaves
    the search to the portfolio: the device engine must iterate there,
    and its rounds trace as "portfolio-device"."""
    tr = port_obs.Tracer()
    r = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                     mode="bandmap", device="cpu", device_seeds=32,
                     mis_iters=4000, tracer=tr)
    assert r.ok and (r.ii, r.n_routing_pes) == GOLDEN[(5, 5, "bandmap")]
    assert tr.counter_value("portfolio.iters") > 0
    assert "portfolio-device" in {s.name for s in tr.finished}


def test_default_device_is_the_gpu():
    dfg, cgra = port.make_cnkm(1, 2), port.CGRAConfig()
    if torch.cuda.is_available():
        assert port.map_dfg(dfg, cgra).ok
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port.map_dfg(dfg, cgra)
    # The numpy engine never needs a device.
    assert port.map_dfg(dfg, cgra, engine="numpy").ok


def test_options_match_reference_but_for_the_engine_default():
    assert port.PortfolioOptions().engine == "device"
    assert ref.PortfolioOptions().engine == "numpy"
    p, r = port.MapOptions().to_kwargs(sparse=False), \
        ref.MapOptions().to_kwargs(sparse=False)
    assert p.keys() == r.keys()
    assert {k for k in p if p[k] != r[k]} == {"engine"}
    # The fingerprint hashes only non-default knobs, so the two defaults
    # hash alike although they name different engines, and the same
    # engine named in both packages hashes apart.  A cache shared by
    # both packages would need the package in its key.
    assert port.MapOptions().fingerprint() == ref.MapOptions().fingerprint()
    assert port.MapOptions.from_kwargs(engine="numpy").fingerprint() != \
        ref.MapOptions.from_kwargs(engine="numpy").fingerprint()


@pytest.mark.parametrize("backend", ["exact", "race"])
def test_unported_backends_raise(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.map_dfg(port.make_cnkm(1, 2), port.CGRAConfig(),
                     backend=backend, engine="numpy")


def test_explain_is_not_ported():
    r = port.map_dfg(port.make_cnkm(1, 2), port.CGRAConfig(),
                     engine="numpy")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.explain()


def test_vocabularies_match_the_reference():
    assert port_obs.PHASES == ref_obs.PHASES
    assert port_obs.EVENTS == ref_obs.EVENTS


def test_traced_runs_use_the_vocabulary_and_change_nothing():
    dfg, cgra = port.make_cnkm(5, 5), port.CGRAConfig()
    tr, rec = port_obs.Tracer(), port_obs.FlightRecorder()
    traced = port.map_dfg(dfg, cgra, mode="bandmap", device="cpu",
                          device_seeds=8, tracer=tr, record=rec)
    plain = port.map_dfg(dfg, cgra, mode="bandmap", device="cpu",
                         device_seeds=8)
    assert {s.name for s in tr.finished} <= set(port_obs.PHASES)
    assert {e["kind"] for e in rec.dump()} <= set(port_obs.EVENTS)
    for f in SCALAR_FIELDS:
        assert getattr(traced, f) == getattr(plain, f), f
    assert _placement(traced) == _placement(plain)


def test_failed_result_carries_flight_and_round_trips():
    rec = port_obs.FlightRecorder()
    r = port.map_dfg(port.make_cnkm(2, 8), port.CGRAConfig(),
                     mode="bandmap", max_ii=1, engine="numpy", record=rec)
    assert not r.ok and r.flight
    assert {e["kind"] for e in r.flight} <= set(port_obs.EVENTS)
    back = port.MappingResult.from_bytes(r.to_bytes())
    assert (back.ok, back.ii, back.flight) == (r.ok, r.ii, r.flight)
    assert port.MappingResult.SERIAL_VERSION == \
        ref.MappingResult.SERIAL_VERSION == 3


def test_result_fields_mirror_the_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(port.MappingResult)] == \
        [f.name for f in dataclasses.fields(ref.MappingResult)]
    assert np.isclose(
        port.map_dfg(port.make_cnkm(1, 2), port.CGRAConfig(),
                     engine="numpy").ii_ratio, 1.0)
