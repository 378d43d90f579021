"""The port's `obs.explain`, `obs.export` and `obs.expo` against the JAX
package's, on the CPU.

1. Explain reports: the same mapping run (``engine="numpy"`` in the
   port, traced and recorded in both) gives equal `ExplainReport`s,
   as dicts and rendered, on the cases of tests/test_obs_explain.py;
   `MappingResult.explain()` is the same report, and the port's CLI
   renders a serialized port result.
2. Export: the same spans and counters give equal `to_json` payloads
   and equal Chrome traces.
3. Exposition: the same registry snapshot renders to the same
   Prometheus text and parses back alike; head sampling picks the same
   digests; the access log has the reference's schema.
Every comparison is exact equality (the race's cancel latency, a wall
time, aside).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro.obs.explain import explain_result as ref_explain  # noqa: E402
from repro_torch.obs.explain import main as explain_main  # noqa: E402

from _torch_compare import assert_same_result, untimed  # noqa: E402


def _report(rep) -> dict:
    """An explain report as a dict, its coverage rows without their
    clock readings."""
    out = rep.as_dict()
    out["coverage"] = untimed(out["coverage"])
    return out


def _run_both(n, m, cgra_kw=None, **kw):
    """Map one CnKm case in both packages (the port on the numpy
    engine), each traced and recorded."""
    out = []
    for pkg, obs, extra in ((ref, ref_obs, {}),
                            (port, port_obs, {"engine": "numpy"})):
        tr, rec = obs.Tracer(), obs.FlightRecorder()
        res = pkg.map_dfg(pkg.make_cnkm(n, m),
                          pkg.CGRAConfig(**(cgra_kw or {})), tracer=tr,
                          record=rec, **kw, **extra)
        out.append((res, tr, rec))
    return out


CASES = [
    pytest.param((5, 5), dict(mode="busmap"), id="C5K5-busmap"),
    pytest.param((5, 5), dict(mode="bandmap"), id="C5K5-bandmap"),
    pytest.param((2, 8), dict(mode="busmap", max_ii=2),
                 id="C2K8-busmap-infeasible"),
    pytest.param((3, 6), dict(mode="busmap", certify=False),
                 id="C3K6-busmap-uncertified"),
]


@pytest.mark.parametrize("case,kw", CASES)
def test_explain_report_equals_reference(case, kw):
    (want, ref_tr, ref_rec), (got, port_tr, port_rec) = \
        _run_both(*case, **kw)
    assert_same_result(got, want)
    a = got.explain(tracer=port_tr, flight=port_rec.dump())
    b = want.explain(tracer=ref_tr, flight=ref_rec.dump())
    assert _report(a) == _report(b)
    assert a.render() == b.render()
    # Without the tracer the report comes from the result alone.
    assert _report(got.explain()) == _report(want.explain())


def test_explain_golden_c5k5_busmap():
    (_, _, _), (got, tr, rec) = _run_both(5, 5, mode="busmap")
    rep = got.explain(tracer=tr, flight=rec.dump())
    assert (rep.ok, rep.mode, rep.ii, rep.mii) == (True, "busmap", 3, 2)
    ii2, ii3 = rep.escalation
    assert ii2["stages"] == ["exhausted"]
    assert ii2["certified_jitters"] == [0, 1, 2, 3]
    assert ii3["outcome"] == "mapped"
    text = rep.render()
    assert "II=2: skipped — certified infeasible" in text
    assert "BusMap baseline" in text


def test_explain_race_report_equals_reference():
    """The forced race (only the prover can be sound): the race section
    matches but for the cancel latency, which is a wall time."""
    kw = dict(mode="busmap", max_ii=2, backend="race", certify=False,
              seed=7)
    want = ref.map_dfg(ref.make_cnkm(5, 5), ref.CGRAConfig(), **kw)
    got = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                       engine="numpy", **kw)
    a, b = _report(got.explain()), _report(want.explain())
    for rep in (a, b):
        rep["race"].pop("cancel_latency_s", None)
    assert a == b
    assert a["race"]["winner"] == "exact"


def test_explain_duck_types_equal_reference():
    kw = dict(ok=True, mode="bandmap", ii=2, mii=2, n_routing_pes=0,
              ports_per_vio={7: 2}, placement={}, sched=None, report=None,
              cg_size=(10, 20), mis_size=5, n_ops=5, attempts=3,
              wall_s=0.1)
    got = port_obs.explain_result(port.MappingResult(**kw))
    want = ref_explain(ref.MappingResult(**kw))
    assert got.as_dict() == want.as_dict()
    assert got.render() == want.render()


def test_explain_cli_renders_a_port_result(tmp_path, capsys):
    res = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                       mode="busmap", engine="numpy")
    path = tmp_path / "result.bin"
    path.write_bytes(res.to_bytes())
    assert explain_main([str(path)]) == 0
    assert "explain: busmap — ok" in capsys.readouterr().out
    assert explain_main([str(path), "--json"]) == 0
    blob = json.loads(capsys.readouterr().out)
    assert blob["ii"] == res.ii and blob["escalation"]


# ---------------------------------------------------------------- export
def _port_copy(tracer):
    """A port tracer holding the reference tracer's spans and counters."""
    out = port_obs.Tracer()
    out._finished = [port_obs.SpanRecord(**vars(r))
                     for r in tracer.finished]
    for name, value in tracer.registry.snapshot()["counters"].items():
        out.count(name, value)
    return out


def test_to_json_and_chrome_trace_equal_reference():
    (_, ref_tr, _), _ = _run_both(5, 5, mode="busmap")
    ref_tr.count("extra.counter", 3)
    payload = json.loads(json.dumps(port_obs.to_json(_port_copy(ref_tr))))
    assert port_obs.from_json(payload) == \
        [port_obs.SpanRecord(**vars(r)) for r in ref_tr.finished]
    with ref_tr.span("numpy-attrs", n=np.int64(5), cov=np.float32(0.5),
                     shape=(np.int32(2), 3)):
        pass
    port_tr = _port_copy(ref_tr)
    assert port_obs.to_json(port_tr) == ref_obs.to_json(ref_tr)
    for kw in ({}, {"process_name": "c5k5"}):
        got = port_obs.to_chrome_trace(port_tr, **kw)
        assert got == ref_obs.to_chrome_trace(ref_tr, **kw)
        assert json.loads(json.dumps(got)) == got


def test_traced_port_run_exports_the_reference_phases():
    (_, ref_tr, _), (_, port_tr, _) = _run_both(5, 5, mode="busmap")
    names = {e["name"] for e in port_obs.to_chrome_trace(
        port_tr)["traceEvents"] if e["ph"] == "X"}
    want = {e["name"] for e in ref_obs.to_chrome_trace(
        ref_tr)["traceEvents"] if e["ph"] == "X"}
    assert names == want
    assert port_tr.registry.snapshot()["counters"] == \
        ref_tr.registry.snapshot()["counters"]


def test_write_json_and_chrome_trace_files(tmp_path):
    (_, _, _), (_, tr, _) = _run_both(1, 2)
    a = port_obs.write_json(tr, str(tmp_path / "t" / "spans.json"))
    b = port_obs.write_chrome_trace(tr, str(tmp_path / "t" / "trace.json"))
    with open(a) as fh:
        assert json.load(fh) == json.loads(json.dumps(port_obs.to_json(tr)))
    with open(b) as fh:
        assert json.load(fh)["traceEvents"]


# ------------------------------------------------------------ exposition
def _snapshot(obs):
    reg = obs.MetricsRegistry()
    reg.record(
        counters={"requests": 200, "hits": 150, "source.computed": 50},
        gauges={"queue_depth": 7},
        observations={"latency_s": [i / 1000 for i in range(1, 101)]})
    return reg.snapshot()


@pytest.mark.parametrize("kw", [{}, {"labels": {"shard": "3"}},
                                {"namespace": ""},
                                {"labels": {"shard": "0", "w": "a\"b"},
                                 "namespace": "x"}])
def test_prometheus_equals_reference(kw):
    got = port_obs.render_prometheus(_snapshot(port_obs), **kw)
    want = ref_obs.render_prometheus(_snapshot(ref_obs), **kw)
    assert got == want
    assert port_obs.parse_prometheus(got) == ref_obs.parse_prometheus(want)


def test_head_sample_picks_the_reference_digests():
    import hashlib
    digests = [hashlib.sha256(str(i).encode()).hexdigest()
               for i in range(500)]
    for rate in (0.0, 0.1, 0.5, 1.0):
        assert [port_obs.head_sample(d, rate) for d in digests] == \
            [ref_obs.head_sample(d, rate) for d in digests]


def test_access_log_has_the_reference_schema(tmp_path):
    assert port_obs.ACCESS_LOG_FIELDS == ref_obs.ACCESS_LOG_FIELDS
    fields = dict(req_id="r0", digest="ab" * 32, tenant=None, ok=True,
                  hit=False, source="computed", wall_s=0.5, ii=2,
                  backend="portfolio")
    logs = []
    for obs, name in ((ref_obs, "ref.jsonl"), (port_obs, "port.jsonl")):
        log = obs.AccessLog(str(tmp_path / name))
        log.log(**fields)
        logs.append([{k: v for k, v in row.items() if k != "ts"}
                     for row in log.tail()])
    assert logs[0] == logs[1]
    assert [json.loads(ln).keys() for ln in
            (tmp_path / "port.jsonl").read_text().splitlines()] == \
        [json.loads(ln).keys() for ln in
         (tmp_path / "ref.jsonl").read_text().splitlines()]
