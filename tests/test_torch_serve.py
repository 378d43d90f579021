"""The port's mapping service (`repro_torch.serve`) against the JAX
package's `repro.serve`, on the CPU.

1. Canonical forms: `canonical_form` gives the same digest, blob and
   relabeling on the same DFGs in both packages.
2. A short request trace through both packages' `MappingService` with
   the numpy engine in both gives equal per-request outcomes (ok, II,
   routing PEs, source, the full result) and equal cache statistics;
   so do co-tenant batches, static rejects and crashed workers.
3. The same trace on the port's default engine, run on the CPU at the
   reference's device test sizes (32 trajectories, 4000 iterations),
   against the reference's device engine: equal (ok, II, routing PEs,
   source) and equal cache statistics.
4. The port's cache never loads a reference entry: its keys differ
   from the reference's for the same request, and a lookup in a
   directory of reference entries misses without importing `repro`.
5. ``device=None`` is the card: without one the service raises when it
   is built.
Every comparison is exact equality (wall times aside).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.serve as ref_serve  # noqa: E402
import repro.serve.scheduler as ref_sched  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.serve as port_serve  # noqa: E402
import repro_torch.serve.scheduler as port_sched  # noqa: E402
from repro.core.dfg import DFG as RefDFG, OpKind as RefOpKind  # noqa: E402
from repro_torch.core.dfg import DFG as PortDFG  # noqa: E402
from repro_torch.core.dfg import OpKind as PortOpKind  # noqa: E402

from _torch_compare import assert_same_result  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMPY = {"engine": "numpy"}
# The reference's device-engine test sizes (tests/test_mis_device.py).
DEVICE = {"engine": "device", "device_seeds": 32, "mis_iters": 4000}


def _stats(svc) -> dict:
    out = svc.cache.stats.as_dict()
    out.pop("replay_wall_s")
    return out


def _outcome(o) -> tuple:
    return (o.req_id, o.ok, o.result.ii, o.result.n_routing_pes, o.source,
            o.hit, o.canon_digest)


def _trace_requests(pkg, serve, n, scale, seed, cgra, options,
                    permute=False):
    trace = pkg.make_request_trace(n, scale=scale, seed=seed)
    return [serve.MapRequest(
        dfg=pkg.permute_dfg(t.dfg, seed=i) if permute else t.dfg,
        cgra=cgra, options=dict(options), deadline=t.deadline,
        tenant=t.tenant, req_id=f"r{i}") for i, t in enumerate(trace)]


# ------------------------------------------------------- canonical forms
@pytest.mark.parametrize("scale", ["4x4", "8x8"])
def test_canonical_forms_equal_reference(scale):
    for i, (r, p) in enumerate(zip(ref.serve_catalog(scale),
                                   port.serve_catalog(scale))):
        for perm in (None, 3 + i):
            rd, pd = r.build(), p.build()
            if perm is not None:
                rd, pd = ref.permute_dfg(rd, seed=perm), \
                    port.permute_dfg(pd, seed=perm)
            want = ref_serve.canonical_form(rd)
            got = port_serve.canonical_form(pd)
            assert (got.digest, got.blob, got.canon_of, got.op_of) == \
                (want.digest, want.blob, want.canon_of, want.op_of)
            assert port_serve.canonical_hash(pd) == \
                ref_serve.canonical_hash(rd)


def test_relabel_result_equals_reference():
    want = ref.map_dfg(ref.make_cnkm(3, 6), ref.CGRAConfig())
    got = port.map_dfg(port.make_cnkm(3, 6), port.CGRAConfig(),
                       engine="numpy")
    rp = ref_serve.canonical_form(ref.permute_dfg(ref.make_cnkm(3, 6),
                                                  seed=4))
    pp = port_serve.canonical_form(port.permute_dfg(port.make_cnkm(3, 6),
                                                    seed=4))
    assert_same_result(port_serve.relabel_result(got, pp.canon_of),
                       ref_serve.relabel_result(want, rp.canon_of))


# --------------------------------------------------- the service, numpy
def _serve_both(ref_reqs, port_reqs, **kw):
    ref_svc = ref_serve.MappingService(max_workers=2, **kw)
    port_svc = port_serve.MappingService(max_workers=2, device="cpu", **kw)
    return (ref_svc, ref_svc.map_batch(ref_reqs)), \
        (port_svc, port_svc.map_batch(port_reqs))


@pytest.mark.parametrize("permute", [False, True])
def test_trace_on_the_numpy_engine_equals_reference(permute):
    (rs, want), (ps, got) = _serve_both(
        _trace_requests(ref, ref_serve, 8, "4x4", 0, ref.CGRAConfig(),
                        {}, permute),
        _trace_requests(port, port_serve, 8, "4x4", 0, port.CGRAConfig(),
                        NUMPY, permute))
    assert [_outcome(o) for o in got] == [_outcome(o) for o in want]
    for g, w in zip(got, want):
        assert_same_result(g.result, w.result)
    assert _stats(ps) == _stats(rs)
    m, n = ps.metrics(), rs.metrics()
    for key in ("requests", "ok", "hits", "hit_rate", "sources",
                "static_rejects"):
        assert m[key] == n[key], key
    assert [{k: v for k, v in e.items() if k not in ("ts", "wall_s")}
            for e in ps.access_log.tail()] == \
        [{k: v for k, v in e.items() if k not in ("ts", "wall_s")}
         for e in rs.access_log.tail()]


def test_second_wave_hits_memory_as_the_reference_does():
    svcs = [ref_serve.MappingService(max_workers=2),
            port_serve.MappingService(max_workers=2, device="cpu")]
    outs = [[], []]
    for wave in (0, 1):
        for k, (pkg, serve, opts) in enumerate(
                ((ref, ref_serve, {}), (port, port_serve, NUMPY))):
            trace = pkg.make_request_trace(6, scale="4x4", seed=0)
            outs[k] = svcs[k].map_batch([serve.MapRequest(
                dfg=pkg.permute_dfg(t.dfg, seed=wave * 31 + i),
                cgra=pkg.CGRAConfig(), options=dict(opts),
                deadline=t.deadline) for i, t in enumerate(trace)])
    assert [_outcome(o) for o in outs[1]] == [_outcome(o) for o in outs[0]]
    assert all(o.hit for o in outs[1])
    assert _stats(svcs[1]) == _stats(svcs[0])


def test_co_tenants_are_co_mapped_as_the_reference_does():
    reqs = []
    for pkg, serve, opts in ((ref, ref_serve, {}),
                             (port, port_serve, NUMPY)):
        cgra = pkg.CGRAConfig(rows=8, cols=8)
        reqs.append([serve.MapRequest(dfg=d, cgra=cgra,
                                      options=dict(opts, max_ii=8),
                                      tenant="A", deadline=i, req_id=f"t{i}")
                     for i, d in enumerate(
                         [pkg.make_cnkm(2, 4),
                          pkg.make_stencil(points=4, taps=3)])])
    (rs, want), (ps, got) = _serve_both(*reqs)
    assert [o.source for o in got] == ["comap", "comap"]
    assert [_outcome(o) for o in got] == [_outcome(o) for o in want]
    for g, w in zip(got, want):
        assert_same_result(g.result, w.result)
    assert _stats(ps) == _stats(rs) and ps.cache.stats.puts == 0


def _dense_vio(dfg_cls, kinds):
    """Row component of 3 VIOs: static floor II >= 3
    (tests/test_serve_static.py)."""
    d = dfg_cls()
    vins = [d.add_op(kinds.VIN, f"v{i}") for i in range(3)]
    for i in range(2):
        x = d.add_op(kinds.COMPUTE, f"x{i}")
        d.add_edge(vins[i], x)
        d.add_edge(vins[i + 1], x)
        o = d.add_op(kinds.VOUT, f"o{i}")
        d.add_edge(x, o)
    return d


def test_static_reject_and_negative_hit_equal_reference():
    reqs = []
    for pkg, serve, dfg_cls, kinds, opts in (
            (ref, ref_serve, RefDFG, RefOpKind, {}),
            (port, port_serve, PortDFG, PortOpKind, NUMPY)):
        base = _dense_vio(dfg_cls, kinds)
        reqs.append([
            serve.MapRequest(dfg=base, cgra=pkg.CGRAConfig(),
                             options=dict(opts, max_ii=2), req_id="a"),
            serve.MapRequest(dfg=pkg.make_cnkm(1, 2), cgra=pkg.CGRAConfig(),
                             options=dict(opts), req_id="b")])
    (rs, want), (ps, got) = _serve_both(*reqs)
    assert [o.source for o in got] == ["static_reject", "computed"]
    for g, w in zip(got, want):
        assert _outcome(g) == _outcome(w)
        assert_same_result(g.result, w.result)
    a = ps.map(port.permute_dfg(_dense_vio(PortDFG, PortOpKind), seed=7),
               port.CGRAConfig(), max_ii=2, engine="numpy")
    b = rs.map(ref.permute_dfg(_dense_vio(RefDFG, RefOpKind), seed=7),
               ref.CGRAConfig(), max_ii=2)
    assert a.source == b.source == "negative-memory"
    assert_same_result(a.result, b.result)
    assert _stats(ps) == _stats(rs)
    assert ps.metrics()["static_rejects"] == rs.metrics()["static_rejects"]


def test_worker_crash_yields_the_reference_outcome(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("injected crash")

    monkeypatch.setattr(ref_sched, "map_dfg", boom)
    monkeypatch.setattr(port_sched, "map_dfg", boom)
    reqs = [[serve.MapRequest(dfg=d, cgra=pkg.CGRAConfig(),
                              options=dict(opts), req_id=rid)
             for rid, d in (("lead", pkg.make_cnkm(2, 6)),
                            ("follow", pkg.permute_dfg(pkg.make_cnkm(2, 6),
                                                       seed=1)))]
            for pkg, serve, opts in ((ref, ref_serve, {}),
                                     (port, port_serve, NUMPY))]
    (rs, want), (ps, got) = _serve_both(*reqs)
    assert [_outcome(o) for o in got] == [_outcome(o) for o in want]
    assert all(o.source == "crash" for o in got)
    res = got[0].result
    assert res.attempts == 1 and not res.proved_infeasible
    assert res.flight[-1]["kind"] == "serve-crash"
    assert any(e["kind"] == "serve-crash" for e in ps.flight.dump())
    assert _stats(ps) == _stats(rs) and ps.cache.stats.puts == 0


def test_map_trace_driver_equals_reference():
    from repro.launch.serve import run_map_trace as ref_trace
    from repro_torch.launch.serve import run_map_trace as port_trace

    want = ref_trace(6, scale="4x4", rows=4, cols=4, seed=0, max_workers=2,
                     quiet=True)
    got = port_trace(6, scale="4x4", rows=4, cols=4, seed=0, max_workers=2,
                     quiet=True, device="cpu")
    for key in ("requests", "ok", "hits", "hit_rate", "sources"):
        assert got[key] == want[key], key
    for m in (got, want):
        m["cache"].pop("replay_wall_s")
    assert got["cache"] == want["cache"]


# --------------------------------------------- the service, device engine
def test_trace_on_the_device_engine_equals_reference():
    """The port's default engine on the CPU against the reference's
    device engine (its Pallas kernel in interpret mode)."""
    (rs, want), (ps, got) = _serve_both(
        _trace_requests(ref, ref_serve, 4, "4x4", 0, ref.CGRAConfig(),
                        DEVICE),
        _trace_requests(port, port_serve, 4, "4x4", 0, port.CGRAConfig(),
                        {k: v for k, v in DEVICE.items() if k != "engine"}))
    assert [_outcome(o) for o in got] == [_outcome(o) for o in want]
    assert all(o.ok for o in got)
    assert _stats(ps) == _stats(rs)


# ----------------------------------------------------------- the cache
@pytest.mark.parametrize("options", [{}, NUMPY, {"mode": "busmap",
                                                 "max_ii": 2}])
def test_cache_keys_differ_from_the_reference(options):
    rc = ref_serve.canonical_form(ref.make_cnkm(3, 6))
    pc = port_serve.canonical_form(port.make_cnkm(3, 6))
    want = ref_serve.MappingCache.key(rc, ref.CGRAConfig(), options)
    got = port_serve.MappingCache.key(pc, port.CGRAConfig(), options)
    assert got != want
    # The digest and fabric parts are the reference's; only the
    # options' part carries the package tag.
    assert got.split("-")[:2] == want.split("-")[:2]


def test_disk_tier_round_trips_port_entries(tmp_path):
    art = str(tmp_path / "serve")
    res = port.map_dfg(port.make_cnkm(2, 4), port.CGRAConfig(),
                       engine="numpy")
    canon = port_serve.canonical_form(port.make_cnkm(2, 4))
    port_serve.MappingCache(art_dir=art).store(canon, port.CGRAConfig(),
                                               NUMPY, res)
    hit = port_serve.MappingCache(art_dir=art).lookup(
        canon, port.CGRAConfig(), NUMPY)
    assert hit is not None and hit.source == "disk" and hit.result.ok
    assert type(hit.result) is port.MappingResult


_LOOKUP = """
import os, shutil, sys
art = sys.argv[1]
from repro_torch.core import CGRAConfig, make_cnkm
from repro_torch.serve import MappingCache, canonical_form
canon = canonical_form(make_cnkm(3, 6))
cache = MappingCache(art_dir=art)
misses = 0
for options in ({}, {"engine": "numpy"}):
    misses += cache.lookup(canon, CGRAConfig(), options) is None
    # A reference entry under the port's own key name: still a miss.
    src = os.path.join(art, sorted(n for n in os.listdir(art)
                                   if n.endswith(".pkl"))[0])
    shutil.copy(src, cache._path(cache.key(canon, CGRAConfig(), options)))
    misses += cache.lookup(canon, CGRAConfig(), options) is None
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jax", "jaxlib"))
print(misses, bad)
sys.exit(0 if misses == 4 and not bad else 1)
"""


def test_lookup_over_reference_entries_misses_and_loads_no_reference(
        tmp_path):
    art = str(tmp_path / "shared")
    cache = ref_serve.MappingCache(art_dir=art)
    for options in ({}, NUMPY):
        res = ref.map_dfg(ref.make_cnkm(3, 6), ref.CGRAConfig(), **options)
        cache.store(ref_serve.canonical_form(ref.make_cnkm(3, 6)),
                    ref.CGRAConfig(), options, res)
    assert len(os.listdir(art)) == 1    # both options hash alike there
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _LOOKUP, art], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[0] == "4"


def test_default_art_dir_is_the_ports_own():
    assert port_serve.DEFAULT_ART_DIR == "artifacts/serve_torch"
    assert port_serve.DEFAULT_ART_DIR != ref_serve.DEFAULT_ART_DIR


# ---------------------------------------------------- no hidden fallback
def test_service_default_device_is_the_gpu():
    """Without a GPU the service built with ``device=None`` raises: it
    never maps on the CPU unless asked to."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.MappingService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.RequestScheduler(port_serve.MappingCache())
    from repro_torch.launch.serve import run_map_trace
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_map_trace(2, scale="4x4", rows=4, cols=4, quiet=True)
