"""The port's exact backend and race (`repro_torch.exact`) against the
JAX package's `repro.exact`, on the CPU.

1. `exact_map_dfg` is host code in both packages, so its results must
   be equal field for field (wall times aside) on the cases of
   tests/test_exact_differential.py: ok, II, ``optimal``,
   ``proved_infeasible``, the placement and the certificates.
2. The race under ``engine="numpy"`` on the cases of
   tests/test_exact_race.py whose winner is forced (only one side can
   give a sound answer): the same winner and the same (II, routing
   PEs) as the reference; the degrade-on-crash cases through
   monkeypatch, in both packages.
3. The loser's iterations after the cancel request: at most 1 under
   the numpy engine (it polls every iteration) and at most one chunk
   under the port's device engine on the CPU (it polls between chunks
   of ``chunk_size``).
4. With no GPU the race on the port's default engine raises; it never
   degrades to its exact side.
Every comparison is exact equality.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.core.bandmap as ref_bandmap  # noqa: E402
import repro.exact.race as ref_race  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.core.bandmap as port_bandmap  # noqa: E402
import repro_torch.exact.race as port_race  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch.core.mis_device import DeviceSBTS  # noqa: E402
from repro_torch.exact import exact_map_dfg, race_map_dfg  # noqa: E402

from _torch_compare import assert_same_result  # noqa: E402

MODES = ["bandmap", "busmap"]

# tests/test_exact_differential.py's cases: every paper kernel and one
# small instance of each workload family.
FAMILY_CASES = [
    ("loop", dict(n_chains=2, chain_len=3, n_inputs=2, n_outputs=1,
                  seed=1)),
    ("stencil", dict(points=3, taps=3, seed=1)),
    ("reduction", dict(width=6, arity=2, seed=1)),
    ("cnkm", dict(n=3, m=5)),
    ("tight", dict(n_vios=4, fanout=3, cross_links=1, n_outputs=1,
                   link_run=2, seed=1)),
]
INSTANCES = [(name, None) for name in sorted(ref.all_paper_kernels())] + \
    FAMILY_CASES
# The port's device engine polls its cancel token once a chunk.
DEVICE_CHUNK = DeviceSBTS.__init__.__kwdefaults__["chunk"]


def _dfgs(name, kw):
    if kw is None:
        return ref.all_paper_kernels()[name], port.all_paper_kernels()[name]
    return (ref.workloads.FAMILIES[name](**kw),
            port.workloads.FAMILIES[name](**kw))


# ------------------------------------------------- the exact backend
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,kw", INSTANCES,
                         ids=[name for name, _ in INSTANCES])
def test_exact_backend_equals_reference(name, kw, mode):
    ref_dfg, port_dfg = _dfgs(name, kw)
    want = ref.map_dfg(ref_dfg, ref.CGRAConfig(), mode=mode,
                       backend="exact")
    got = port.map_dfg(port_dfg, port.CGRAConfig(), mode=mode,
                       backend="exact")
    assert got.ok and got.optimal and got.backend == "exact"
    assert_same_result(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_exact_unsat_equals_reference(mode):
    """C5K5 capped below its proven II of 3: both packages certify the
    whole range with the same certificates."""
    want = ref.map_dfg(ref.make_cnkm(5, 5), ref.CGRAConfig(), mode=mode,
                       max_ii=2, backend="exact")
    got = exact_map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                        mode=mode, max_ii=2)
    assert not got.ok and got.proved_infeasible
    assert_same_result(got, want)


def test_exact_node_budget_alias_degrades_the_claim():
    got = exact_map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                        mode="busmap", max_ii=2, node_budget=1)
    want = ref.map_dfg(ref.make_cnkm(5, 5), ref.CGRAConfig(),
                       mode="busmap", max_ii=2, backend="exact",
                       certify_budget=1)
    assert not got.ok and not got.proved_infeasible
    assert_same_result(got, want)


@pytest.mark.parametrize("backend", ["portfolio", "exact"])
def test_preset_cancel_claims_nothing(backend):
    tok = port.CancelToken()
    tok.cancel()
    r = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                     mode="busmap", max_ii=2, backend=backend,
                     engine="numpy", cancel=tok)
    assert not r.ok and not r.proved_infeasible


# ---------------------------------------------------------- the race
def test_race_forced_exact_win_equals_reference():
    """Portfolio certification off on an infeasible instance: only the
    prover can be sound, in both packages."""
    kw = dict(mode="busmap", max_ii=2, backend="race", certify=False,
              seed=7)
    want = ref.map_dfg(ref.make_cnkm(5, 5), ref.CGRAConfig(), **kw)
    got = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                       engine="numpy", **kw)
    assert got.backend == want.backend == "race:exact"
    assert not got.ok and got.proved_infeasible
    assert_same_result(got, want)


@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_race_forced_portfolio_win_equals_reference(engine):
    """A one-node prover budget can neither accept nor certify: the
    portfolio's mapping is the only sound answer.  Under the numpy
    engine the port returns the reference's very mapping; its device
    engine (on the CPU) reaches the reference's (II, routing PEs)."""
    kw = dict(mode="busmap", backend="race", certify=False,
              certify_budget=1, seed=7)
    want = ref.map_dfg(ref.make_cnkm(3, 6), ref.CGRAConfig(), **kw)
    extra = dict(engine="numpy") if engine == "numpy" else \
        dict(device="cpu", device_seeds=32, mis_iters=4000)
    got = port.map_dfg(port.make_cnkm(3, 6), port.CGRAConfig(), **kw,
                       **extra)
    assert got.backend == want.backend == "race:portfolio"
    assert got.ok and (got.ii, got.n_routing_pes) == \
        (want.ii, want.n_routing_pes)
    if engine == "numpy":
        assert_same_result(got, want)


def test_race_winner_matches_solo_portfolio():
    dfg = port.make_cnkm(3, 6)
    solo = port.map_dfg(dfg, port.CGRAConfig(), mode="busmap",
                        certify=False, seed=3, engine="numpy")
    raced = port.map_dfg(dfg, port.CGRAConfig(), mode="busmap",
                         backend="race", certify=False, certify_budget=1,
                         seed=3, engine="numpy")
    assert raced.backend == "race:portfolio"
    assert (raced.ii, raced.placement) == (solo.ii, solo.placement)


def test_race_preset_cancel_returns_unsound_best_effort():
    tok = port.CancelToken()
    tok.cancel()
    r = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                     mode="busmap", max_ii=2, backend="race",
                     engine="numpy", cancel=tok)
    assert not r.ok and not r.proved_infeasible
    assert r.backend.startswith("race:")


# ------------------------------------------------------- degradation
def _boom(*a, **kw):
    raise RuntimeError("prover died")


def test_crashed_prover_degrades_to_portfolio(monkeypatch):
    monkeypatch.setattr(ref_race, "exact_map_dfg", _boom)
    monkeypatch.setattr(port_race, "exact_map_dfg", _boom)
    want = ref.map_dfg(ref.make_cnkm(2, 6), ref.CGRAConfig(),
                       mode="busmap", backend="race")
    got = port.map_dfg(port.make_cnkm(2, 6), port.CGRAConfig(),
                       mode="busmap", backend="race", engine="numpy")
    assert got.ok and got.backend == want.backend == "race:portfolio"
    assert_same_result(got, want)


def _portfolio_crashes(module, monkeypatch):
    real = module.map_dfg

    def boom(*a, **kw):
        if kw.get("cancel") is not None and \
                kw.get("backend", "portfolio") == "portfolio":
            raise RuntimeError("portfolio died")
        return real(*a, **kw)

    monkeypatch.setattr(module, "map_dfg", boom)
    return boom


def test_crashed_portfolio_degrades_to_prover(monkeypatch):
    ref_map = _portfolio_crashes(ref_bandmap, monkeypatch)
    port_map = _portfolio_crashes(port_bandmap, monkeypatch)
    want = ref_map(ref.make_cnkm(2, 6), ref.CGRAConfig(), mode="busmap",
                   backend="race")
    got = port_map(port.make_cnkm(2, 6), port.CGRAConfig(),
                   mode="busmap", backend="race", engine="numpy")
    assert got.ok and got.optimal
    assert got.backend == want.backend == "race:exact"
    assert_same_result(got, want)


def test_both_sides_crashed_raises(monkeypatch):
    monkeypatch.setattr(port_race, "exact_map_dfg", _boom)
    monkeypatch.setattr(port_bandmap, "map_dfg", _boom)
    with pytest.raises(RuntimeError):
        race_map_dfg(port.make_cnkm(2, 6), port.CGRAConfig(),
                     mode="busmap", engine="numpy")


# -------------------------------------------------- the cancel bound
@pytest.mark.parametrize("engine,bound", [("numpy", 1),
                                          ("device", DEVICE_CHUNK)])
def test_traced_race_bounds_loser_iterations_after_cancel(engine, bound):
    """The forced-loser case of tests/test_exact_race.py: the portfolio
    always loses.  Its iterations after the cancel request are bounded
    by how often its engine polls: every iteration (numpy) or every
    chunk (the device engine, here on the CPU)."""
    extra = dict(engine="numpy") if engine == "numpy" else \
        dict(device="cpu", device_seeds=32)
    tr = port_obs.Tracer()
    r = port.map_dfg(port.make_cnkm(5, 5), port.CGRAConfig(),
                     mode="busmap", max_ii=2, backend="race",
                     certify=False, seed=7, tracer=tr, **extra)
    assert r.backend == "race:exact" and not r.ok
    (race_rec,) = [s for s in tr.finished if s.name == "race"]
    assert race_rec.attrs["winner"] == "exact"
    assert race_rec.attrs["loser"] == "portfolio"
    assert race_rec.attrs["cancel_latency_s"] >= 0.0
    assert race_rec.attrs["loser_iters_after_cancel"] <= bound
    sides = {s.attrs["side"]: s for s in tr.finished
             if s.name == "race-side"}
    assert set(sides) == {"exact", "portfolio"}
    assert all("ok" in s.attrs for s in sides.values())
    assert sides["exact"].attrs["ok"] is False
    names = {s.name for s in tr.finished}
    assert "exact-csp" in names and "conflict-build" in names
    if engine == "device":
        assert "portfolio-device" in names or \
            tr.counter_value("portfolio.iters") == 0


# ------------------------------------------------- no hidden fallback
def test_race_on_the_default_engine_needs_the_card():
    """``device=None`` is the card: without one the race raises on the
    calling thread instead of leaving the answer to the prover."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.map_dfg(port.make_cnkm(1, 2), port.CGRAConfig(),
                     backend="race")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        race_map_dfg(port.make_cnkm(1, 2), port.CGRAConfig())
    # The exact backend is host code and needs no device.
    assert port.map_dfg(port.make_cnkm(1, 2), port.CGRAConfig(),
                        backend="exact").ok
