"""The port's GPU-resident SBTS engine (`repro_torch.core.mis_device`)
against the JAX package's `repro.core.mis_device.DeviceSBTS`, on the
CPU.

1. Step identity: fed the reference's own draws, the port's `lockstep`
   keeps every state tensor (in_s, tabu, stall, thresh, best,
   best_size) bit-identical to the reference engine advanced with
   ``chunk=1``, iteration by iteration.  The state is integer and bool,
   so the tolerance is zero.  The reference's draws are recomputed here
   with its own formula (fold_in on seed, trajectory, iteration, then
   channels 0-3), and its Pallas kernel runs in interpret mode, as the
   reference selects on the CPU.
2. Mirrors of the reference's engine tests on the port's own counter
   generator: independent sets only, coverage at least the numpy
   oracle's at the reference's small sizes, reproducibility, resume
   identity, the tabu guard step by step, and rearm/reset invariants.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.bitset import pack_bool  # noqa: E402
from repro.core.cgra import CGRAConfig  # noqa: E402
from repro.core.conflict import (build_conflict_graph,  # noqa: E402
                                 constructive_init)
from repro.core.kernels_cnkm import (PAPER_KERNELS, cnkm_name,  # noqa: E402
                                     make_cnkm)
from repro.core.mis_device import DeviceSBTS as RefSBTS  # noqa: E402
from repro.core.schedule import mii, schedule_dfg  # noqa: E402
from repro.core.workloads import FAMILIES  # noqa: E402
from repro_torch.core import mis_device as port  # noqa: E402
from repro_torch.core.bitset import BitsetGraph  # noqa: E402

from test_mis_device import FAMILY_CASES  # noqa: E402

CGRA = CGRAConfig()
FIELDS = port.STATE_FIELDS


def _schedule_and_graph(dfg):
    start = mii(dfg, CGRA)
    for ii in range(start, start + 6):
        try:
            sched = schedule_dfg(dfg, CGRA, mode="bandmap", ii=ii,
                                 max_ii=ii, jitter=0, seed=0)
        except RuntimeError:
            continue
        return sched, build_conflict_graph(sched, CGRA)
    raise AssertionError("no schedulable II found")


def _port_graph(ref_bits) -> BitsetGraph:
    return BitsetGraph.from_rows(ref_bits.rows)


def _ref_draws(seed: int, k: int, n_pad: int, it: int):
    """The reference engine's draws for iteration ``it``, by its own
    formula (`repro.core.mis_device._build_chunk.draws`)."""
    base = jax.random.PRNGKey(seed)

    def one(sid):
        kit = jax.random.fold_in(jax.random.fold_in(base, sid), it)
        r1 = jax.random.uniform(jax.random.fold_in(kit, 0), (n_pad,))
        r2 = jax.random.uniform(jax.random.fold_in(kit, 1), (n_pad,))
        j4 = jax.random.randint(jax.random.fold_in(kit, 2), (), 0, 4)
        dth = jax.random.randint(jax.random.fold_in(kit, 3), (), 0, 24)
        return r1, r2, j4, dth
    return tuple(torch.from_numpy(np.array(a))
                 for a in jax.vmap(one)(jnp.arange(k)))


def _ref_state(ref: RefSBTS) -> dict:
    return {f: np.array(ref._best if f == "best" else getattr(ref, f))
            for f in FIELDS}


STEP_CASES = {
    "C2K6": lambda: make_cnkm(2, 6),
    "loop": lambda: FAMILIES["loop"](**FAMILY_CASES["loop"]),
    "tight": lambda: FAMILIES["tight"](**FAMILY_CASES["tight"]),
}


@pytest.mark.parametrize("case,k", [("C2K6", 8), ("loop", 4),
                                    ("tight", 6)])
def test_lockstep_is_bit_identical_with_injected_draws(case, k):
    sched, cg = _schedule_and_graph(STEP_CASES[case]())
    seed = 17
    inits = [constructive_init(cg, sched, CGRA, seed=i)
             if i % 3 != 2 else None for i in range(k // 2)]
    ref = RefSBTS(cg.bits, inits, k=k, seed=seed, chunk=1)
    # Short plateau thresholds in both engines, so the perturbation
    # branch runs inside the 32 compared iterations.
    ref.thresh = (3 + np.arange(k) % 5).astype(np.int32)
    eng = port.DeviceSBTS(_port_graph(cg.bits), inits, k=k, seed=seed,
                          device="cpu")
    port.load_state(eng, _ref_state(ref))
    state = eng.state
    swaps = perturbs = 0
    for it in range(32):
        draws = _ref_draws(seed, k, eng._n_pad, it)
        state = port.lockstep(eng._rows32, state, it, draws, n=cg.n,
                              tenure=eng.tenure)
        thresh_before = ref.thresh.copy()
        tabu_before = ref.tabu.copy()
        ref.run(1)
        perturbs += int((ref.thresh != thresh_before).sum())
        swaps += int(((ref.tabu != tabu_before)
                      & (ref.tabu > it)).any(axis=1).sum())
        want = _ref_state(ref)
        for f, got in zip(FIELDS, state):
            np.testing.assert_array_equal(
                got.numpy(), want[f], err_msg=f"{f} at iteration {it}")
            assert got.numpy().dtype == want[f].dtype, f
    assert perturbs > 0, "the perturbation branch never ran"
    assert swaps > 0, "no move ever set a tabu"


def test_load_state_rejects_wrong_shapes():
    sched, cg = _schedule_and_graph(make_cnkm(1, 2))
    eng = port.DeviceSBTS(_port_graph(cg.bits), k=4, device="cpu")
    ref = RefSBTS(cg.bits, k=5)
    with pytest.raises(ValueError):
        port.load_state(eng, _ref_state(ref))


# --------------------------------------------- the port's own generator
def test_draws_are_a_pure_function_of_their_key():
    a = port.draws(5, 6, 256, 9, "cpu")
    b = port.draws(5, 6, 256, 9, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    r1, r2, j4, dth = a
    assert r1.dtype == r2.dtype == torch.float32
    assert r1.shape == r2.shape == (6, 256)
    assert j4.dtype == dth.dtype == torch.int32 and j4.shape == (6,)
    assert (r1 >= 0).all() and (r1 < 1).all() and (r2 < 1).all()
    assert (j4 >= 0).all() and (j4 < 4).all()
    assert (dth >= 0).all() and (dth < 24).all()
    # Trajectories, iterations, seeds and channels draw apart.
    assert not torch.equal(r1[0], r1[1])
    assert not torch.equal(r1, r2)
    assert not torch.equal(r1, port.draws(5, 6, 256, 10, "cpu")[0])
    assert not torch.equal(r1, port.draws(6, 6, 256, 9, "cpu")[0])


def test_draws_look_uniform():
    r1, _, j4, dth = port.draws(0, 512, 1024, 3, "cpu")
    assert abs(float(r1.mean()) - 0.5) < 0.01
    hist = torch.bincount(j4.long(), minlength=4)
    assert (hist > 512 / 4 * 0.7).all()
    assert len(torch.unique(dth)) == 24


def test_resolve_device_defaults_to_the_gpu():
    if torch.cuda.is_available():
        assert port.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port.resolve_device(None)
        with pytest.raises(RuntimeError):
            port.DeviceSBTS(BitsetGraph(4), k=2)
    assert port.resolve_device("cpu") == torch.device("cpu")


# ----------------------------------------- mirrors of the engine tests
def _assert_differential(dfg):
    sched, cg = _schedule_and_graph(dfg)
    n_ops = len(sched.dfg.ops)
    res = port.differential_vs_numpy(_port_graph(cg.bits), iters=256,
                                      k=4, seed=0, target=n_ops,
                                      device="cpu")
    assert res["device_independent"], res
    assert res["numpy_independent"], res
    assert res["device_cov"] >= res["numpy_cov"], res


@pytest.mark.parametrize(
    "n,m", PAPER_KERNELS, ids=[cnkm_name(n, m) for n, m in PAPER_KERNELS])
def test_differential_paper_kernel(n, m):
    _assert_differential(make_cnkm(n, m))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_differential_workload_family(family):
    _assert_differential(FAMILIES[family](**FAMILY_CASES[family]))


def _small_graph():
    sched, cg = _schedule_and_graph(make_cnkm(2, 6))
    return _port_graph(cg.bits), len(sched.dfg.ops)


def _engine(g, **kw):
    return port.DeviceSBTS(g, device="cpu", **kw)


def test_counter_rng_is_reproducible():
    g, _ = _small_graph()
    a, b = _engine(g, k=4, seed=11), _engine(g, k=4, seed=11)
    a.run(96)
    b.run(96)
    for f in FIELDS:
        np.testing.assert_array_equal(a._host(f), b._host(f))


def test_resume_is_bit_identical_to_one_shot():
    """run(30) + run(34) == run(64), across a chunk boundary too."""
    g, _ = _small_graph()
    split, whole = _engine(g, k=4, seed=5, chunk=16), _engine(g, k=4,
                                                             seed=5)
    split.run(30)
    split.run(34)
    whole.run(64)
    assert split.it == whole.it == 64
    for f in FIELDS:
        np.testing.assert_array_equal(split._host(f), whole._host(f))


def test_every_best_is_an_independent_set():
    g, _ = _small_graph()
    dev = _engine(g, k=8, seed=3)
    dev.run(128)
    assert dev.best.shape == (8, g.n) and dev.best.dtype == bool
    for row in dev.best:
        assert not g.any_conflict(pack_bool(row))
    for row in dev.in_s[:, :g.n]:
        assert not g.any_conflict(pack_bool(row))
    assert not dev.in_s[:, g.n:].any()


def test_tabu_is_respected_step_by_step():
    g, _ = _small_graph()
    dev = _engine(g, k=4, seed=9, chunk=1)
    saw_tabu = False
    for _ in range(80):
        before = dev.in_s
        tabu = dev.tabu
        it = dev.it
        dev.run(1)
        entered = dev.in_s & ~before
        assert not (entered & (tabu > it)).any(), \
            f"tabu-active vertex re-entered at it={it}"
        saw_tabu = saw_tabu or (dev.tabu > dev.it).any()
    assert saw_tabu, "80 iterations never produced an active tabu entry"


def test_rearm_and_reset_keep_invariants():
    g, n_ops = _small_graph()
    dev = _engine(g, k=4, seed=2)
    dev.run(64)
    best0 = dev.best[0].copy()
    dev.rearm(0)
    assert (dev.in_s[0, :g.n] <= best0).all()
    assert dev.in_s[0].sum() < best0.sum()
    assert (dev.tabu[0, :g.n][best0 & ~dev.in_s[0, :g.n]] > dev.it).all()
    assert dev.best_size[0] == dev.in_s[0].sum() and dev.stall[0] == 0
    dev.reset_seed(1)
    assert dev.best_size[1] == 0 and not dev.in_s[1].any()
    assert not dev.tabu[1].any()
    dev.run(64, target=n_ops)
    for row in dev.best:
        assert not g.any_conflict(pack_bool(row))


def test_run_counts_iterations_and_honours_cancel():
    from repro_torch.core.cancel import CancelToken
    from repro_torch.obs import Tracer
    g, _ = _small_graph()
    dev = _engine(g, k=2, seed=1, chunk=8)
    tr = Tracer()
    dev.run(20, tracer=tr)
    assert dev.it == 20 and tr.counter_value("portfolio.iters") == 20
    tok = CancelToken()
    tok.cancel()
    dev.run(50, cancel=tok)
    assert dev.it == 20
