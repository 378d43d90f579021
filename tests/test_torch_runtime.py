"""The port's training runtime: the counterpart of every test in
tests/test_runtime.py (the data pipeline's determinism, checkpoints,
fault recovery, elastic re-mesh, straggler mitigation) run on
`repro_torch`, plus the pipeline's batches bit-equal to the reference's,
and a smoke model's train state saved by each package and loaded by the
other (the format is the reference's: `repro_torch.checkpoint`), with an
equal forward after the load."""
from __future__ import annotations

import os

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import make_pipeline as ref_pipeline  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import (FailureInjector,  # noqa: E402
                                 StragglerMitigator, degraded_mesh_shape,
                                 plan_elastic_restart, run_with_recovery)
from repro_torch.runtime.fault import (HeartbeatMonitor,  # noqa: E402
                                       SimulatedFailure)


# ------------------------------------------------------------------ data
def test_pipeline_deterministic_and_stateless():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=3)
    p1, p2 = make_pipeline(cfg), make_pipeline(cfg)
    b1 = p1.batch(7)
    b2 = p2.batch(7)            # fresh pipeline, same step -> same batch
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = p1.batch(8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_pipeline_host_slicing_partitions_batch():
    cfg = DataConfig(vocab=128, seq_len=8, global_batch=6, seed=0)
    p = make_pipeline(cfg)
    full = p.batch(0)["tokens"]
    parts = [p.batch(0, host_slice=slice(i, i + 2))["tokens"]
             for i in (0, 2, 4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_pipeline_labels_shift():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=2, seed=1)
    b = make_pipeline(cfg).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("kw", [
    dict(vocab=32000, seq_len=64, global_batch=3, seed=5),
    dict(vocab=256, seq_len=20, global_batch=2, seed=1, n_vision_tokens=4,
         d_model=16),
    dict(vocab=256, seq_len=12, global_batch=2, seed=2, enc_seq=6,
         d_model=8)])
def test_pipeline_batches_equal_the_references(kw, tmp_path):
    for step in (0, 3):
        got = make_pipeline(DataConfig(**kw)).batch(step)
        want = ref_pipeline(RefDataConfig(**kw)).batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                np.array_equal(got[k], want[k]), k
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    kw = dict(vocab=1000, seq_len=16, global_batch=3, seed=4, kind="file",
              path=str(path))
    got = make_pipeline(DataConfig(**kw)).batch(2)
    want = ref_pipeline(RefDataConfig(**kw)).batch(2)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ----------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "opt": {"mu": torch.ones((4,)), "count": torch.tensor(3)}}
    save_checkpoint(str(tmp_path), state, 42)
    restored, manifest = load_checkpoint(str(tmp_path), state)
    assert manifest["step"] == 42
    assert torch.equal(restored["w"], state["w"])
    assert torch.equal(restored["opt"]["mu"], state["opt"]["mu"])


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), {"w": torch.ones((2, 3))}, 1)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"w": torch.ones((3, 3))})


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
    for step in range(1, 6):
        mgr.maybe_save({"x": torch.tensor(step)}, step)
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_00000004", "step_00000005"]


# -------------------------------------------------------- fault recovery
def _toy_loop(tmp_path, fail_at, n_steps=10, every=2):
    """Counting 'trainer': state = sum of batch means (deterministic)."""
    cfg = DataConfig(vocab=64, seq_len=4, global_batch=2, seed=0)
    data = make_pipeline(cfg)

    def train_step(state, batch):
        s = state + float(batch["tokens"].mean())
        return s, {"loss": s}

    mgr = CheckpointManager(str(tmp_path), every=every)
    inj = FailureInjector({fail_at: (1, "host_down")}) \
        if fail_at is not None else None
    return run_with_recovery(
        train_step=train_step, init_state=torch.tensor(0.0), data=data,
        ckpt_manager=mgr, n_steps=n_steps, injector=inj)


def test_recovery_reaches_same_final_state(tmp_path):
    ref_state, _, r0 = _toy_loop(tmp_path / "a", None)
    state, _, r1 = _toy_loop(tmp_path / "b", 5)
    assert r0 == 0 and r1 == 1
    # deterministic replay -> identical final state despite the failure
    np.testing.assert_allclose(float(state), float(ref_state), rtol=1e-6)


def test_recovery_bounded_loss(tmp_path):
    """A failure never loses more than ckpt_every steps of work."""
    _, history, restarts = _toy_loop(tmp_path, 7, n_steps=10, every=2)
    assert restarts == 1
    # replayed at most ckpt_every steps: total records <= 10 + 2
    assert len(history) <= 12


def test_max_restarts_exceeded(tmp_path):
    cfg = DataConfig(vocab=64, seq_len=4, global_batch=2, seed=0)
    data = make_pipeline(cfg)
    inj = FailureInjector({i: (0, "flaky") for i in range(100)})
    inj.fired = set()

    def always_fail_check(step):
        raise SimulatedFailure(step, 0)
    inj.check = always_fail_check
    mgr = CheckpointManager(str(tmp_path), every=1)
    with pytest.raises(SimulatedFailure):
        run_with_recovery(train_step=lambda s, b: (s, {}),
                          init_state=torch.tensor(0.0), data=data,
                          ckpt_manager=mgr, n_steps=3, injector=inj,
                          max_restarts=2)


def test_restart_with_no_checkpoint_takes_a_fresh_state(tmp_path):
    """A step that updates its state in place (as the port's train step
    updates its model) restarts from ``init_state()`` when there is no
    checkpoint to restore, not from the state it had changed."""
    cfg = DataConfig(vocab=64, seq_len=4, global_batch=2, seed=0)
    made = []

    def init_state():
        made.append(torch.zeros(()))
        return made[-1]

    def train_step(state, batch):
        state.add_(1.0)               # in place
        return state, {"loss": state}

    state, history, restarts = run_with_recovery(
        train_step=train_step, init_state=init_state,
        data=make_pipeline(cfg), ckpt_manager=CheckpointManager(
            str(tmp_path), every=100),
        n_steps=4, injector=FailureInjector({2: (0, "host")}))
    assert restarts == 1 and len(made) == 2
    assert float(state) == 4.0 and len(history) == 6


def test_heartbeat_monitor():
    mon = HeartbeatMonitor(4, timeout_s=10)
    for h in range(4):
        mon.beat(h, 0, t=100.0)
    mon.beat(2, 1, t=105.0)
    assert mon.dead_hosts(now=112.0) == [0, 1, 3]


# ---------------------------------------------------------------- elastic
def test_degraded_mesh_drops_pod_first():
    shape = {"pod": 2, "data": 16, "model": 16}
    out = degraded_mesh_shape(shape, n_failed_hosts=4, chips_per_host=64)
    assert out == {"pod": 1, "data": 16, "model": 16}


def test_degraded_mesh_then_data():
    shape = {"data": 16, "model": 16}
    out = degraded_mesh_shape(shape, n_failed_hosts=1, chips_per_host=16)
    assert out == {"data": 15, "model": 16}
    with pytest.raises(ValueError):
        degraded_mesh_shape({"data": 1, "model": 4}, 1, 16)


def test_elastic_restart_plan_adjusts_batch():
    new_shape, new_batch, notes = plan_elastic_restart(
        None, "train", 4096, 256, {"pod": 2, "data": 16, "model": 16},
        n_failed_hosts=4, chips_per_host=64)
    assert new_shape["pod"] == 1
    assert new_batch == 256           # 256 % 16 == 0 still
    new_shape, new_batch, _ = plan_elastic_restart(
        None, "train", 4096, 250, {"data": 16, "model": 16},
        n_failed_hosts=1, chips_per_host=16)
    assert new_batch % new_shape["data"] == 0


def test_elastic_restore_onto_another_device(tmp_path):
    """Checkpoints are device-agnostic: a state saved from one device
    restores onto the one ``device=`` names (the port's counterpart of
    restoring onto a smaller mesh's sharding)."""
    state = {"w": torch.arange(64.0).reshape(8, 8)}
    save_checkpoint(str(tmp_path), state, 5)
    restored, _ = load_checkpoint(str(tmp_path), state, device="cpu")
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], state["w"])


# --------------------------------------------------------------- straggler
def test_straggler_rebalances_rows():
    mit = StragglerMitigator(4, 16)
    for _ in range(5):
        for h, t in enumerate([1.0, 1.0, 1.0, 2.0]):   # host 3 slow
            mit.observe(h, t)
        rows = mit.rebalance()
    assert sum(rows) == 16
    assert rows[3] < 4              # slow host shed work
    assert max(rows) > 4            # a fast host absorbed it


def test_straggler_exclusion_after_patience():
    mit = StragglerMitigator(3, 6, exclude_ratio=1.5, patience=2)
    for _ in range(3):
        mit.observe(0, 1.0)
        mit.observe(1, 1.0)
        mit.observe(2, 3.0)
        mit.rebalance()
    assert mit.to_exclude() == [2]


@given(st.lists(st.floats(0.5, 4.0), min_size=2, max_size=8),
       st.integers(8, 64))
@settings(max_examples=30, deadline=None)
def test_straggler_conserves_global_batch(times, batch):
    mit = StragglerMitigator(len(times), batch)
    for _ in range(4):
        for h, t in enumerate(times):
            mit.observe(h, t)
        rows = mit.rebalance()
        assert sum(rows) == batch
        assert all(r >= 1 for r in rows)
    slices = mit.host_slices()
    assert slices[-1].stop == batch


# ------------------------------------------------- checkpoints across packages
ARCH = "zamba2-1.2b"


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)


def _ref_state():
    """The reference's train state after one step (nonzero moments)."""
    cfg = ref_smoke(ARCH)
    opt = RefAdamW(lr=1e-3)
    params = RM.init_params(cfg, 0)
    state = (params, opt.init(params), jnp.zeros((), jnp.int32))
    batch = {k: jnp.asarray(v) for k, v in ref_pipeline(RefDataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2)).batch(0).items()}
    return jax.jit(RM.make_train_step(cfg, opt))(state, batch)[0]


def _port_state(seed: int = 1):
    cfg = get_smoke_config(ARCH)
    model = M.init_params(cfg, seed, device="cpu").requires_grad_()
    opt = AdamW(lr=1e-3)
    state = (model, opt.init(dict(model.named_parameters())),
             torch.zeros((), dtype=torch.int32))
    batch = {k: torch.from_numpy(v) for k, v in make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2)).batch(0).items()}
    return M.make_train_step(cfg, opt)(state, batch)[0]


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    ref_state = _ref_state()
    ref_save(str(tmp_path), ref_state, 1)
    like = _port_state(seed=7)             # other weights, same shapes
    (model, opt_state, step), manifest = load_checkpoint(str(tmp_path),
                                                         like)
    assert manifest["step"] == 1 and int(step) == 1 and \
        step.dtype == torch.int32
    cfg = get_smoke_config(ARCH)
    got = convert.to_reference(cfg, model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state[0])):
        assert np.array_equal(a, np.asarray(b))
    for name in ("mu", "nu"):
        tree = convert.to_reference_tree(opt_state[name].items())
        for a, b in zip(jax.tree.leaves(tree),
                        jax.tree.leaves(ref_state[1][name])):
            assert np.array_equal(a, np.asarray(b))
    assert int(opt_state["count"]) == int(ref_state[1]["count"])
    toks = _tokens(cfg)
    want, _, _ = RT.forward(ref_smoke(ARCH), ref_state[0],
                            {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, _, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(
            toks)})
    assert float(np.abs(logits.numpy() - np.asarray(want)).max()) <= 0.15


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    model, opt_state, step = _port_state()
    save_checkpoint(str(tmp_path), (model, opt_state, step), 1)
    like = _ref_state()
    restored, manifest = ref_load(str(tmp_path), like)
    assert manifest["step"] == 1
    cfg = get_smoke_config(ARCH)
    want = convert.to_reference(cfg, model)
    for a, b in zip(jax.tree.leaves(restored[0]), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), b)
    mu = convert.to_reference_tree(opt_state["mu"].items())
    for a, b in zip(jax.tree.leaves(restored[1]["mu"]),
                    jax.tree.leaves(mu)):
        assert np.array_equal(np.asarray(a), b)
    assert np.asarray(restored[2]).dtype == np.int32 and \
        int(restored[2]) == 1
    toks = _tokens(cfg)
    want_logits, _, _ = RT.forward(ref_smoke(ARCH), restored[0],
                                   {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, _, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(
            toks)})
    assert float(np.abs(logits.numpy() - np.asarray(want_logits)).max()) \
        <= 0.15
