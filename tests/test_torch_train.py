"""The port's training step against the JAX package's, on the CPU.

One `make_train_step` step of the port against the reference's jitted
`make_train_step` with ``AdamW(lr=1e-3)`` (tests/test_models.py:57-69),
on every arch's smoke config and a 2-layer model of lm100m's widths
(`launch.train.LM100M` cut to 2 layers), from the reference's weights
carried over by `convert.from_reference` and one batch of each
package's data pipeline (bit-equal batches, tests/test_torch_runtime.py).

In fp32 compute (both packages' dense layers, embeddings, tied
unembeddings and MoE products in float32, `_torch_compare.fp32_compute`)
the loss, ``ce``, ``aux``, ``zloss`` and ``grad_norm`` agree within
1e-4 (relative, plus 1e-6); every gradient leaf (against the
reference's jitted ``jax.value_and_grad`` of `loss_fn`) within
max |d| <= 1e-4 max |ref| + 1e-6; and every updated parameter within
the same bound wherever the reference's clipped gradient is at least
100 eps = 1e-6 in magnitude.  Below that, Adam's first step g / (|g| +
eps) turns fp32 noise in g into a different update (its slope there
is up to 1 / eps: zamba2's ``in_x.w`` has an entry with g = -1.3e-8,
whisper's attention key bias, whose true gradient is zero, has g ~
1e-6 of noise before the clip scale), so there each parameter is held
to the most that step can move it, lr (1 + weight_decay |p|) each way.

In bf16 (the default compute) the loss is held at the family tolerance
(atol = rtol: 0.15 for ``ssm`` and ``hybrid``, 3e-2 otherwise, the
reference's tests/test_models.py:100) against the reference compiled
without excess precision (`_torch_compare.strict_jit`).  Two steps of
the port on the same batch lower the loss, as the reference's test
asserts of its own.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from _torch_compare import fp32_compute, strict_jit  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import make_pipeline as ref_pipeline  # noqa: E402
from repro.launch.train import LM100M as REF_LM100M  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.launch.train import LM100M  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

LR = 1e-3
TOL = 1e-4
FAMILY_TOL = {"ssm": 0.15, "hybrid": 0.15, "dense": 3e-2, "moe": 3e-2,
              "encdec": 3e-2}
CONFIGS = tuple(ARCHS) + ("lm100m-2l",)


def _configs(name: str):
    if name == "lm100m-2l":
        return (dataclasses.replace(REF_LM100M, n_layers=2),
                dataclasses.replace(LM100M, n_layers=2))
    return ref_configs.get_smoke_config(name), get_smoke_config(name)


@pytest.fixture(scope="module", params=CONFIGS)
def case(request):
    """One config in both packages, the reference's weights, and one
    batch (B = 2, S = 32) from each package's pipeline."""
    ref_cfg, cfg = _configs(request.param)
    params = RM.init_params(ref_cfg, 0)
    data = dict(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0,
                n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model,
                enc_seq=cfg.enc_seq)
    return types.SimpleNamespace(
        name=request.param, ref_cfg=ref_cfg, cfg=cfg, params=params,
        params_np=jax.tree.map(np.asarray, params),
        batch=make_pipeline(DataConfig(**data)).batch(0),
        ref_batch=ref_pipeline(RefDataConfig(**data)).batch(0))


def _model(case):
    return convert.from_reference(case.cfg, case.params_np,
                                  device="cpu").requires_grad_()


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_step(case, model):
    opt = AdamW(lr=LR)
    state = (model, opt.init(dict(model.named_parameters())),
             torch.zeros((), dtype=torch.int32))
    return M.make_train_step(case.cfg, opt)(state,
                                            _torch_batch(case.batch))


def _close(got, want, what: str) -> None:
    got, want = float(got), float(want)
    assert abs(got - want) <= TOL * abs(want) + 1e-6, (what, got, want)


def _leaf_bound(got, want, what: str) -> None:
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = TOL * float(np.abs(want).max(initial=0.0)) + 1e-6
    assert err <= bound, (what, err, bound)


def test_batches_are_the_references(case):
    for k in case.ref_batch:
        assert np.array_equal(case.batch[k], case.ref_batch[k]), k


def test_fp32_train_step_matches_the_reference(case, monkeypatch):
    fp32_compute(monkeypatch)
    ref_opt = RefAdamW(lr=LR)
    ref_state = (case.params, ref_opt.init(case.params),
                 jnp.zeros((), jnp.int32))
    batch = _jax_batch(case.ref_batch)
    (ref_params, _, _), ref_metrics = jax.jit(
        RM.make_train_step(case.ref_cfg, ref_opt))(ref_state, batch)
    (_, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(case.ref_cfg, p, batch), has_aux=True))(
        case.params)

    model = _model(case)
    with torch.enable_grad():
        loss, _ = M.loss_fn(case.cfg, model, _torch_batch(case.batch))
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
    grads = convert.to_reference_tree(
        zip(dict(model.named_parameters()), grads))
    (model, opt_state, step), metrics = _port_step(case, model)

    assert int(step) == 1 and int(opt_state["count"]) == 1
    for key in ("loss", "ce", "aux", "zloss", "grad_norm"):
        _close(metrics[key], ref_metrics[key], key)
    assert int(metrics["ntokens"]) == int(ref_metrics["ntokens"])
    assert set(metrics) == set(ref_metrics)

    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert jax.tree.structure(ref_grads) == jax.tree.structure(grads)
    for (path, want), got in zip(ref_leaves, jax.tree.leaves(grads)):
        _leaf_bound(got, np.asarray(want), f"grad {jax.tree_util.keystr(path)}")

    scale = min(1.0, 1.0 / (float(ref_metrics["grad_norm"]) + 1e-9))
    new = convert.to_reference(case.cfg, model)
    ill = 0
    for (path, want), got, g in zip(
            jax.tree_util.tree_flatten_with_path(ref_params)[0],
            jax.tree.leaves(new), jax.tree.leaves(ref_grads)):
        want, g = np.asarray(want), np.asarray(g) * scale
        what = f"param {jax.tree_util.keystr(path)}"
        well = np.abs(g) >= 100 * ref_opt.eps
        ill += int((~well).sum())
        _leaf_bound(got[well], want[well], what)
        move = LR * (1 + ref_opt.weight_decay * np.abs(want[~well]))
        assert (np.abs(got[~well] - want[~well]) <= 2 * move).all(), what
    print(f"{case.name}: {ill} parameter entries under 100 eps of gradient")


def test_bf16_loss_matches_the_strict_reference(case):
    want, _ = strict_jit(lambda p, b: RM.loss_fn(case.ref_cfg, p, b))(
        case.params, _jax_batch(case.ref_batch))
    with torch.no_grad():
        got, _ = M.loss_fn(case.cfg, _model(case), _torch_batch(case.batch))
    tol = FAMILY_TOL[case.cfg.family]
    assert abs(float(got) - float(want)) <= tol + tol * abs(float(want))


def test_two_steps_on_one_batch_lower_the_loss(case):
    model = _model(case)
    opt = AdamW(lr=LR)
    state = (model, opt.init(dict(model.named_parameters())),
             torch.zeros((), dtype=torch.int32))
    step = M.make_train_step(case.cfg, opt)
    batch = _torch_batch(case.batch)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"])
    assert all(torch.isfinite(p).all() for p in state[0].parameters())
    assert int(state[2]) == 2 and float(m2["step"]) == 1.0
