"""The port's optimizer (`repro_torch.optim`) against the JAX package's:
the cosine schedule and AdamW's update on random trees (with and
without the global-norm clip firing, over several steps), and the int8
gradient compression, whose codes are the reference's bit for bit
(`torch.round` and `jnp.round` both round half to even), with the error
feedback's sums."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

SHAPES = {"embed.table": (50, 8), "layers.0.attn.q.w": (8, 2, 4),
          "layers.1.attn.q.w": (8, 2, 4), "final_norm.scale": (8,),
          "odd.b": (300,)}


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _ref(tree: dict) -> dict:
    """The reference's view: a flat dict of jax arrays (the optimizer
    takes any pytree)."""
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port(tree: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("warmup,total", [(0, 10), (5, 100), (20, 1000),
                                          (10, 10)])
def test_cosine_schedule_matches_the_reference(warmup, total):
    ref, port = ref_cosine(3e-4, warmup, total), cosine_schedule(
        3e-4, warmup, total)
    for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 7}):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = float(port(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * 3e-4, (step, got, want)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_adamw_update_matches_the_reference(grad_scale, lr):
    """Three steps; the clip fires at grad_scale 10 (global norm ~ 10^2)
    and not at 1e-3."""
    ref_opt = RefAdamW(lr=3e-4 if lr == "const" else ref_cosine(3e-4, 2, 10))
    opt = AdamW(lr=3e-4 if lr == "const" else cosine_schedule(3e-4, 2, 10))
    params = _tree(0)
    ref_p, p = _ref(params), _port(params)
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for it in range(3):
        grads = _tree(10 + it, grad_scale)
        ref_u, ref_s = ref_opt.update(_ref(grads), ref_s, ref_p)
        u, s = opt.update(_port(grads), s, p)
        assert int(s["count"]) == int(ref_s["count"]) == it + 1
        for k in SHAPES:
            assert u[k].dtype == p[k].dtype
            for got, want in ((u[k], ref_u[k]), (s["mu"][k], ref_s["mu"][k]),
                              (s["nu"][k], ref_s["nu"][k])):
                want = np.asarray(want)
                err = np.abs(got.numpy() - want).max()
                assert err <= 1e-6 * np.abs(want).max() + 1e-12, (k, it)
        ref_p = jax.tree.map(lambda a, b: a + b, ref_p, ref_u)
        p = {k: p[k] + u[k] for k in p}


def test_adamw_keeps_the_parameter_dtype():
    opt = AdamW()
    p = {"a.w": torch.ones(4, dtype=torch.bfloat16)}
    s = opt.init(p)
    assert s["mu"]["a.w"].dtype == torch.float32 and \
        s["count"].dtype == torch.int32
    u, _ = opt.update({"a.w": torch.full((4,), 0.5, dtype=torch.bfloat16)},
                      s, p)
    assert u["a.w"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(7,), (256,), (3, 100), (2, 2, 129)])
def test_compression_codes_are_the_references(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * 3).astype(np.float32)
    # Values on a rounding tie: q = round(x / scale) lands on .5 exactly.
    g.reshape(-1)[:3] = [127.0, 63.5, -0.5]
    ref = ref_comp.compress_grads({"w": jnp.asarray(g)})["w"]
    got = compression.compress_grads({"w": torch.from_numpy(g)})["w"]
    assert got["q"].dtype == torch.int8
    assert np.array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    assert np.array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    est = compression.decompress_grads({"w": got}, {"w": torch.from_numpy(g)})
    want = ref_comp.decompress_grads({"w": ref}, {"w": jnp.asarray(g)})
    assert np.array_equal(est["w"].numpy(), np.asarray(want["w"]))


def test_error_feedback_matches_the_reference():
    grads = [_tree(20 + i) for i in range(3)]
    ref_err = err = None
    for g in grads:
        carried = err
        ref_c, ref_est, ref_err = ref_comp.error_feedback_update(_ref(g),
                                                                 ref_err)
        c, est, err = compression.error_feedback_update(_port(g), err)
        for k in SHAPES:
            assert np.array_equal(c[k]["q"].numpy(), np.asarray(ref_c[k]["q"]))
            assert np.array_equal(est[k].numpy(), np.asarray(ref_est[k]))
            assert np.array_equal(err[k].numpy(), np.asarray(ref_err[k]))
            # The estimate and the new error add up to the corrected
            # gradient (the carried error added): nothing is lost.
            corrected = torch.from_numpy(g[k]) + (
                0 if carried is None else carried[k])
            assert torch.allclose(est[k] + err[k], corrected, rtol=0,
                                  atol=1e-6)
