"""The port's training gradients against the JAX package's at the
published widths of the families whose training steps run on the card
past the smoke configs: mamba2-2.7b (the ssm family) cut to 1 of its 64
layers at (1, 256), which takes the SSD scan at N = 128 with 80 heads of
64 and chunk 256 (on the CPU, the plain chunked scan and its autograd),
and whisper-tiny (encdec) uncut at (2, 64) over its 1500 encoder frames
(the encoder, the cross-attention and the tied unembedding).

Both packages start from the reference's weights
(`repro.models.model.init_params(cfg, 0)`, carried over by
`convert.from_reference`) and one batch of each package's data pipeline
(bit-equal, tests/test_torch_runtime.py).  In fp32 compute
(`_torch_compare.fp32_compute`) the loss and its terms agree within 1e-4
(relative, plus 1e-6), and every gradient leaf of the port's
`torch.autograd` is within 1e-4 max |ref| + 1e-6 of the reference's
``jax.grad``, as tests/test_torch_train.py holds the smoke configs.

A slow test runs each trainer's first steps on starcoder2-7b at its
published widths cut to 1 layer: `launch.train.build`'s schedule and
AdamW from the same weights over the same batches, in the default bf16
compute.  Each step's loss is held to the reference's at the dense
family's tolerance (3e-2, as tests/test_torch_train.py), and both curves
are printed: at lr 3e-4 both rise after Adam's first full step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from _torch_compare import fp32_compute  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import make_pipeline as ref_pipeline  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402

TOL = 1e-4
# arch -> (layers kept, None for all; (batch, seq))
CASES = {"mamba2-2.7b": (1, (1, 256)), "whisper-tiny": (None, (2, 64))}


@pytest.mark.parametrize("arch", list(CASES))
def test_fp32_gradients_at_published_widths_match_jax_grad(arch,
                                                           monkeypatch):
    layers, (b, s) = CASES[arch]
    cut = {} if layers is None else {"n_layers": layers}
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **cut)
    cfg = dataclasses.replace(get_config(arch), **cut)
    fp32_compute(monkeypatch)
    params = RM.init_params(ref_cfg, 0)
    data = dict(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0,
                n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model,
                enc_seq=cfg.enc_seq)
    batch = make_pipeline(DataConfig(**data)).batch(0)
    ref_batch = ref_pipeline(RefDataConfig(**data)).batch(0)
    for k in ref_batch:
        assert np.array_equal(batch[k], ref_batch[k]), k
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, {k: jnp.asarray(v) for k, v in
                                          ref_batch.items()}),
        has_aux=True))(params)

    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu").requires_grad_()
    scans = []
    real = ssd_ops.ssd
    monkeypatch.setattr(ssd_ops, "ssd",
                        lambda *a, **kw: scans.append(tuple(a[3].shape)) or
                        real(*a, **kw))
    with torch.enable_grad():
        loss, aux = M.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
    # mamba2's layer scans at its published state width (B of (batch,
    # seq, groups, N)); whisper runs no scan.
    assert set(scans) == ({(b, s, 1, 128)} if cfg.family == "ssm" else
                          set())
    for got, want, key in ((loss, ref_loss, "loss"),
                           (aux["ce"], ref_aux["ce"], "ce"),
                           (aux["zloss"], ref_aux["zloss"], "zloss")):
        got, want = float(got.detach()), float(want)
        assert abs(got - want) <= TOL * abs(want) + 1e-6, (key, got, want)
    grads = convert.to_reference_tree(
        zip(dict(model.named_parameters()), grads))
    assert jax.tree.structure(ref_grads) == jax.tree.structure(grads)
    worst = 0.0
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(ref_grads)[0],
            jax.tree.leaves(grads)):
        want = np.asarray(want)
        err = float(np.abs(got - want).max()) if want.size else 0.0
        bound = TOL * float(np.abs(want).max(initial=0.0)) + 1e-6
        worst = max(worst, err / bound)
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
    print(f"{arch}: worst gradient leaf at {worst:.3f} of its bound")


STEPS = 3


@pytest.mark.slow
@pytest.mark.parametrize("lr", [3e-4, 3e-5])
def test_starcoder2_first_steps_follow_the_reference(lr):
    """Three steps of each trainer (`launch.train.build`'s warm-up and
    cosine over ``STEPS``) at (1, 256), one batch of the pipeline a step."""
    arch, cut, (b, s) = "starcoder2-7b", {"n_layers": 1}, (1, 256)
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **cut)
    cfg = dataclasses.replace(get_config(arch), **cut)
    data = dict(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0,
                n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model,
                enc_seq=cfg.enc_seq)
    warmup = max(STEPS // 20, 1)

    params = RM.init_params(ref_cfg, 0)
    params_np = jax.tree.map(np.asarray, params)
    opt = RefAdamW(lr=ref_cosine(lr, warmup, STEPS))
    state = (params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(RM.make_train_step(ref_cfg, opt))
    pipe, want = ref_pipeline(RefDataConfig(**data)), []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in pipe.batch(i).items()})
        want.append(float(m["loss"]))
    del state, params, step

    model = convert.from_reference(cfg, params_np,
                                   device="cpu").requires_grad_()
    del params_np
    opt = AdamW(lr=cosine_schedule(lr, warmup, STEPS))
    state = (model, opt.init(dict(model.named_parameters())),
             torch.zeros((), dtype=torch.int32))
    step = M.make_train_step(cfg, opt)
    pipe, got = make_pipeline(DataConfig(**data)), []
    for i in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in pipe.batch(i).items()})
        got.append(float(m["loss"]))
    print(f"{arch} 1 layer lr {lr}: reference {want}, port {got}")
    tol = 3e-2
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g) and abs(g - w) <= tol + tol * abs(w), (i, g, w)
