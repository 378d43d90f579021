"""The plain reference against `repro_torch` on the CPU at smoke widths,
both in float32: the loss and every gradient leaf of a step on the
benchmark's weights and batch, and AdamW's update from one set of
gradients."""

from __future__ import annotations

import pytest
import torch

from portbench.bench import spec, weights
from portbench.reference import model as R
from portbench.reference import train as RT
from portbench.reference.precision import Products
from portbench.tests import smoke


def fp32_compute(monkeypatch) -> None:
    """The port's dense layers, embedding and unembedding in float32."""
    from repro_torch.models import layers as L
    monkeypatch.setitem(L.dense.__kwdefaults__, "compute_dtype",
                        torch.float32)
    monkeypatch.setattr(L.embed, "__defaults__", (torch.float32,))
    monkeypatch.setattr(L.unembed, "__defaults__",
                        (torch.float32, torch.float32))


@pytest.mark.parametrize("name", sorted(smoke.CELLS))
def test_reference_step_agrees_with_the_port(tmp_path, monkeypatch, name):
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    smoke.use_smoke_widths(monkeypatch)
    fp32_compute(monkeypatch)
    root = smoke.make_root(str(tmp_path))
    cell = spec.cell(root, name + "-cell")
    kind = spec.load(root, "kinds", cell.traffic["kind"])
    seed = 2 ** 40 + 3
    prog = kind.Program(cell, seed, "cpu")
    model, batch = prog.state[0], prog.batch(0)
    params = dict(model.named_parameters())
    names = list(params)
    loss_p, _ = M.loss_fn(prog.cfg, model, batch)
    grads_p = torch.autograd.grad(loss_p, list(params.values()))

    _, w = weights.make(R.param_specs(cell.config), seed, "cpu")
    assert list(w) == names
    leaves = [w[k].clone().requires_grad_() for k in names]
    loss_r = R.loss(cell.config, Products(), dict(zip(names, leaves)),
                    batch)
    grads_r = torch.autograd.grad(loss_r, leaves)
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()),
                                                 rel=1e-5)
    for k, gp, gr in zip(names, grads_p, grads_r):
        scale = float(gr.abs().max()) + 1e-12
        assert float((gp - gr).abs().max()) <= 1e-4 * scale, k

    opt = cell.traffic["optimizer"]
    adamw = AdamW(lr=cosine_schedule(opt["lr"], opt["warmup"],
                                     opt["total_steps"]))
    grads = {k: g.detach() for k, g in zip(names, grads_r)}
    port = {k: w[k].clone() for k in names}
    state = adamw.init(port)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    for count in (1, 2):
        updates, state = adamw.update(grads, state, port)
        for k in names:
            port[k] += updates[k]
        RT.adamw(opt, leaves, [g.detach() for g in grads_r], mu, nu, count)
    ulp = torch.finfo(torch.float32).eps
    for k, p in zip(names, leaves):
        # Two updates of ~lr added to each weight: equal to a few last bits.
        gap = (p.detach() - port[k]).abs()
        assert bool((gap <= 4 * ulp * w[k].abs() + 1e-9).all()), \
            (k, float(gap.max()))
        assert not torch.equal(p.detach(), w[k]), k
