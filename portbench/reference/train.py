"""The reference's first training steps: the plain model's loss and
gradients (`reference.model`) and AdamW with global-norm clipping and a
linear warm-up, written out leaf by leaf, from the benchmark's weights
and batches.  It returns what the correctness check compares: each
step's loss, each leaf's norm of the first clipped gradient, and each
leaf's norm of its change over the steps.
"""

from __future__ import annotations

import math

import torch

from . import model as R
from .precision import Products, fp32_products


def learning_rate(opt: dict, count: int) -> float:
    """The schedule at optimizer step ``count`` (from 1): a linear
    warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total_steps``."""
    base, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if count < warm:
        return base * count / max(warm, 1)
    prog = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * base * (1 + math.cos(math.pi * prog))


def adamw(opt: dict, params: list, grads: list, mu: list, nu: list,
          count: int) -> list:
    """One AdamW step in place on ``params``; returns the clipped
    gradients.  update = -lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    lr = learning_rate(opt, count)
    clipped = []
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            g = g * scale
            clipped.append(g)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            step = (m / c1) / (torch.sqrt(v / c2) + opt["eps"]) + \
                opt["weight_decay"] * p
            p.add_(-lr * step)
    return clipped


def leaf_norms(tensors) -> list[float]:
    return torch.stack([t.detach().norm() for t in tensors]).tolist()


def readings(cfg: dict, opt: dict, weights: dict, batches: list, *,
             precision: str = "float32", remat: bool = True) -> dict:
    """Train the reference from ``weights`` (name -> float32 tensor, in
    `model.param_specs` order; not modified) on ``batches`` in turn.
    Returns {"losses": [...], "grad_norms": {name: norm of the first
    clipped gradient}, "change_norms": {name: norm of the change over
    the steps}, "dims": {name: its number of dimensions}}."""
    names = list(weights)
    params = [weights[k].detach().clone().requires_grad_() for k in names]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    pr = Products(precision)
    losses, first = [], None
    with fp32_products():
        for count, batch in enumerate(batches, start=1):
            w = dict(zip(names, params))
            with torch.enable_grad():
                loss = R.loss(cfg, pr, w, batch, remat=remat)
                grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            clipped = adamw(opt, params, list(grads), mu, nu, count)
            if first is None:
                first = leaf_norms(clipped)
            del grads, clipped, loss
    change = leaf_norms(p - weights[k] for p, k in zip(params, names))
    return {"losses": losses, "grad_norms": dict(zip(names, first)),
            "change_norms": dict(zip(names, change)),
            "dims": {k: weights[k].dim() for k in names}}
