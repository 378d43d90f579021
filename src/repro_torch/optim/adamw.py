"""AdamW with global-norm clipping and a cosine LR schedule, as the
reference's ``repro/optim/adamw.py`` computes them (not
`torch.optim.AdamW`, whose decay is a different formula).

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names (``dict(model.named_parameters())``).  Moments
are float32; `AdamW.update` returns the update as a delta in each
parameter's type, as the reference does, so the train step adds it.
The operations run in the reference's order: the clip scale, ``mu``,
``nu``, the bias corrections ``c1``, ``c2`` with ``count`` from 1, then
``step + weight_decay * p`` and ``-lr * step``.  Unlike the reference's
pure function, `update` advances ``mu`` and ``nu`` in place (two fp32
copies of the model are the optimizer's largest tensors), and returns
the same dicts in the new state.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warmup over ``warmup`` steps, then a cosine decay
    to 0 at ``total``; float32, as the reference computes it."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | object = 3e-4          # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: dict) -> dict:
        """Zero fp32 moments for ``params`` (name -> tensor) and a
        0-d int32 ``count`` on their device."""
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        dev = next(iter(params.values())).device if params else None
        return {"mu": zeros,
                "nu": {k: torch.zeros_like(z) for k, z in zeros.items()},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads: dict, state: dict, params: dict):
        """(updates, new state): ``updates`` name -> delta in the
        parameter's type.  ``grads`` and ``params`` have the moments'
        keys."""
        names = list(state["mu"])
        count = state["count"] + 1
        g = [grads[k].to(torch.float32) for k in names]

        # global-norm clip
        gnorm = torch.sqrt(sum(torch.sum(torch.square(t)) for t in g))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        g = torch._foreach_mul(g, scale)

        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - self.b2))
        cnt = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                        device=cnt.device), cnt)
        c2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                        device=cnt.device), cnt)
        lr = self.lr(count) if callable(self.lr) else self.lr

        step = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(step, den)
        del den
        p32 = [params[k].to(torch.float32) for k in names]
        torch._foreach_add_(step, torch._foreach_mul(p32, self.weight_decay))
        step = torch._foreach_mul(step, -lr)
        updates = {k: s.to(params[k].dtype) for k, s in zip(names, step)}
        return updates, {"mu": state["mu"], "nu": state["nu"],
                         "count": count}
