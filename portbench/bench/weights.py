"""The benchmark's weights, made from the seed on the device in a few
large calls: one float32 buffer holds every parameter in the order of
`reference.model.param_specs`, filled by one truncated-normal draw (a
standard normal cut to [-2, 2]), then each kind set at once:

- ``fan_in``: times shape[0] ** -0.5 (a dense layer's d_in, a
  convolution's width);
- ``table``: the embedding, times `TABLE_STD` (mamba_ssm's and GPT-2's
  initialiser range: a tied unembedding's logits then start near unit
  scale);
- ``ones``, ``zeros``: norm scales and the skip; the convolution bias;
- ``a_log``: log A with A uniform in [1, 16], and ``dt_bias``: the
  inverse softplus of dt log-uniform in [1e-3, 1e-1] (the Mamba2 paper's
  initialisation of its heads).

The same seed gives the same numbers on the same device, so the
reference makes its copy again after the window instead of keeping one.
"""

from __future__ import annotations

import math

import torch

from .seeds import substream

TABLE_STD = 0.02
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)


def make(specs, seed: int, device) -> tuple[torch.Tensor, dict]:
    """(the flat buffer, name -> view of it) for ``specs`` (name, shape,
    kind)."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(
        substream(seed, "weights"))
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    views, kinds = {}, {}
    for (name, shape, kind), view in zip(specs, torch.split(flat, sizes)):
        views[name] = view.view(shape)
        kinds.setdefault(kind, []).append((name, shape))
    with torch.no_grad():
        scaled = [(k, s[0] ** -0.5) for k, s in kinds.get("fan_in", [])] + \
            [(k, TABLE_STD) for k, _ in kinds.get("table", [])]
        if scaled:
            torch._foreach_mul_([views[k] for k, _ in scaled],
                                [c for _, c in scaled])
        for kind, value in (("ones", 1.0), ("zeros", 0.0)):
            if kind in kinds:
                group = [views[k] for k, _ in kinds[kind]]
                torch._foreach_zero_(group)
                torch._foreach_add_(group, value)
        for kind, fill in (("a_log", _a_log), ("dt_bias", _dt_bias)):
            if kind in kinds:
                group = [views[k] for k, _ in kinds[kind]]
                u = torch.rand(sum(v.numel() for v in group), device=device,
                               generator=gen)
                torch._foreach_copy_(group, torch.split(
                    fill(u), [v.numel() for v in group]))
    return flat, views


def _a_log(u):
    lo, hi = A_RANGE
    return torch.log(lo + (hi - lo) * u)


def _dt_bias(u):
    lo, hi = (math.log(v) for v in DT_RANGE)
    dt = torch.exp(lo + (hi - lo) * u)
    return dt + torch.log(-torch.expm1(-dt))
