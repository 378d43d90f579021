"""Mixture-of-experts FFN (mixtral: 8 routed top-2; deepseek-v2-lite:
2 shared + 64 routed top-6), as the reference's ``models/moe.py``.

Dispatch is sort-based: tokens are flattened, sorted by assigned expert,
pushed through the experts' weights as ragged groups, and combined with
the router weights.  The grouped products are `kernels.ragged_dot`: the
CUDA kernel for tensors on the card (it reads the group offsets there,
so a layer makes no host sync, and it takes the fp32 expert stacks as
they are stored, rounding them to bf16 as it loads them), its plain
torch version on the CPU.
The capacity path (``ModelConfig.moe_impl == "capacity"``) packs the
tokens into an (E, cap, D) buffer and takes batched products, as the
reference computes it outside any kernel.

Orders that fix the bf16 roundings, kept as the reference's:

- the top-k is a stable descending sort of the fp32 router logits
  (``lax.top_k``: on ties the lower expert first);
- the dispatch sort is stable (``jnp.argsort``'s default);
- the combine adds each token's k weighted rows to zero one at a time,
  rounding after each add, in the sorted (expert-ascending) order, as
  the reference's scatter-add does.  It is a gather through the inverse
  permutation and k adds, where an ``index_add_`` on the card would add
  in no fixed order;
- the capacity buffer is filled by a plain scatter to distinct slots
  (dropped rows go to a spare slot that is cut off).

The planner (core/planner.py) treats the expert weights as the
highest-spatial-reuse tensors of MoE archs: every token block on every
device needs the same expert shard, so BandMap allocates them multicast
rather than relay hops.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.ragged_dot import ops as rd_ops

from . import layers as L


class MoE(nn.Module):
    """The router, the stacked expert weights (E, D, F) / (E, F, D) and,
    with ``n_shared``, one shared gated MLP of width ``shared_d_ff *
    n_shared`` (the reference's ``moe_init``)."""

    def __init__(self, d_model: int, *, n_experts: int, moe_d_ff: int,
                 n_shared: int = 0, shared_d_ff: int | None = None,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.router = L.Dense(d_model, n_experts, **kw)
        self.w_gate = L._param(L.truncnorm(
            (n_experts, d_model, moe_d_ff), d_model ** -0.5, device,
            generator))
        self.w_up = L._param(L.truncnorm(
            (n_experts, d_model, moe_d_ff), d_model ** -0.5, device,
            generator))
        self.w_down = L._param(L.truncnorm(
            (n_experts, moe_d_ff, d_model), moe_d_ff ** -0.5, device,
            generator))
        self.shared = L.MLP(d_model, (shared_d_ff or moe_d_ff) * n_shared,
                            **kw) if n_shared else None

    def forward(self, x, *, top_k: int, impl: str = "ragged"):
        """x (B, S, D) -> (out (B, S, D), the router's aux loss)."""
        fn = moe_ffn_capacity if impl == "capacity" else moe_ffn
        return fn(self, x, top_k=top_k)


def route(p: MoE, xf, top_k: int):
    """fp32 router logits (T, E), the top-k gate weights softmaxed over k
    (T, k) and the experts (T, k), best first, ties to the lower
    expert."""
    logits = L.scores("td,de->te", xf, p.router.w, rows="t")
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_w = torch.softmax(vals[:, :top_k], dim=-1)
    return logits, gate_w, idx[:, :top_k]


def dispatch(gate_i, n_experts: int):
    """The stable sort of the (token, slot) rows by expert: (order, the
    token of each sorted row, the group offsets (E + 1,) int32).  The
    offsets come from a search of the sorted experts, on the device."""
    t, top_k = gate_i.shape
    flat_expert = gate_i.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_tok = torch.div(order, top_k, rounding_mode="floor")
    bounds = torch.arange(n_experts + 1, device=gate_i.device,
                          dtype=flat_expert.dtype)
    offsets = torch.searchsorted(flat_expert[order], bounds).to(torch.int32)
    return order, sorted_tok, offsets


def combine(rows, order, t: int, top_k: int):
    """The reference's ``zeros((t, d)).at[sorted_tok].add(rows)``: each
    token's k rows (``rows`` in sorted order) added to zero one by one,
    in sorted order, rounding to the rows' type after each add."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.sort(inv.view(t, top_k), dim=1).values
    picked = rows[pos.reshape(-1)].view(t, top_k, -1)
    out = torch.zeros_like(picked[:, 0])
    for j in range(top_k):
        out = out + picked[:, j]
    return out


def moe_ffn(p: MoE, x, *, top_k: int, compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> ((B, S, D), aux).  Router in fp32 for numerics."""
    b, s, d = x.shape
    n_experts = p.router.w.shape[-1]
    xf = x.reshape(b * s, d)
    t = b * s

    logits, gate_w, gate_i = route(p, xf, top_k)
    order, sorted_tok, offsets = dispatch(gate_i, n_experts)
    sorted_w = gate_w.reshape(-1)[order]

    xd = xf.to(compute_dtype)[sorted_tok]                   # (T*k, D)
    # The stacks go as they are stored: the grouped product rounds fp32
    # weights to bf16 as it loads them (the reference's astype).
    gate = rd_ops.ragged_dot(xd, p.w_gate, offsets)
    up = rd_ops.ragged_dot(xd, p.w_up, offsets)
    h = L.silu(gate) * up                                   # (T*k, F)
    y = rd_ops.ragged_dot(h, p.w_down, offsets)

    y = y * sorted_w[:, None].to(y.dtype)
    out = combine(y, order, t, top_k)

    # The aux loss before the shared MLP: under remat the recomputation
    # stops after the last tensor the backward saves, so the shared
    # MLP's last product (whose output the backward does not need) is
    # not rerun, as XLA drops it from the reference's recomputation.
    aux = router_load_balancing_loss(logits, gate_i, n_experts, top_k)
    if p.shared is not None:
        out = out + p.shared(xf)
    return out.reshape(b, s, d), aux


def moe_ffn_capacity(p: MoE, x, *, top_k: int,
                     capacity_factor: float = 1.25,
                     compute_dtype=torch.bfloat16):
    """Capacity-based MoE: the sorted rows packed into an (E, cap, D)
    buffer (cap = ceil(T k / E) * capacity_factor; rows past it are
    dropped), one batched product per projection, and the weighted
    combine of the kept rows."""
    bsz, s, d = x.shape
    n_experts = p.router.w.shape[-1]
    xf = x.reshape(bsz * s, d)
    t = bsz * s

    logits, gate_w, gate_i = route(p, xf, top_k)
    cap = max(int(-(-t * top_k // n_experts) * capacity_factor), 1)
    order, stok, offsets = dispatch(gate_i, n_experts)
    se = gate_i.reshape(-1)[order]
    sw = gate_w.reshape(-1)[order]
    slot = torch.arange(se.numel(), device=se.device) - offsets[se]
    keep = slot < cap
    dest = se * cap + torch.where(keep, slot, 0)

    # Kept rows go to distinct slots; dropped ones to a spare row that is
    # cut off (the reference adds zeros for them).
    spare = torch.where(keep, dest, n_experts * cap)
    xe = torch.zeros((n_experts * cap + 1, d), dtype=compute_dtype,
                     device=x.device)
    xe[spare] = xf.to(compute_dtype)[stok]
    xe = xe[:-1].view(n_experts, cap, d)

    gate = L.product(torch.bmm, xe, p.w_gate.to(compute_dtype))
    up = L.product(torch.bmm, xe, p.w_up.to(compute_dtype))
    h = L.silu(gate) * up
    y = L.product(torch.bmm, h, p.w_down.to(compute_dtype)).reshape(
        n_experts * cap, d)

    contrib = y[dest] * (sw * keep)[:, None].to(y.dtype)
    out = combine(contrib, order, t, top_k)

    aux = router_load_balancing_loss(logits, gate_i, n_experts, top_k)
    if p.shared is not None:      # after the aux loss, as in `moe_ffn`
        out = out + p.shared(xf)
    return out.reshape(bsz, s, d), aux


def router_load_balancing_loss(logits, gate_i, n_experts: int, top_k: int):
    """Switch-style auxiliary load-balancing loss (fraction-dot-
    probability), returned for the training objective."""
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    density = probs.mean(dim=0)
    onehot = torch.nn.functional.one_hot(gate_i, n_experts).float()
    frac = onehot.sum(dim=1).mean(dim=0) / top_k
    return n_experts * torch.sum(frac * density)
