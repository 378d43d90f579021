"""The backward of the port's grouped product (`ragged_dot`) against the
JAX package: the plain backward (`ref.ragged_dot_bwd_ref`) and the
autograd Function's CPU backward against ``jax.vjp`` of
``jax.lax.ragged_dot(x, w.astype(x.dtype), sizes)``, the call the
reference's MoE FFN makes (repro/models/moe.py:67-73); and a plain model
of the backward kernels' arithmetic (``csrc/ragged_dot_bwd.cu``: bf16
operands, fp32 weights rounded to bf16 as they load, fp32 sums taken by
32-deep slices, each gradient rounded once) at the tolerance the card's
comparison uses.  Inputs are made with numpy from a seed and handed to
both packages.

Tolerances, the forward's: bf16 within 1e-4 + 2^-7 |ref| (one bf16 ulp:
both sides sum in fp32 and round once, in different orders); fp32 within
1e-4 + 1e-5 |ref|."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.ragged_dot import ops  # noqa: E402
from repro_torch.kernels.ragged_dot.ref import (  # noqa: E402
    group_rows, ragged_dot_bwd_ref, ragged_dot_ref)

TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float32": (1e-4, 1e-5)}
#: (M, K, N, group sizes): empty groups, one group holding every row,
#: rows past the last group, groups across the kernels' 128-row tiles,
#: K and N off a multiple of 8.
CASES = [(240, 64, 96, [60, 0, 100, 0, 80]),
         (96, 64, 48, [96, 0, 0, 0]),
         (50, 72, 40, [0, 0, 20, 17]),       # 13 rows past the groups
         (300, 48, 33, [1, 160, 129, 0]),
         (8, 16, 8, [2, 2, 2, 2, 0, 0, 0, 0]),
         (37, 24, 70, [0, 0, 0])]            # no row in any group
#: (x's type, w's type): the bf16 FFN passes its fp32 stacks as stored.
TYPES = [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
         ("float32", "float32")]


def _offsets(sizes) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32)


def _inputs(case, seed=0):
    m, k, n, sizes = case
    rng = np.random.default_rng(seed + m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5) \
        .astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, dy


def _jax_vjp(x, w, dy, sizes, x_type, w_type):
    """(dx, dw) of the reference's call: x in its type, w stored in its
    type and cast to x's before the product, dy in x's (the output's)."""
    xj = jnp.asarray(x, x_type)
    wj = jnp.asarray(w, w_type)
    gs = jnp.asarray(sizes, jnp.int32)
    y, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b.astype(x_type), gs), xj, wj)
    dx, dw = vjp(jnp.asarray(dy, x_type))
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _within(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    atol, rtol = TOL[dtype]
    got = got.float().numpy()
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    assert (err <= bound).all(), float((err - bound).max())


def _torch(x, w, dy, x_type, w_type):
    return (torch.from_numpy(x).to(getattr(torch, x_type)),
            torch.from_numpy(w).to(getattr(torch, w_type)),
            torch.from_numpy(dy).to(getattr(torch, x_type)))


@pytest.mark.parametrize("types", TYPES, ids=["-".join(t) for t in TYPES])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case, types):
    """`ragged_dot_bwd_ref` against ``jax.vjp`` of the reference's call:
    dx in x's type (zero past the groups), dw in w's type (zero for an
    empty group; fp32 w gets each sum rounded to bf16 first)."""
    m, k, n, sizes = case
    x_type, w_type = types
    x, w, dy = _inputs(case)
    want_dx, want_dw = _jax_vjp(x, w, dy, sizes, x_type, w_type)
    xt, wt, dyt = _torch(x, w, dy, x_type, w_type)
    dx, dw = ragged_dot_bwd_ref(xt, wt, _offsets(sizes), dyt)
    assert dx.dtype == xt.dtype and dx.shape == (m, k)
    assert dw.dtype == wt.dtype and dw.shape == wt.shape
    _within(dx, want_dx, x_type)
    _within(dw, want_dw, x_type)
    end = int(np.sum(sizes))
    assert not dx[end:].any()
    for g, size in enumerate(sizes):
        if size == 0:
            assert not dw[g].any()
    if x_type == "bfloat16" and w_type == "float32":
        # The fp32 gradient of w is a bf16 value (the astype's VJP).
        assert torch.equal(dw, dw.bfloat16().float())


@pytest.mark.parametrize("types", TYPES, ids=["-".join(t) for t in TYPES])
@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_function_backward_on_the_cpu_matches_jax_vjp(case, types):
    """`ops.ragged_dot` under autograd on the CPU: one autograd Function
    whose backward is the plain version, launching nothing, with the
    reference's gradients."""
    m, k, n, sizes = case
    x_type, w_type = types
    x, w, dy = _inputs(case, seed=1)
    want_dx, want_dw = _jax_vjp(x, w, dy, sizes, x_type, w_type)
    xt, wt, dyt = _torch(x, w, dy, x_type, w_type)
    xt.requires_grad_()
    wt.requires_grad_()
    before = dict(LAUNCHES)
    y = ops.ragged_dot(xt, wt, _offsets(sizes))
    assert type(y.grad_fn).__name__ == "_RaggedDotBackward"
    dx, dw = torch.autograd.grad(y, (xt, wt), dyt)
    assert LAUNCHES == before
    _within(dx, want_dx, x_type)
    _within(dw, want_dw, x_type)
    # The plain backward called directly (the same sums, which a CPU BLAS
    # may split across threads differently from call to call).
    want = ragged_dot_bwd_ref(xt.detach(), wt.detach(), _offsets(sizes), dyt)
    _within(dx, want[0].float().numpy(), x_type)
    _within(dw, want[1].float().numpy(), x_type)


def test_backward_takes_only_the_gradients_asked_for():
    """With frozen weights the Function hands back dx alone."""
    x, w, dy = _inputs(CASES[0])
    xt, wt, dyt = _torch(x, w, dy, "bfloat16", "float32")
    xt.requires_grad_()
    y = ops.ragged_dot(xt, wt, _offsets(CASES[0][3]))
    (dx,) = torch.autograd.grad(y, (xt,), dyt)
    _within(dx, ragged_dot_bwd_ref(xt.detach(), wt, _offsets(CASES[0][3]),
                                   dyt)[0].float().numpy(), "bfloat16")
    assert wt.grad is None


def test_plain_backward_of_rows_before_the_first_group():
    """Rows before offsets[0] and past offsets[G] get zero dx, and
    offsets that go down make empty groups (as the kernels clamp them);
    what is left is the backward of the rows in the groups."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(12, 8, generator=gen)
    w = torch.randn(3, 8, 5, generator=gen)
    dy = torch.randn(12, 5, generator=gen)
    offs = torch.tensor([2, 6, 4, 9], dtype=torch.int32)
    dx, dw = ragged_dot_bwd_ref(x, w, offs, dy)
    assert [r[1:] for r in group_rows(offs, 12)] == [(2, 6), (6, 6), (6, 9)]
    assert not dx[:2].any() and not dx[9:].any() and not dw[1].any()
    torch.testing.assert_close(dx[2:6], dy[2:6] @ w[0].T)
    torch.testing.assert_close(dw[2], x[6:9].T @ dy[6:9])
    # And the plain forward's autograd agrees with it.
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(ragged_dot_ref(xr, wr, offs), (xr, wr), dy)
    torch.testing.assert_close(gx, dx)
    torch.testing.assert_close(gw, dw)


# ---- the backward kernels' arithmetic (csrc/ragged_dot_bwd.cu)

def _kernel_model(x, w, offsets, dy, slice_: int = 32):
    """The bf16 kernels' arithmetic in plain torch: bf16 operands (fp32
    weights rounded as they load), each gradient summed in fp32 over
    32-deep slices of its reduction (N for dx, the group's rows from its
    first for dw) and rounded once to bf16, dw then written in w's
    type."""
    m, k = x.shape
    n = w.shape[2]
    xf, wf, dyf = x.float(), w.bfloat16().float(), dy.float()
    dx = torch.zeros((m, k))
    dw = torch.zeros(w.shape)
    for g, lo, hi in group_rows(offsets, m):
        for n0 in range(0, n, slice_):
            dx[lo:hi] += dyf[lo:hi, n0:n0 + slice_] @ \
                wf[g][:, n0:n0 + slice_].T
        for r0 in range(lo, hi, slice_):
            r1 = min(r0 + slice_, hi)
            dw[g] += xf[r0:r1].T @ dyf[r0:r1]
    return dx.bfloat16(), dw.bfloat16().to(w.dtype)


@pytest.mark.parametrize("case", CASES + [(600, 256, 160, [0, 300, 300])],
                         ids=str)
def test_kernel_arithmetic_meets_the_bf16_tolerance(case):
    """The kernels' roundings (one bf16 rounding a gradient, sums in fp32
    by slices) against ``jax.vjp`` at the tolerance chip_smoke.py and the
    card tests hold the kernels to, with fp32 weights and with bf16."""
    m, k, n, sizes = case
    x, w, dy = _inputs(case, seed=2)
    for w_type in ("float32", "bfloat16"):
        want_dx, want_dw = _jax_vjp(x, w, dy, sizes, "bfloat16", w_type)
        xt, wt, dyt = _torch(x, w, dy, "bfloat16", w_type)
        dx, dw = _kernel_model(xt, wt, _offsets(sizes), dyt)
        _within(dx, want_dx, "bfloat16")
        _within(dw, want_dw, "bfloat16")


def test_meta_backward_gives_shapes_and_counts_twice_the_forward():
    """On meta the Function's backward computes nothing and reports
    twice the forward's dot FLOPs (dx and dw), as on every device."""
    from repro_torch.launch import op_analysis
    x = torch.empty((64, 32), dtype=torch.bfloat16,
                    device="meta").requires_grad_()
    w = torch.empty((4, 32, 48), device="meta").requires_grad_()
    offs = torch.empty((5,), dtype=torch.int32, device="meta")
    res = op_analysis.analyze(
        lambda: ops.ragged_dot(x, w, offs).sum().backward())
    kernels = res["kernels"]
    assert kernels["ragged_dot_bwd"]["dot_flops"] == \
        2 * kernels["ragged_dot"]["dot_flops"] == 4.0 * 64 * 32 * 48
    assert x.grad.shape == x.shape and w.grad.dtype == torch.float32
