"""The port's SSD scan against the JAX package: its plain torch version
(`repro_torch.kernels.ssd.ref`: `ssd_chunked`, `ssd_step`, `segsum`)
against the reference's on the reference's own cases, a ragged sequence
and two groups, and against the Pallas kernel in interpret mode; the
wrapper's dispatch and checks; and the backward (`ref.ssd_chunked_bwd`
and the backward kernel's stages) against ``jax.vjp`` of the
reference's scan (tolerances at `BWD_TOL`).  Inputs are made with numpy from a seed
and handed to both.

Tolerance: 2e-4 absolute plus 1e-5 relative, where the reference's own
kernel test uses 1e-4 (tests/test_kernels.py:96).  The two packages
sum in different orders, and at these inputs |y| reaches ~190, where
one fp32 ulp is 1.5e-5: on the third case each package's fp32 scan is
up to 1.8e-4 (JAX) and 1.2e-4 (port) from a float64 recurrence, and
the two differ by up to 1.5e-4 at |y| ~ 3.  So 1e-4 is below the
algorithm's own fp32 error there; it held in the reference's test
because both of its sides run XLA's arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.kernel import ssd_pallas  # noqa: E402
from repro.kernels.ssd.ref import segsum as jax_segsum  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunked as jax_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_step as jax_step  # noqa: E402
from _tf32 import split_mm  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (segsum, ssd_chunked,  # noqa: E402
                                         ssd_step)
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd as ref_bwd  # noqa: E402

ATOL, RTOL = 2e-4, 1e-5

# The reference's SSD_CASES (tests/test_kernels.py:70-75):
# B, S, H, P, N, chunk, head_block
SSD_CASES = [
    (2, 64, 4, 16, 32, 16, 2),
    (1, 128, 8, 32, 64, 32, 4),
    (2, 128, 4, 64, 128, 64, 4),
]


def _inputs(b, s, h, p, n, g=1, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, a_log, bb, cc


def _both(arrays, chunk):
    want_y, want_f = jax_ssd(*(jnp.asarray(a) for a in arrays), chunk=chunk)
    got_y, got_f = ssd_chunked(*(torch.from_numpy(a) for a in arrays),
                               chunk=chunk)
    return (np.asarray(want_y), np.asarray(want_f), got_y.numpy(),
            got_f.numpy())


@pytest.mark.parametrize("case", SSD_CASES + [
    # ragged: 200 = 3 * 64 + 8, padded with dt = 0 steps
    (2, 200, 4, 16, 32, 64, 0),
    # chunk above S (the no-cache forward's chunk on a short prompt)
    (1, 12, 4, 16, 16, 64, 0)], ids=str)
def test_ssd_chunked_matches_reference(case):
    b, s, h, p, n, chunk, _ = case
    wy, wf, gy, gf = _both(_inputs(b, s, h, p, n), chunk)
    assert gy.shape == (b, s, h, p) and gf.shape == (b, h, p, n)
    np.testing.assert_allclose(gy, wy, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gf, wf, atol=ATOL, rtol=RTOL)


def test_ssd_chunked_with_two_groups():
    wy, wf, gy, gf = _both(_inputs(2, 64, 4, 16, 32, g=2), 16)
    np.testing.assert_allclose(gy, wy, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gf, wf, atol=ATOL, rtol=RTOL)


def test_ssd_chunked_in_bf16_keeps_the_dtype():
    arrays = _inputs(1, 64, 4, 16, 32)
    want_y, want_f = jax_ssd(*(jnp.asarray(a, jnp.bfloat16)
                               if i != 2 else jnp.asarray(a)
                               for i, a in enumerate(arrays)), chunk=16)
    got_y, got_f = ssd_chunked(*(torch.from_numpy(a).bfloat16()
                                 if i != 2 else torch.from_numpy(a)
                                 for i, a in enumerate(arrays)), chunk=16)
    assert got_y.dtype == torch.bfloat16 and got_f.dtype == torch.float32
    # The inputs are bf16 but the scan is fp32 on both sides; y is
    # rounded once to bf16, so the sides differ by at most one bf16 ulp
    # (2^-7 relative) where their fp32 values straddle a rounding edge.
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               atol=ATOL, rtol=2.0 ** -7)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=ATOL, rtol=RTOL)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(5)
    b, h, p, n, g = 2, 4, 8, 16, 2
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    bt = rng.standard_normal((b, g, n)).astype(np.float32)
    ct = rng.standard_normal((b, g, n)).astype(np.float32)
    args = (state, x, dt, a_log, bt, ct)
    wy, ws = jax_step(*(jnp.asarray(a) for a in args))
    gy, gs = ssd_step(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)


def test_segsum_matches_reference():
    la = np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32)
    want = np.asarray(jax_segsum(jnp.asarray(la)))
    got = segsum(torch.from_numpy(la)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)
    ss = segsum(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    assert float(ss[2, 0]) == pytest.approx(0.5, abs=1e-6)


def test_plain_version_matches_pallas_interpret():
    b, s, h, p, n, chunk, hb = SSD_CASES[0]
    arrays = _inputs(b, s, h, p, n)
    wy, wf = ssd_pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                        head_block=hb, interpret=True)
    gy, gf = ssd_chunked(*(torch.from_numpy(a) for a in arrays),
                         chunk=chunk)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=ATOL,
                               rtol=RTOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 40, 4, 16, 32, g=2)]
    before = LAUNCHES["ssd"]
    y, f = ops.ssd(*arrays, chunk=16)
    assert LAUNCHES["ssd"] == before
    wy, wf = ssd_chunked(*arrays, chunk=16)
    assert torch.equal(y, wy) and torch.equal(f, wf)


def test_wrapper_checks_its_input():
    x, dt, a_log, b, c = (torch.from_numpy(a)
                          for a in _inputs(1, 16, 4, 8, 16))
    with pytest.raises(ValueError):
        ops.ssd(x, dt[:, :8], a_log, b, c)
    with pytest.raises(ValueError):
        ops.ssd(x, dt, a_log, b[:, :, :, :8], c)
    with pytest.raises(ValueError):
        ops.ssd(x, dt, a_log, b, c, chunk=0)
    # The meta device (the dry run's) takes the card's checks and gives
    # the outputs' shapes and types only.
    y, f = ops.ssd(*(t.to("meta") for t in (x, dt, a_log, b, c)))
    assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
    assert f.is_meta and f.shape == (1, 4, 8, 16) and f.dtype == torch.float32
    with pytest.raises(ValueError, match="one group"):
        ops.ssd(*(t.to("meta") for t in (x, dt, a_log, torch.cat([b, b], 2),
                                           torch.cat([c, c], 2))))


def _split(v, terms):
    """v (fp32) as ``terms`` bf16 values (each held in fp32) whose sum
    approximates it: hi = bf16(v), then the bf16 of each remainder."""
    out = []
    for _ in range(terms):
        t = v.bfloat16().float()
        out.append(t)
        v = v - t
    return out


def _tc_emulation(x, dt, a_log, b, c, chunk, gate_terms=2, state_terms=3,
                  inter_terms=3):
    """The bf16 tensor-core stages' arithmetic (csrc/ssd_tc.cu) in plain
    torch: per chunk, cum in order with dt A rounded first; the chunk
    state x^T (B dt exp(total - cum)) with the weighted B split into
    ``state_terms`` bf16 terms; the scan over chunks; y = exp(cum_i)
    (C_i . state_prev), the state split into ``inter_terms`` terms, plus
    the gate (C_i . B_j) exp(cum_i - cum_j) dt_j split into
    ``gate_terms`` terms times x.  The defaults are the kernel's."""
    bsz, s, h, p = x.shape
    a = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    bf, cf = b[:, :, 0].float(), c[:, :, 0].float()
    y = torch.zeros((bsz, s, h, p))
    carry = torch.zeros((bsz, h, p, bf.shape[-1]))
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        cum = torch.cumsum(dtf[:, sl] * a, dim=1)             # (B, l, H)
        w = dtf[:, sl] * torch.exp(cum[:, -1:] - cum)
        wb = bf[:, sl, None, :] * w[..., None]                # (B, l, H, N)
        state = sum(torch.einsum("bjhp,bjhn->bhpn", xf[:, sl], t)
                    for t in _split(wb, state_terms))
        inter = sum(torch.einsum("bin,bhpn->bihp", cf[:, sl], t)
                    for t in _split(carry, inter_terms)) * torch.exp(cum)[..., None]
        scores = torch.einsum("bin,bjn->bij", cf[:, sl], bf[:, sl])
        ln = cum.shape[1]
        tril = torch.tril(torch.ones((ln, ln), dtype=torch.bool))
        gate = scores[..., None] * torch.exp(
            cum[:, :, None, :] - cum[:, None, :, :]) * dtf[:, sl][:, None]
        gate = torch.where(tril[None, :, :, None], gate, 0.0)  # (B,i,j,H)
        intra = sum(torch.einsum("bijh,bjhp->bihp", t, xf[:, sl])
                    for t in _split(gate, gate_terms))
        y[:, sl] = intra + inter
        carry = carry * torch.exp(cum[:, -1])[..., None, None] + state
    return y.bfloat16(), carry


TC_CASES = SSD_CASES + [
    (2, 1000, 4, 64, 64, 256, 0),     # the serve prefill's ragged chunks
    (2, 200, 4, 16, 32, 64, 0)]


def _tc_errors(case, **terms):
    """The largest ratio of |error| to the kernel's bf16 tolerance, for
    y and for the final state, of the emulation with ``terms`` against
    the JAX package's reference on bf16 inputs (<= 1 where it holds)."""
    b, s, h, p, n, chunk, _ = case
    arrays = _inputs(b, s, h, p, n)
    want_y, want_f = jax_ssd(*(jnp.asarray(a, jnp.bfloat16)
                               if i != 2 else jnp.asarray(a)
                               for i, a in enumerate(arrays)), chunk=chunk)
    got_y, got_f = _tc_emulation(*(torch.from_numpy(a).bfloat16()
                                   if i != 2 else torch.from_numpy(a)
                                   for i, a in enumerate(arrays)), chunk,
                                 **terms)
    want_y = np.asarray(want_y.astype(jnp.float32))
    want_f = np.asarray(want_f)
    err_y = np.abs(got_y.float().numpy() - want_y) / \
        (1e-4 + 2.0 ** -7 * np.abs(want_y))
    err_f = np.abs(got_f.numpy() - want_f) / (1e-4 + 1e-5 * np.abs(want_f))
    return float(err_y.max()), float(err_f.max())


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tensor_core_design_meets_the_bf16_tolerances(case):
    """The tensor-core design (gate in two bf16 terms, the chunk states
    and the carried state in three) against the JAX package's reference
    on bf16 inputs: y within one bf16 ulp (1e-4 + 2^-7 |y|), the fp32
    state within 1e-4 + 1e-5 |state|, the kernel's tolerances."""
    err_y, err_f = _tc_errors(case)
    assert err_y <= 1.0 and err_f <= 1.0, (err_y, err_f)


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_two_bf16_terms_per_product_meet_the_bf16_tolerances(case):
    """Two bf16 terms for every fp32 operand (the gate, the chunk states,
    the carried state) still meet the kernel's bf16 tolerances: the
    least passes that chip_smoke.py's `ssd_bound` counts."""
    err_y, err_f = _tc_errors(case, gate_terms=2, state_terms=2,
                              inter_terms=2)
    assert err_y <= 1.0 and err_f <= 1.0, (err_y, err_f)


@pytest.mark.parametrize("product", ["gate", "state", "inter"])
def test_one_bf16_term_misses_the_bf16_tolerances(product):
    """One bf16 term for any fp32 operand misses the bf16 tolerances at
    the serve prefill's shape, so no product of the bound takes fewer
    than two passes (the scores, of bf16 operands, take one)."""
    err_y, err_f = _tc_errors(TC_CASES[3], **{f"{product}_terms": 1})
    assert max(err_y, err_f) > 1.0, (err_y, err_f)


# ---- the fp32 stages' split-TF32 design (csrc/ssd.cu)

def _tf32_emulation(x, dt, a_log, b, c, chunk, passes=3):
    """The fp32 stages' arithmetic (csrc/ssd.cu) in plain torch: per
    chunk, cum in order with dt A rounded first; the chunk state
    x^T (B dt exp(total - cum)) per tile of 64 steps, summed in fp32;
    the scan over chunks; y = exp(cum_i) (C_i . state_prev) plus the gate
    (C_i . B_j) exp(cum_i - cum_j) dt_j times x, per tile of 64 columns
    j; every product split-TF32 (`split_mm`)."""
    bsz, s, h, p = x.shape
    a = -torch.exp(a_log)
    bf, cf = b[:, :, 0], c[:, :, 0]
    y = torch.zeros((bsz, s, h, p))
    carry = torch.zeros((bsz, h, p, bf.shape[-1]))
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        ln = sl.stop - t0
        xs, dts = x[:, sl], dt[:, sl]
        cum = torch.cumsum(dts * a, dim=1)                    # (B, l, H)
        w = dts * torch.exp(cum[:, -1:] - cum)
        wb = bf[:, sl, None, :] * w[..., None]                # (B, l, H, N)
        state = sum(split_mm("bjhp,bjhn->bhpn", xs[:, j:j + 64],
                              wb[:, j:j + 64], passes)
                    for j in range(0, ln, 64))
        inter = split_mm("bin,bhpn->bihp", cf[:, sl], carry, passes) * \
            torch.exp(cum)[..., None]
        scores = split_mm("bin,bjn->bij", cf[:, sl], bf[:, sl], passes)
        tril = torch.tril(torch.ones((ln, ln), dtype=torch.bool))
        gate = scores[..., None] * torch.exp(
            cum[:, :, None, :] - cum[:, None, :, :]) * dts[:, None]
        gate = torch.where(tril[None, :, :, None], gate, 0.0)  # (B,i,j,H)
        intra = sum(split_mm("bijh,bjhp->bihp", gate[:, :, j:j + 64],
                              xs[:, j:j + 64], passes)
                    for j in range(0, ln, 64))
        y[:, sl] = intra + inter
        carry = carry * torch.exp(cum[:, -1])[..., None, None] + state
    return y, carry


TF32_CASES = SSD_CASES + [
    (2, 200, 4, 16, 32, 64, 0), (1, 12, 4, 16, 16, 64, 0),
    (2, 1000, 4, 64, 64, 256, 0)]     # the serve prefill's ragged chunks


def _tf32_errors(case, passes=3):
    """The largest ratio of |error| to the fp32 stages' tolerance
    (1e-4 + 1e-5 |want|), for y and for the final state, of the emulation
    against the plain version on fp32 inputs (<= 1 where it holds), and
    the emulated (y, state)."""
    b, s, h, p, n, chunk, _ = case
    args = [torch.from_numpy(a) for a in _inputs(b, s, h, p, n)]
    want_y, want_f = ssd_chunked(*args, chunk=chunk)
    got_y, got_f = _tf32_emulation(*args, chunk, passes=passes)
    err_y = (got_y - want_y).abs() / (1e-4 + 1e-5 * want_y.abs())
    err_f = (got_f - want_f).abs() / (1e-4 + 1e-5 * want_f.abs())
    return float(err_y.max()), float(err_f.max()), got_y, got_f


@pytest.mark.parametrize("case", TF32_CASES, ids=str)
def test_split_tf32_design_meets_the_fp32_tolerances(case):
    """The fp32 stages' design (three TF32 products per fp32 product)
    against the plain version at the kernel's fp32 tolerances (1e-4 +
    1e-5 |y|, the same for the state), and, on the cases whose plain
    version meets it, against the JAX package's reference at this file's
    tolerance (at 1000 steps the two packages' fp32 scans themselves
    differ by up to 1.2e-3, over this file's tolerance)."""
    err_y, err_f, got_y, got_f = _tf32_errors(case)
    assert err_y <= 1.0 and err_f <= 1.0, (err_y, err_f)
    b, s, h, p, n, chunk, _ = case
    if s > 200:
        return
    want_y, want_f = jax_ssd(*(jnp.asarray(a) for a in
                               _inputs(b, s, h, p, n)), chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("passes", [1, 2])
def test_fewer_tf32_products_miss_the_fp32_tolerances(passes):
    """One TF32 product (hi hi), or two (hi hi + hi lo), per fp32 product
    misses the fp32 tolerances at the serve prefill's shape by over 10x:
    three is the fewest, which is what chip_smoke.py's fp32 SSD bound
    counts (`SSD_PASSES_FP32`)."""
    err_y, err_f, _, _ = _tf32_errors(TF32_CASES[-1], passes=passes)
    assert max(err_y, err_f) > 10.0, (err_y, err_f)


def test_fp32_passes_match_the_kernel_source():
    """chip_smoke.py's `SSD_PASSES_FP32` counts, for each of the scan's
    four products, the TF32 products the stages take per fp32 product:
    the shared header's `kPasses`, which the stages' products are held
    to."""
    import importlib.util
    import pathlib
    import re
    kernels = pathlib.Path(ops.__file__).parents[1]
    src = (kernels / "ssd" / "csrc" / "ssd.cu").read_text()
    assert '#include "../../csrc/tf32_mma.cuh"' in src
    header = (kernels / "csrc" / "tf32_mma.cuh").read_text()
    passes = int(re.search(r"constexpr int kPasses = (\d+);",
                           header).group(1))
    assert src.count("static_assert(kPasses == 3") >= 1
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SSD_PASSES_FP32 == {name: passes for name in
                                     ("scores", "gate", "state", "inter")}
    assert passes == 3
    assert (smoke.SSD_ATOL, smoke.SSD_RTOL["float32"]) == (1e-4, 1e-5)


# ---------------------------------------------------------------- backward
# The backward: `ref.ssd_chunked_bwd` (autograd through `ssd_chunked`,
# the plain version of csrc/ssd_bwd.cu) against ``jax.vjp`` of the
# reference's `ssd_chunked` (what ``jax.grad`` differentiates in
# training: no kernel of the JAX package has a custom_vjp).  fp32:
# max |d| <= 1e-5 max |ref| per gradient.  bf16: both sides compute in
# fp32 and round each gradient to bf16 where their casts sit (per head
# for b and c, whose head sum the cast's backward takes in bf16), in
# other sum orders, so a gradient may land a bf16 ulp or two away: 2^-6
# max |ref| (two ulps of the largest).  d_a_log (float32 for both
# dtypes) sums dt A rev over every step and batch row, terms that cancel
# to a result far smaller than they are, so it is held to 1e-5 of the
# size of its terms, sum |dt ddt| per head (ddt = its direct terms + A
# rev): at these cases the two packages part by up to 4e-5 of max |ref|
# but 4e-7 of that size.
BWD_CASES = [(2, 64, 4, 16, 32, 16, 1), (2, 200, 4, 16, 32, 64, 1),
             (1, 40, 4, 16, 32, 16, 2), (1, 37, 2, 8, 16, 8, 1),
             (1, 130, 3, 20, 12, 64, 1)]
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _bwd_inputs(b, s, h, p, n, g, seed=11):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    d_final = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return _inputs(b, s, h, p, n, g=g, seed=seed), dy, d_final


def _jax_vjp(arrays, dy, d_final, chunk, dtype):
    import jax
    cast = [jnp.asarray(a, dtype) for a in arrays]
    cast[2] = jnp.asarray(arrays[2])              # a_log stays fp32
    (y, fin), vjp = jax.vjp(lambda *a: jax_ssd(*a, chunk=chunk), *cast)
    df = jnp.zeros_like(fin) if d_final is None else jnp.asarray(d_final)
    return [np.asarray(g, np.float32)
            for g in vjp((jnp.asarray(dy, dtype), df))]


def _port_inputs(arrays, dtype):
    out = [torch.from_numpy(a).to(dtype) for a in arrays]
    out[2] = torch.from_numpy(arrays[2])
    return out


def _hold(got, want, dt, tol, what):
    """Each gradient within ``tol`` max |ref|; d_a_log within 1e-5 of its
    terms' size, sum |dt ddt| per head (``dt`` as the inputs hold it)."""
    terms = np.abs(dt * want[1]).sum(axis=(0, 1))
    for name, g, w in zip(("dx", "ddt", "d_a_log", "db", "dc"), got, want):
        err = np.abs(g.float().numpy() - w)
        if name == "d_a_log":
            assert (err <= 1e-5 * terms).all(), (what, name, err, terms)
        else:
            assert err.max() <= tol * float(np.abs(w).max()), (what, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case, with_final, dtype):
    b, s, h, p, n, chunk, g = case
    arrays, dy, d_final = _bwd_inputs(b, s, h, p, n, g)
    d_final = d_final if with_final else None
    want = _jax_vjp(arrays, dy, d_final, chunk, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    got = ref_bwd(*_port_inputs(arrays, tdt), torch.from_numpy(dy).to(tdt),
                  None if d_final is None else torch.from_numpy(d_final),
                  chunk=chunk)
    for t, a in zip(got, _port_inputs(arrays, tdt)):
        assert t.dtype == a.dtype and t.shape == a.shape
    _hold(got, want, _port_inputs(arrays, tdt)[1].float().numpy(),
          BWD_TOL[dtype], case)


def _kernel_stages(x, dt, a_log, b, c, dy, d_final, chunk,
                   dtype=torch.float32):
    """The backward kernel's stages (csrc/ssd_bwd.cu) in plain torch,
    for one group, computed in ``dtype``: cum; the chunk states S and R;
    the forward scan (the state H before each chunk) and the reverse one
    (dS); per chunk the gate's products and the state terms; dcum's
    reverse cumsum."""
    import torch.nn.functional as F
    bsz, s, h, p = x.shape
    n = b.shape[3]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t, dims):
        return F.pad(t.to(dtype), (0, 0) * dims + (0, pad)).reshape(
            bsz, nc, chunk, *t.shape[2:])

    xx, dyy, dtt = chunks(x, 2), chunks(dy, 2), chunks(dt, 1)
    bb, cc = chunks(b[:, :, 0], 1), chunks(c[:, :, 0], 1)
    a = -torch.exp(a_log.to(dtype))
    cum = torch.cumsum(dtt * a, dim=2)                       # (B,z,L,H)
    total = cum[:, :, -1]
    w = torch.exp(total[:, :, None] - cum) * dtt
    st = torch.einsum("bzjh,bzjhp,bzjn->bzhpn", w, xx, bb)
    rt = torch.einsum("bzih,bzihp,bzin->bzhpn", torch.exp(cum), dyy, cc)
    hs, ds = [], [None] * nc
    carry = torch.zeros(bsz, h, p, n, dtype=dtype)
    for z in range(nc):
        hs.append(carry)
        carry = carry * torch.exp(total[:, z])[..., None, None] + st[:, z]
    d = torch.zeros_like(carry) if d_final is None else d_final.to(dtype)
    for z in reversed(range(nc)):
        ds[z] = d
        d = d * torch.exp(total[:, z])[..., None, None] + rt[:, z]
    hs, ds = torch.stack(hs, 1), torch.stack(ds, 1)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    cum_h = cum.movedim(-1, 2)
    e = torch.where(tril, torch.exp(torch.where(
        tril, cum_h[..., :, None] - cum_h[..., None, :], 0.0)), 0.0)
    cb = torch.einsum("bzin,bzjn->bzij", cc, bb)[:, :, None]
    dxy = torch.einsum("bzihp,bzjhp->bzhij", dyy, xx)
    dt_j = dtt.movedim(-1, 2)[..., None, :]
    gate, q = cb * e * dt_j, e * dt_j * dxy
    wgt = q * cb
    xds = torch.einsum("bzjhp,bzhpn->bzjhn", xx, ds)
    dyh = torch.einsum("bzihp,bzhpn->bzihn", dyy, hs)
    dx = torch.einsum("bzhij,bzihp->bzjhp", gate, dyy) + w[..., None] * \
        torch.einsum("bzjn,bzhpn->bzjhp", bb, ds)
    dc = torch.einsum("bzhij,bzjn->bzihn", q, bb) + \
        torch.exp(cum)[..., None] * dyh
    db = torch.einsum("bzhij,bzin->bzjhn", q, cc) + w[..., None] * xds
    sdot = (xds * bb[:, :, :, None]).sum(-1)
    u = w * sdot
    v = torch.exp(cum) * (dyh * cc[:, :, :, None]).sum(-1)
    dcum = wgt.sum(-1).movedim(2, -1) + v - wgt.sum(-2).movedim(2, -1) - u
    dcum[:, :, -1] += u.sum(2) + torch.exp(total) * (ds * hs).sum((-1, -2))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = (e * cb * dxy).sum(-2).movedim(2, -1) + \
        torch.exp(total[:, :, None] - cum) * sdot + a * rev
    d_a_log = a * (dtt * rev).sum((0, 1, 2))

    def rows(t):
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s]
    return (rows(dx), rows(ddt), d_a_log, rows(db.sum(3))[:, :, None],
            rows(dc.sum(3))[:, :, None])


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[-1] == 1],
                         ids=str)
def test_backward_kernel_stages_match_jax_vjp(case, with_final):
    """The maths of csrc/ssd_bwd.cu (its stages as plain torch) against
    the reference's gradients, in fp32."""
    b, s, h, p, n, chunk, g = case
    arrays, dy, d_final = _bwd_inputs(b, s, h, p, n, g)
    d_final = d_final if with_final else None
    want = _jax_vjp(arrays, dy, d_final, chunk, jnp.float32)
    got = _kernel_stages(*(torch.from_numpy(a) for a in arrays),
                         torch.from_numpy(dy),
                         None if d_final is None else torch.from_numpy(
                             d_final), chunk)
    _hold(got, want, arrays[1], BWD_TOL["float32"], case)


def test_backward_wrapper_on_cpu_runs_the_plain_version():
    arrays, dy, d_final = _bwd_inputs(1, 40, 4, 16, 32, 2)
    args = [torch.from_numpy(a) for a in arrays]
    before = LAUNCHES["ssd_bwd"]
    got = ops.ssd_bwd(*args, torch.from_numpy(dy), torch.from_numpy(d_final),
                      chunk=16)
    want = ref_bwd(*args, torch.from_numpy(dy), torch.from_numpy(d_final),
                   chunk=16)
    assert LAUNCHES["ssd_bwd"] == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # autograd through `ops.ssd` on the CPU is autograd through the plain
    # version: the same gradients.
    leaves = [t.clone().requires_grad_() for t in args]
    y, fin = ops.ssd(*leaves, chunk=16)
    grads = torch.autograd.grad((y, fin), leaves, (torch.from_numpy(dy),
                                                   torch.from_numpy(d_final)))
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_bwd(*args, torch.from_numpy(dy)[:, :8], chunk=16)
    with pytest.raises(ValueError, match="d_final"):
        ops.ssd_bwd(*args, torch.from_numpy(dy),
                    torch.from_numpy(d_final)[..., :8], chunk=16)


def test_plain_backward_fp32_error_against_float64():
    """The accuracy of the plain backward itself, the yardstick of the
    kernel: in fp32 against a float64 evaluation of the kernel's stages
    (held to ``jax.vjp`` above), at a chunk of 256 over four chunks with
    a final-state gradient.  dx, ddt, db and dc sit within 2e-5 max
    |ref|; d_a_log, a sum over every step of terms that cancel, reaches
    ~1e-4 (8.1e-5 here), which is why the card holds the kernel's
    d_a_log at 1e-3 max |ref| (chip_smoke.py's `SSD_BWD_DA_TOL`) and the
    other gradients at 1e-5."""
    arrays, dy, d_final = _bwd_inputs(1, 1024, 4, 32, 32, 1)
    args = [torch.from_numpy(a) for a in arrays]
    truth = _kernel_stages(*args, torch.from_numpy(dy),
                           torch.from_numpy(d_final), 256,
                           dtype=torch.float64)
    plain = ref_bwd(*args, torch.from_numpy(dy), torch.from_numpy(d_final),
                    chunk=256)
    rel = {name: float((p.double() - t).abs().max() / t.abs().max())
           for name, p, t in zip(("dx", "ddt", "d_a_log", "db", "dc"),
                                 plain, truth)}
    print(rel)
    assert max(v for k, v in rel.items() if k != "d_a_log") <= 2e-5
    assert rel["d_a_log"] <= 1e-3



# ---- the bf16 backward's tensor-core design (csrc/ssd_bwd_tc.cu)
# bf16 terms of each fp32 operand the kernel splits: the weighted B in
# the chunk states S ("s"), the weighted C in R ("r"), the states H
# ("h") and dS ("ds") in the state terms, the group's summed Q in dB and
# dC ("q"), the gate G in dx ("g").  C B^T and dy x^T have bf16
# operands and take one pass.
TC_BWD_TERMS = {"s": 2, "r": 2, "h": 2, "ds": 2, "q": 2, "g": 2}
TC_BWD_GROUP = 8    # heads whose Q one block sums before its products
# The one-group BWD_CASES (the kernel takes one group), and two with H >=
# 8 so that the fold sums 8 heads (and 8 + 4 at H = 12).
TC_BWD_CASES = [c for c in BWD_CASES if c[-1] == 1] + [
    (1, 256, 8, 32, 32, 64, 1), (2, 300, 12, 16, 32, 128, 1)]
# Where one term fewer shows: zamba2's chunk and widths at 12 heads.
TC_BWD_WIDE = (1, 512, 12, 64, 64, 256, 1)


def _tc_bwd_model(x, dt, a_log, b, c, dy, d_final, chunk, terms=None,
                  group=TC_BWD_GROUP):
    """csrc/ssd_bwd_tc.cu's decomposition in plain torch (fp32): the
    stages of `_kernel_stages` with each fp32 operand of a product split
    into its bf16 terms (`_split`, counts `TC_BWD_TERMS` updated by
    ``terms``), dB's and dC's products taken once per group of ``group``
    heads on the group's summed Q, and their state terms formed per head
    as x dS and dy H, scaled per row afterwards.  Returns (dx, ddt,
    d_a_log, db, dc) in fp32."""
    import torch.nn.functional as F
    terms = dict(TC_BWD_TERMS, **(terms or {}))

    def split(v, name):
        return sum(_split(v, terms[name]))

    bsz, s, h, p = x.shape
    n = b.shape[3]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t, dims):
        return F.pad(t.float(), (0, 0) * dims + (0, pad)).reshape(
            bsz, nc, chunk, *t.shape[2:])

    xx, dyy, dtt = chunks(x, 2), chunks(dy, 2), chunks(dt, 1)
    bb, cc = chunks(b[:, :, 0], 1), chunks(c[:, :, 0], 1)
    a = -torch.exp(a_log.float())
    cum = torch.cumsum(dtt * a, dim=2)                       # (B,z,L,H)
    total = cum[:, :, -1]
    w = torch.exp(total[:, :, None] - cum) * dtt
    ecum = torch.exp(cum)
    st = torch.einsum("bzjhp,bzjhn->bzhpn", xx,
                      split(w[..., None] * bb[:, :, :, None], "s"))
    rt = torch.einsum("bzihp,bzihn->bzhpn", dyy,
                      split(ecum[..., None] * cc[:, :, :, None], "r"))
    hs, ds = [], [None] * nc
    carry = torch.zeros(bsz, h, p, n)
    for z in range(nc):
        hs.append(carry)
        carry = carry * torch.exp(total[:, z])[..., None, None] + st[:, z]
    d = torch.zeros_like(carry) if d_final is None else d_final.float()
    for z in reversed(range(nc)):
        ds[z] = d
        d = d * torch.exp(total[:, z])[..., None, None] + rt[:, z]
    hs, ds = torch.stack(hs, 1), torch.stack(ds, 1)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    cum_h = cum.movedim(-1, 2)
    e = torch.where(tril, torch.exp(torch.where(
        tril, cum_h[..., :, None] - cum_h[..., None, :], 0.0)), 0.0)
    cb = torch.einsum("bzin,bzjn->bzij", cc, bb)[:, :, None]
    dxy = torch.einsum("bzihp,bzjhp->bzhij", dyy, xx)
    dt_j = dtt.movedim(-1, 2)[..., None, :]
    gate, q = cb * e * dt_j, e * dt_j * dxy
    wgt = q * cb
    qg = [split(q[:, :, h0:h0 + group].sum(2), "q")
          for h0 in range(0, h, group)]
    xds = torch.einsum("bzjhp,bzhpn->bzjhn", xx, split(ds, "ds"))
    dyh = torch.einsum("bzihp,bzhpn->bzihn", dyy, split(hs, "h"))
    dx = torch.einsum("bzhij,bzihp->bzjhp", split(gate, "g"), dyy) + \
        w[..., None] * torch.einsum("bzjn,bzhpn->bzjhp", bb, split(ds, "ds"))
    dc = sum(torch.einsum("bzij,bzjn->bzin", t, bb) for t in qg) + \
        (ecum[..., None] * dyh).sum(3)
    db = sum(torch.einsum("bzij,bzin->bzjn", t, cc) for t in qg) + \
        (w[..., None] * xds).sum(3)
    sdot = (xds * bb[:, :, :, None]).sum(-1)
    u = w * sdot
    v = ecum * (dyh * cc[:, :, :, None]).sum(-1)
    dcum = wgt.sum(-1).movedim(2, -1) + v - wgt.sum(-2).movedim(2, -1) - u
    dcum[:, :, -1] += u.sum(2) + torch.exp(total) * (ds * hs).sum((-1, -2))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = (e * cb * dxy).sum(-2).movedim(2, -1) + \
        torch.exp(total[:, :, None] - cum) * sdot + a * rev
    d_a_log = a * (dtt * rev).sum((0, 1, 2))

    def rows(t):
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s]
    return (rows(dx), rows(ddt), d_a_log, rows(db)[:, :, None],
            rows(dc)[:, :, None])


_TC_BWD_WANT: dict = {}


def _tc_bwd_errors(case, with_final=True, **terms):
    """The largest ratio of |error| to the bf16 route's tolerance for
    each gradient (<= 1 where it holds) of `_tc_bwd_model` with ``terms``
    against ``jax.vjp`` of the reference on fp32 copies of bf16 inputs:
    dx, ddt, db, dc (rounded to bf16, as the kernel writes them) within
    2^-8 |ref| + 1e-5 max |ref|, d_a_log within 1e-3 max |ref|
    (chip_smoke.py's `SSD_BWD_TOL`, `SSD_BWD_ATOL`, `SSD_BWD_DA_TOL`).
    dy is drawn apart from x: `_bwd_inputs` draws both from one seed, so
    there dy equals x, and the split terms' errors in S and H cancel
    where independent ones do not."""
    b, s, h, p, n, chunk, g = case
    arrays = _inputs(b, s, h, p, n, g=g, seed=13)
    rng = np.random.default_rng(14)     # dy apart from x (see _bwd_inputs)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    d_final = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_final else None
    arrays = [a if i == 2 else torch.from_numpy(a).bfloat16().float().numpy()
              for i, a in enumerate(arrays)]
    dy = torch.from_numpy(dy).bfloat16().float().numpy()
    key = (case, with_final)
    if key not in _TC_BWD_WANT:
        _TC_BWD_WANT[key] = _jax_vjp(arrays, dy, d_final, chunk, jnp.float32)
    want = _TC_BWD_WANT[key]
    got = _tc_bwd_model(*(torch.from_numpy(a) for a in arrays),
                        torch.from_numpy(dy),
                        None if d_final is None else torch.from_numpy(
                            d_final), chunk, terms)
    out = {}
    for name, gv, wv in zip(("dx", "ddt", "d_a_log", "db", "dc"), got, want):
        top = float(np.abs(wv).max())
        if name == "d_a_log":
            err = np.abs(gv.numpy() - wv) / (1e-3 * top)
        else:
            err = np.abs(gv.bfloat16().float().numpy() - wv) / (
                2.0 ** -8 * np.abs(wv) + 1e-5 * top)
        out[name] = float(err.max())
    return out


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("case", TC_BWD_CASES, ids=str)
def test_bf16_backward_design_meets_its_tolerances(case, with_final):
    """csrc/ssd_bwd_tc.cu's arithmetic (two bf16 terms for each fp32
    operand, dB and dC folded over groups of 8 heads) against the
    reference's gradients at the bf16 route's tolerances."""
    errs = _tc_bwd_errors(case, with_final)
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("product", sorted(TC_BWD_TERMS))
def test_one_bf16_term_fewer_misses_the_backward_tolerances(product):
    """One term fewer (one bf16 term) for any split operand misses the
    tolerances at zamba2's chunk and widths, so none of them can take
    fewer than the kernel's two."""
    errs = _tc_bwd_errors(TC_BWD_WIDE, **{
        product: TC_BWD_TERMS[product] - 1})
    assert max(errs.values()) > 1.0, (product, errs)
    assert max(_tc_bwd_errors(TC_BWD_WIDE).values()) <= 1.0


def test_bf16_backward_terms_match_the_kernel_source():
    """The term counts and the group the model uses are the kernel's
    constants, and the wrapper sizes its scratch with the same ones."""
    import pathlib
    import re
    src = (pathlib.Path(ops.__file__).parent / "csrc" /
           "ssd_bwd_tc.cu").read_text()
    found = {m.group(1).lower(): int(m.group(2)) for m in re.finditer(
        r"constexpr int kTerms(\w+) = (\d+);", src)}
    assert found == TC_BWD_TERMS
    group = int(re.search(r"constexpr int kGroup = (\d+);", src).group(1))
    assert group == TC_BWD_GROUP
    assert (ops._TC_GROUP, ops._TC_TERMS_H, ops._TC_TERMS_DS) == (
        group, found["h"], found["ds"])
