"""The fp32 route of the port's grouped product on the TF32 tensor cores
(``src/repro_torch/kernels/ragged_dot/csrc/ragged_tf32.cuh``: the
forward, dx and dw of fp32 x and weights) as plain torch arithmetic, held
to the plain version (`ref.ragged_dot_ref`, `ragged_dot_dx_ref`,
`ragged_dot_dw_ref`) and to the JAX package's call, ``jax.lax.ragged_dot``
in fp32 and its VJP (repro/models/moe.py:67-73), at the fp32 tolerance
that chip_smoke.py holds the card to (``RAGGED_ATOL``,
``RAGGED_RTOL["float32"]``: 1e-4 + 1e-5 |ref|).

The kernels take each fp32 product as three TF32 products (hi hi, hi lo,
lo hi: `tests/_tf32.py`'s `split_mm`) and sum the reduction a 32-deep
stage at a time, each stage's sum joining an fp32 total in order.  The
reductions run at the path's full lengths: K = 4096 and 14336 for the
forward (mixtral's gate/up and down), N = 14336 and 4096 for dx, a group
of 8192 rows for dw; the other dimensions are small.  Three passes meet
the tolerance there and one misses it, which is what the kernels' source
takes (`kPasses`) and chip_smoke.py's bound counts.  Inputs are made with
numpy from a seed and handed to both packages."""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _tf32 import split_mm  # noqa: E402
from repro_torch.kernels.ragged_dot import ops  # noqa: E402
from repro_torch.kernels.ragged_dot.ref import (  # noqa: E402
    group_rows, ragged_dot_dw_ref, ragged_dot_dx_ref, ragged_dot_ref)

ATOL, RTOL = 1e-4, 1e-5
#: The kernels' stage depth (``tf::kBK``): each stage's sum starts from
#: zero and joins the fp32 total.
STAGE = 32
#: (part, M, K, N, group sizes, rows before the first group): every
#: reduction at a full path length; an empty group and rows past the
#: last group in each, rows before the first in some (the JAX call has
#: no such rows: it is compared where there are none).
CASES = [("fwd", 40, 4096, 48, [12, 0, 20], 0),
         ("fwd", 40, 14336, 40, [3, 25, 0], 5),
         ("dx", 40, 48, 14336, [12, 0, 20], 0),
         ("dx", 40, 40, 4096, [0, 30, 4], 3),
         ("dw", 8200, 32, 48, [8192, 0, 3], 0),
         ("dw", 8210, 40, 32, [0, 8192, 11], 2)]
IDS = [f"{c[0]}-{c[1]}x{c[2]}x{c[3]}" for c in CASES]


def _inputs(case):
    part, m, k, n, sizes, lead = case
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5) \
        .astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)]) + lead
    return x, w, dy, offs


def _staged(a, b, passes):
    """a (M, R) @ b (R, N) as the kernels sum it: 32-deep stages, each the
    TF32 split product of `split_mm` (``passes`` of hi hi, hi lo, lo hi),
    joined to an fp32 total in order."""
    m, r = a.shape
    pad = -r % STAGE
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    c = (r + pad) // STAGE
    stages = split_mm("mck,ckn->cmn", a.reshape(m, c, STAGE),
                      b.reshape(c, STAGE, -1), passes)
    total = torch.zeros_like(stages[0])
    for s in stages:
        total = total + s
    return total


def _emulate(part, x, w, offs, dy, passes):
    """The kernels' ``part`` ("fwd", "dx" or "dw") of the fp32 grouped
    product: each group's rows as `_staged` sums, rows outside every
    group zero, an empty group's dw zero."""
    m = x.shape[0]
    out = torch.zeros(x.shape if part == "dx" else
                      w.shape if part == "dw" else (m, w.shape[2]))
    for g, lo, hi in group_rows(offs, m):
        if hi <= lo:
            continue
        if part == "fwd":
            out[lo:hi] = _staged(x[lo:hi], w[g], passes)
        elif part == "dx":
            out[lo:hi] = _staged(dy[lo:hi], w[g].T, passes)
        else:
            out[g] = _staged(x[lo:hi].T, dy[lo:hi], passes)
    return out


def _plain(part, x, w, offs, dy, acc=torch.float32):
    if part == "fwd":
        return ragged_dot_ref(x, w, offs, acc=acc)
    fn = ragged_dot_dx_ref if part == "dx" else ragged_dot_dw_ref
    return fn(x, w, offs, dy, acc=acc)


@functools.lru_cache(maxsize=None)
def _jax(i):
    """The JAX package's fp32 call on case i's inputs: the forward, or the
    VJP's dx or dw (None where rows precede the first group)."""
    part, m, k, n, sizes, lead = CASES[i]
    if lead:
        return None
    x, w, dy, _ = _inputs(CASES[i])
    gs = jnp.asarray(sizes, jnp.int32)
    y, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs),
                     jnp.asarray(x), jnp.asarray(w))
    if part == "fwd":
        return np.asarray(y)
    dx, dw = vjp(jnp.asarray(dy))
    return np.asarray(dx if part == "dx" else dw)


def _ratio(got, want) -> float:
    """The largest |got - want| / (ATOL + RTOL |want|)."""
    want = torch.as_tensor(np.array(want)).double()
    return float(((got.double() - want).abs() /
                  (ATOL + RTOL * want.abs())).max())


def _case(i, passes, acc=torch.float32):
    x, w, dy, offs = (torch.from_numpy(a) for a in _inputs(CASES[i]))
    offs = offs.int()
    part = CASES[i][0]
    return (_emulate(part, x, w, offs, dy, passes),
            _plain(part, x, w, offs, dy, acc))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_three_tf32_passes_meet_the_fp32_tolerance(i):
    """The kernels' arithmetic against the plain version (its fp32 sums,
    and its float64 sums, which the card's checks use) and the JAX
    package's call: within 1e-4 + 1e-5 |ref| at the path's reduction
    lengths, with zeros outside the groups and for an empty group."""
    got, plain = _case(i, passes=3)
    exact = _case(i, passes=3, acc=torch.float64)[1]
    print(f"{IDS[i]}: three passes {_ratio(got, plain):.3f}x the tolerance "
          f"(float64 sums {_ratio(got, exact):.3f}x)")
    assert _ratio(got, plain) <= 1.0, _ratio(got, plain)
    assert _ratio(got, exact) <= 1.0, _ratio(got, exact)
    want = _jax(i)
    if want is not None:
        assert _ratio(got, want) <= 1.0, _ratio(got, want)
    part, m, _, _, sizes, lead = CASES[i]
    if part == "dw":
        for g, size in enumerate(sizes):
            if size == 0:
                assert not got[g].any()
    else:
        end = lead + sum(sizes)
        assert not got[:lead].any() and not got[end:].any()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_one_tf32_pass_misses_the_fp32_tolerance(i):
    """hi hi alone (TF32's 11 bits) misses the tolerance at every case:
    the lo terms are what the fp32 route needs."""
    got, plain = _case(i, passes=1)
    print(f"{IDS[i]}: one pass {_ratio(got, plain):.1f}x the tolerance")
    assert _ratio(got, plain) > 1.0


def test_plain_version_in_float64_is_the_exact_sum_rounded_once():
    """``acc=torch.float64`` (what the card's fp32 checks hold the kernels
    to) sums in float64 and rounds once to fp32; the default sums in
    fp32, as before."""
    x, w, dy, offs = (torch.from_numpy(a) for a in _inputs(CASES[4]))
    offs = offs.int()
    exact = [(x[lo:hi].double().T @ dy[lo:hi].double()).float()
             for _, lo, hi in group_rows(offs, x.shape[0])]
    got = ragged_dot_dw_ref(x, w, offs, dy, acc=torch.float64)
    for g, want in enumerate(exact):
        assert torch.equal(got[g], want)
    assert torch.equal(ragged_dot_dw_ref(x, w, offs, dy),
                       ragged_dot_dw_ref(x, w, offs, dy, acc=torch.float32))
    assert got.dtype == torch.float32
    y = ragged_dot_ref(x[:, :32], w, offs, acc=torch.float64)
    assert y.dtype == torch.float32


@pytest.mark.parametrize("k,n,groups,ptrs,takes", [
    (4096, 14336, 8, (0, 256, 512), True),
    (2048, 1408, 64, (0, 16, 4096), True),
    (70, 96, 4, (0, 256, 512), False),      # K off 4
    (64, 198, 4, (0, 256, 512), False),     # N off 4
    (64, 96, 4, (8, 256, 512), False),      # a base off 16 bytes
    (64, 96, 1025, (0, 256, 512), False),   # more groups than a block keeps
    (64, 96, 1024, (0, 256, 512), True)])
def test_fp32_tensor_core_route_rule(k, n, groups, ptrs, takes):
    """fp32 calls take the TF32 tensor-core kernels where TMA copies
    whole 16-byte rows from 16-byte bases and the group edges fit a
    block (``tf::takes``), the CUDA-core kernels elsewhere."""
    assert ops.fp32_tc_route(k, n, groups, ptrs) is takes


def test_fp32_kernels_take_three_passes_in_32_deep_stages():
    """Both fp32 sources take their products from the shared TF32
    header at its three passes, each stage's three products a step
    summed apart and joined to the total, at the depth `_staged`
    emulates."""
    kernels = pathlib.Path(ops.__file__).parents[1]
    header = (kernels / "csrc" / "tf32_mma.cuh").read_text()
    assert int(re.search(r"constexpr int kPasses = (\d+);",
                         header).group(1)) == 3
    csrc = kernels / "ragged_dot" / "csrc"
    for name in ("ragged_dot.cu", "ragged_dot_bwd.cu"):
        src = (csrc / name).read_text()
        assert '#include "../../csrc/tf32_mma.cuh"' in src, name
        assert '#include "ragged_tf32.cuh"' in src, name
    tf = (csrc / "ragged_tf32.cuh").read_text()
    assert "static_assert(kPasses == 3" in tf
    assert f"constexpr int kBK = {STAGE};" in tf
    body = tf[tf.index("void products("):tf.index("// kDx false")]
    assert body.count("wgmma_rs128(chunk,") == 3
    assert "total[j] += chunk[j];" in body
    bwd = (csrc / "ragged_dot_bwd.cu").read_text()
    assert "products(total, chunk, ah, al," in bwd


def test_chip_smoke_holds_the_card_to_these_tolerances_and_passes():
    """chip_smoke.py's fp32 tolerance is this file's, and its fp32 bound
    counts three TF32 passes of 2 M K N FLOP."""
    import importlib.util
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.RAGGED_ATOL, smoke.RAGGED_RTOL["float32"]) == (ATOL, RTOL)
    bound = smoke.ragged_bwd_bound("dx", 8192, 4096, 14336, 8, 8,
                                   x_bytes=4, w_bytes=4)
    assert bound["bound_ms"] == pytest.approx(
        1e3 * 3 * bound["flop"] / smoke.PEAK_TF32_S)
    assert smoke.plain_acc(torch.zeros(1)) == torch.float64
    assert smoke.plain_acc(torch.zeros(1, dtype=torch.bfloat16)) == \
        torch.float32
