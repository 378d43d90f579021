"""The backward of the port's flash attention against the JAX package:
the rows' LSE of the plain forward and the plain backward
(`ref.flash_attention_bwd_ref`, and the autograd Function's CPU backward)
against ``jax.vjp`` of the reference's ``flash_attention_ref`` (what
``jax.grad`` differentiates when the reference trains past 4096^2
pairs); a plain model of the bf16 backward kernels' roundings
(``csrc/flash_attention_bwd.cu``), which fixes the tolerance the card's
comparison uses, and of the fp32 kernels' split-TF32 products, which
fixes their passes; and one fp32 train step of a smoke config at S = 4160,
past 4096^2 (query, key) pairs, against the reference's ``jax.grad``.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances: fp32 gradients within 1e-5 max |ref| (the orders of fp32
sums), the LSE within 1e-5 (+ 1e-5 |lse|); the bf16 design within
`BF16_TOL` max |ref| of each gradient; the train step's gradients
within 1e-4 max |ref| (tests/test_torch_train.py's)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from _tf32 import split_mm  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, flash_bwd_dkdv_ref,
    flash_bwd_dq_ref)

FP32_TOL = 1e-5
#: The bf16 kernels' tolerance, each gradient against max |ref|: their
#: design (P and dS each one bf16 term, the gradients rounded once to
#: bf16) stays well inside it on the cases below (``pytest -s`` prints
#: each); most of its error is the final rounding of the gradients (2^-9
#: of the largest) and the bf16 output in delta, which exact P and dS
#: leave as they are.
BF16_TOL = 1e-2
# b, sq, sk, hq, hkv, d, window, q_offset
CASES = [
    (2, 128, 128, 4, 2, 64, None, 0),       # GQA causal
    (1, 200, 333, 4, 1, 48, None, 133),     # Sk off the block, GQA 4:1
    (1, 256, 256, 8, 2, 64, 100, 0),        # sliding window
    (1, 64, 64, 2, 2, 128, 16, 0),          # small window
    (1, 96, 96, 2, 1, 32, None, -40),       # 40 rows see no key
    (1, 130, 130, 2, 2, 256, None, 0),      # D = 256
    (1, 150, 170, 4, 2, 200, 64, 20),       # D off 64, window, offset
]


def _inputs(case, seed=11):
    b, sq, sk, hq, hkv, d, _, _ = case
    rng = np.random.default_rng(seed + sq + d)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sq, hq, d)).astype(np.float32))


def _jax_vjp(q, k, v, do, window, q_offset, block_k=64):
    """(out, (dq, dk, dv)) of the reference's chunked attention in fp32."""
    out, vjp = jax.vjp(
        lambda a, b_, c: jax_flash_ref(a, b_, c, q_offset=q_offset,
                                       window=window, block_k=block_k),
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _lse64(q, k, window, q_offset):
    """Each row's log-sum-exp of its visible scaled logits in float64
    (B, Hq, Sq); -inf where no key is visible."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * d ** -0.5
    qp = q_offset + np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    mask = kp <= qp
    if window:
        mask &= qp - kp < window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    total = np.exp(s - m_safe).sum(-1)
    with np.errstate(divide="ignore"):
        return np.where(total > 0, m_safe[..., 0] + np.log(total), -np.inf)


def _hold(got, want, tol, what=""):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        err = float(np.abs(g - w).max())
        bound = tol * float(np.abs(w).max())
        assert err <= bound, (what, name, err, bound)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_lse_matches_float64(case):
    """The plain forward's LSE: the rows' log-sum-exp of their visible
    scaled logits, -inf for a row that sees no key; its output is the
    one it returns without the LSE."""
    _, _, _, _, _, _, win, off = case
    q, k, v, _ = _inputs(case)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention_ref(qt, kt, vt, q_offset=off, window=win,
                                   block_k=64, return_lse=True)
    assert torch.equal(out, flash_attention_ref(qt, kt, vt, q_offset=off,
                                                window=win, block_k=64))
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert lse.dtype == torch.float32
    want = _lse64(q, k, win, off)
    got = lse.numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <=
            1e-5 + 1e-5 * np.abs(want[fin])).all()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case):
    """`flash_attention_bwd_ref` (and its two halves, as the two kernels
    compute them) against ``jax.vjp`` of the reference's chunked
    attention in fp32; rows with no visible key get zero dq."""
    _, sq, _, _, _, _, win, off = case
    q, k, v, do = _inputs(case)
    out, want = _jax_vjp(q, k, v, do, win, off)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_ref(qt, kt, vt, q_offset=off, window=win,
                                 block_k=64, return_lse=True)
    np.testing.assert_allclose(o.numpy(), out, atol=2e-5, rtol=2e-5)
    got = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, q_offset=off,
                                  window=win, block_k=96)
    _hold(got, want, FP32_TOL, case)
    # The halves compute the same sums (a CPU BLAS may split them across
    # threads differently from call to call: within fp32 noise).
    kw = dict(q_offset=off, window=win, block_k=64)
    full = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    halves = (flash_bwd_dq_ref(qt, kt, vt, o, lse, dot, **kw),
              *flash_bwd_dkdv_ref(qt, kt, vt, o, lse, dot, **kw))
    _hold(halves, [t.numpy() for t in full], 1e-6, case)
    if off < 0:   # rows before position 0 see no key
        assert not got[0][:, :min(sq, -off)].any()


@pytest.mark.parametrize("case", CASES[:5], ids=str)
def test_function_backward_on_the_cpu_matches_jax_vjp(case):
    """`ops.flash_attention` under autograd on the CPU: one autograd
    Function (forward with the LSE, backward the plain version),
    launching nothing, with the reference's gradients."""
    _, _, _, _, _, _, win, off = case
    q, k, v, do = _inputs(case, seed=5)
    _, want = _jax_vjp(q, k, v, do, win, off)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = dict(LAUNCHES)
    out = ops.flash_attention(*leaves, q_offset=off, window=win, block_k=64)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert LAUNCHES == before
    _hold(got, want, FP32_TOL, case)


# ---- the bf16 kernels' roundings (csrc/flash_attention_bwd.cu)

def _bf16_design(q, k, v, o, lse, do, *, q_offset=0, window=None,
                 terms: int = 1):
    """The bf16 backward kernels' arithmetic in plain torch: bf16 q, k,
    v, o and dO; S and dP as fp32 sums of exact products; delta in fp32
    from the bf16 output; P = exp2(S scale log2(e) - LSE log2(e)); P (for
    dV) and dS (for dQ and dK) rounded to ``terms`` bf16 terms (0: kept
    in fp32); every gradient summed in fp32 and rounded once to bf16."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale, log2e = d ** -0.5, 1.4426950408889634

    def rounded(x):
        if terms == 0:
            return x
        hi = x.bfloat16().float()
        return hi if terms == 1 else hi + (x - hi).bfloat16().float()
    qf = q.float().reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, d)
    kf, vf = k.float(), v.float()
    delta = (dof * o.float().reshape(b, sq, hkv, g, d)).sum(-1)
    lse2 = lse.transpose(1, 2).reshape(b, sq, hkv, g) * log2e
    qp = q_offset + torch.arange(sq)
    kp = torch.arange(sk)
    mask = qp[:, None] >= kp[None, :]
    if window:
        mask &= (qp[:, None] - kp[None, :]) < window
    mask = mask[None, :, None, None, :]
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf)
    p = torch.where(mask, torch.exp2(s * (scale * log2e) - lse2[..., None]),
                    0.0)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf)
    ds = rounded(p * (dp - delta[..., None]))
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bqhgk,bqhgd->bkhd", rounded(p), dof)
    return (dq.reshape(b, sq, hq, d).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def _bf16_case(case, seed=7):
    _, _, _, _, _, _, win, off = case
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in
                   _inputs(case, seed))
    o, lse = flash_attention_ref(q.float(), k.float(), v.float(),
                                 q_offset=off, window=win, return_lse=True)
    _, want = _jax_vjp(*(a.float().numpy() for a in (q, k, v, do)), win, off)
    return (q, k, v, o.bfloat16(), lse, do), want


@pytest.mark.parametrize("case", CASES + [
    (1, 1024, 1024, 8, 4, 256, None, 0),    # gemma3's global layer
    (1, 768, 768, 4, 2, 256, 128, 0),       # and its local one
    (1, 1024, 1024, 2, 1, 64, None, 0)], ids=str)
def test_bf16_design_meets_its_tolerance(case):
    """The bf16 design (single bf16 terms for P and dS) within `BF16_TOL`
    of each gradient's max |ref| against ``jax.vjp`` in fp32 of the same
    bf16 values; and no looser than the issue's bound of 2e-2."""
    assert BF16_TOL <= 2e-2
    _, _, _, _, _, _, win, off = case
    args, want = _bf16_case(case)
    got = _bf16_design(*args, q_offset=off, window=win)
    ratios = [float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
              for g, w in zip(got, want)]
    print(f"{case}: max |err| / max |ref| " + ", ".join(
        f"{name} {r:.2e}" for name, r in zip(("dq", "dk", "dv"), ratios)))
    _hold(got, want, BF16_TOL, case)


@pytest.mark.parametrize("case", [(1, 512, 512, 4, 2, 128, None, 0),
                                  (1, 768, 768, 4, 2, 256, 128, 0)], ids=str)
def test_bf16_single_terms_cost_little_beyond_the_final_rounding(case):
    """Why one bf16 term is enough for P and dS: exact P and dS (fp32)
    leave the error within 2x of the single-term design's, since the
    gradients' own final rounding to bf16 (and the bf16 output in delta)
    dominate; and two terms are no better than exact."""
    _, _, _, _, _, _, win, off = case
    args, want = _bf16_case(case, seed=3)
    errs = {}
    for terms in (0, 1, 2):
        got = _bf16_design(*args, q_offset=off, window=win, terms=terms)
        errs[terms] = max(float(np.abs(gg.float().numpy() - w).max() /
                                np.abs(w).max()) for gg, w in zip(got, want))
    print(f"{case}: worst max |err| / max |ref| by bf16 terms of P and "
          f"dS (0: exact): {errs}")
    assert errs[1] <= 2 * errs[0], errs
    assert errs[2] <= 1.1 * errs[0], errs
    assert errs[1] <= BF16_TOL / 2, errs


# ---- the fp32 kernels' split-TF32 design (csrc/flash_attention_bwd.cu)

def _kernel_tiles(d):
    """The fp32 kernels' (keys a dq tile, queries a dk/dv tile) at head
    dimension ``d``: 32 and 32 on wgmma (D <= 64) and on mma.sync up to
    D = 192, 16 and 16 past it (`f32::Cfg<NP>` and `f32::wg` in
    csrc/flash_attention_bwd.cu)."""
    return (32, 32) if d <= 192 else (16, 16)


def _tf32_design(q, k, v, o, lse, do, *, q_offset=0, window=None,
                 passes=3, s_plain=False):
    """The fp32 backward kernels' arithmetic in plain torch: every product
    split into ``passes`` TF32 products (`split_mm`; S and dP too, unless
    ``s_plain``, which sums them in fp32 as the plain version does); Q
    scaled by D^-0.5 in fp32 first, P = exp(S - LSE) (exp, not exp2),
    delta = rowsum(dO O) in fp32.  The tiles are the kernels'
    (`_kernel_tiles`).  dq: dQ summed over key tiles, each tile's product
    formed afresh and added in fp32, times D^-0.5 at the end.  dk/dv: the
    group's heads in order and, for each, its query tiles in order, each
    tile's dV += P^T dO and dK += dS^T (q D^-0.5) formed afresh and added
    in fp32, as the kernels walk them."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    bk, bqt = _kernel_tiles(d)

    def mm(eq, a, c):
        return split_mm(eq, a, c, passes)

    qs = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dof = do.float()
    delta = (dof * o.float()).sum(-1)                         # (B, Sq, Hq)
    prod = torch.einsum if s_plain else mm
    s = prod("bqhd,bkhd->bhqk", qs, kf)
    dp = prod("bqhd,bkhd->bhqk", dof, vf)
    qp = q_offset + torch.arange(sq)
    kp = torch.arange(sk)
    mask = qp[:, None] >= kp[None, :]
    if window:
        mask &= (qp[:, None] - kp[None, :]) < window
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (dp - delta.transpose(1, 2)[..., None])
    dq = torch.zeros((b, hq, sq, d))
    for j0 in range(0, sk, bk):
        dq = dq + mm("bhqk,bkhd->bhqd", ds[..., j0:j0 + bk],
                     kf[:, j0:j0 + bk])
    dq = (dq * scale).transpose(1, 2)
    dk = torch.zeros((b, hkv, sk, d))
    dv = torch.zeros((b, hkv, sk, d))
    pg, dsg = (t.reshape(b, hkv, g, sq, sk) for t in (p, ds))
    dog, qsg = (t.reshape(b, sq, hkv, g, d) for t in (dof, qs))
    for hg in range(g):
        for i0 in range(0, sq, bqt):
            rows = slice(i0, i0 + bqt)
            dv = dv + mm("bhqk,bqhd->bhkd", pg[:, :, hg, rows],
                         dog[:, rows, :, hg])
            dk = dk + mm("bhqk,bqhd->bhkd", dsg[:, :, hg, rows],
                         qsg[:, rows, :, hg])
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


_FP32_CASES: dict = {}
_FP32_DESIGNS: dict = {}


def _fp32_case(case, seed=7):
    """fp32 inputs, the plain forward's output and LSE, dO, and
    ``jax.vjp``'s gradients of the same values (kept for the tests that
    share a case)."""
    if (case, seed) not in _FP32_CASES:
        _, _, _, _, _, _, win, off = case
        q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed))
        o, lse = flash_attention_ref(q, k, v, q_offset=off, window=win,
                                     return_lse=True)
        _, want = _jax_vjp(*(a.numpy() for a in (q, k, v, do)), win, off)
        _FP32_CASES[case, seed] = (q, k, v, o, lse, do), want
    return _FP32_CASES[case, seed]


def _design_ratios(case, **kw):
    """Each gradient's max |error| / max |ref| of `_tf32_design` with
    ``kw`` on the case's inputs (kept for the tests that share one)."""
    key = (case, tuple(sorted(kw.items())))
    if key not in _FP32_DESIGNS:
        _, _, _, _, _, _, win, off = case
        args, want = _fp32_case(case)
        _FP32_DESIGNS[key] = _ratios(
            _tf32_design(*args, q_offset=off, window=win, **kw), want)
    return _FP32_DESIGNS[key]


def _ratios(got, want):
    return [float(np.abs(g.numpy() - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


#: gemma3's global layer (D = 256, GQA 8:4) at 1024 tokens, where S past
#: D = 64 is settled.
FP32_WIDE = (1, 1024, 1024, 8, 4, 256, None, 0)


@pytest.mark.parametrize("case", CASES + [
    FP32_WIDE, (1, 768, 768, 4, 2, 128, 128, 0),
    (1, 1024, 1024, 2, 1, 64, None, 0)], ids=str)
def test_split_tf32_backward_design_meets_the_fp32_tolerance(case):
    """The fp32 design (three TF32 products per fp32 product, S and dP
    included at every D) within 1e-5 of each gradient's max |ref| against
    ``jax.vjp`` in fp32 (`FP32_TOL`)."""
    ratios = _design_ratios(case)
    print(f"{case}: max |err| / max |ref| " + ", ".join(
        f"{name} {r:.2e}" for name, r in zip(("dq", "dk", "dv"), ratios)))
    assert max(ratios) <= FP32_TOL, (case, ratios)


def test_split_s_past_d64_is_as_close_as_the_plain_order():
    """Why S and dP take three TF32 passes past D = 64 too: at D = 256 the
    design (2.9e-6 of max |ref| here) stays within half the fp32
    tolerance, and within 2x of the same design with S and dP summed in
    fp32 in the plain version's order (1.6e-6): most of its error is
    fp32's own.  (The forward's 2e-6 on its output is what a split S
    missed; the backward's gradients are held at 1e-5 of their max.)"""
    split = max(_design_ratios(FP32_WIDE))
    plain = max(_design_ratios(FP32_WIDE, s_plain=True))
    print(f"D = 256: split S {split:.2e}, plain-order S {plain:.2e}")
    assert split <= FP32_TOL / 2 and plain <= FP32_TOL / 2, (split, plain)
    assert split <= 2 * plain, (split, plain)


@pytest.mark.parametrize("case", [FP32_WIDE,
                                  (1, 1024, 1024, 2, 1, 64, None, 0)],
                         ids=str)
def test_one_tf32_pass_misses_the_fp32_backward_tolerance(case):
    """One TF32 product (hi hi) per fp32 product misses the 1e-5
    tolerance by over 10x: three is the fewest the bound counts (two,
    hi hi + hi lo, drop an error of the same size as one)."""
    one = max(_design_ratios(case, passes=1))
    two = max(_design_ratios(case, passes=2))
    print(f"{case}: one pass {one:.2e}, two {two:.2e}")
    assert one > 10 * FP32_TOL, one
    assert two > FP32_TOL, two


def test_fp32_backward_passes_match_the_kernel_source():
    """The fp32 backward kernels take their products from the shared
    TF32 header at its three passes, the count chip_smoke.py's fp32
    bound of the backward uses, in the tiles `_kernel_tiles` emulates."""
    import importlib.util
    import pathlib
    import re
    kernels = pathlib.Path(ops.__file__).parents[1]
    src = (kernels / "flash_attention" / "csrc" /
           "flash_attention_bwd.cu").read_text()
    assert '#include "../../csrc/tf32_mma.cuh"' in src
    header = (kernels / "csrc" / "tf32_mma.cuh").read_text()
    passes = int(re.search(r"constexpr int kPasses = (\d+);",
                           header).group(1))
    assert passes == 3
    assert src.count("static_assert(kPasses == 3") >= 2   # both kernels
    # Tiles: f32::Cfg<NP> (NP = ceil(D / 64)) past D = 64, f32::wg below.
    assert "static constexpr int kBK = NP <= 3 ? 32 : 16;" in src
    assert "static constexpr int kBQT = NP == 4 ? 16 : 32;" in src
    wg = src[src.index("namespace wg {"):src.index("}  // namespace wg")]
    assert "constexpr int kBK = 32;" in wg and "constexpr int kBQT = 32;" in wg
    assert [_kernel_tiles(d) for d in (48, 64, 128, 192, 193, 256)] == (
        [(32, 32)] * 4 + [(16, 16)] * 2)
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FA_PASSES_FP32 == passes
    bound = smoke.flash_bwd_bound("bwd", 1, 64, 64, 2, 1, 64, 0, fp32=True)
    assert bound["bound_ms"] == pytest.approx(
        1e3 * passes * bound["flop"] / smoke.PEAK_TF32_S)


# ---- one train step past 4096^2 pairs

LONG_SEQ = 4160     # 4160^2 > 4096^2: attention takes flash


@pytest.mark.parametrize("arch", ["gemma3-4b", "mixtral-8x7b",
                                  "starcoder2-7b"])
def test_fp32_train_step_past_4096_squared_pairs_matches_jax_grad(
        arch, monkeypatch):
    """The smoke config's gradients at (1, 4160), where both packages send
    attention to their chunked flash attention (the port's through its
    autograd Function, forward and recomputation under remat, one
    backward a layer), against the reference's ``jax.grad`` in fp32, each
    leaf within 1e-4 max |ref| (+ 1e-6)."""
    from _torch_compare import fp32_compute
    from repro.configs import get_smoke_config as ref_smoke
    from repro.data import DataConfig as RefDataConfig
    from repro.data import make_pipeline as ref_pipeline
    from repro.models import model as RM
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import convert
    from repro_torch.models import model as M
    fp32_compute(monkeypatch)
    ref_cfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    params = RM.init_params(ref_cfg, 0)
    data = dict(vocab=cfg.vocab, seq_len=LONG_SEQ, global_batch=1, seed=0)
    batch = ref_pipeline(RefDataConfig(**data)).batch(0)
    (_, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, {k: jnp.asarray(v) for k, v in
                                          batch.items()}),
        has_aux=True))(params)
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu").requires_grad_()
    calls = []
    real = ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.enable_grad():
        loss, _ = M.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
    assert len(calls) == cfg.n_layers
    grads = convert.to_reference_tree(
        zip(dict(model.named_parameters()), grads))
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(ref_grads)[0],
            jax.tree.leaves(grads)):
        want = np.asarray(want)
        err = float(np.abs(got - want).max()) if want.size else 0.0
        bound = 1e-4 * float(np.abs(want).max(initial=0.0)) + 1e-6
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
