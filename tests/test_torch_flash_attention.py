"""The port's flash attention against the JAX package: its plain torch
version (`repro_torch.kernels.flash_attention.ref`) against the
reference's `flash_attention_ref` on every case of the reference's own
sweep, and against the Pallas kernel in interpret mode; the wrapper's
dispatch and checks.  Inputs are made with numpy from a seed and handed
to both.

Tolerances: fp32 at 2e-5, the JAX package's tolerance between its two
fp32 formulations of attention (tests/test_kernels.py:66, the chunked
oracle against dense SDPA); bf16 at 2e-2, the reference's bf16 kernel
tolerance (tests/test_kernels.py:50)."""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from _tf32 import split_mm, tf32, tf32_split  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

# The reference's FA_CASES (tests/test_kernels.py:17-25):
# b, sq, sk, hq, hkv, d, window, q_offset
FA_CASES = [
    (2, 128, 128, 4, 2, 64, None, 0),       # GQA causal
    (1, 256, 256, 4, 4, 32, None, 0),       # MHA
    (2, 128, 384, 4, 1, 64, None, 256),     # decode-extend vs long cache
    (1, 256, 256, 8, 2, 64, 100, 0),        # sliding window
    (1, 64, 64, 2, 2, 128, 16, 0),          # small window
    (1, 1, 512, 4, 2, 64, None, 511),       # single-token decode
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=42):
    b, sq, sk, hq, hkv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_plain_version_matches_reference(case, dtype):
    _, _, _, _, _, _, win, off = case
    q, k, v = _inputs(case)
    want = jax_flash_ref(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                         q_offset=off, window=win)
    tdt = getattr(torch, dtype)
    got = flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)),
                              q_offset=off, window=win)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_version_matches_pallas_interpret():
    case = FA_CASES[0]
    q, k, v = _inputs(case)
    want = flash_attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                  block_q=64, block_k=64, interpret=True)
    got = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("window", [None, 0, -3, 100])
def test_wrapper_on_cpu_runs_the_plain_version(window):
    """CPU tensors take the plain version (no launch); a window <= 0
    means none, as in the reference."""
    case = FA_CASES[3]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    before = LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window)
    assert LAUNCHES["flash_attention"] == before
    want = flash_attention_ref(q, k, v, window=window)
    assert torch.equal(got, want)
    if window is not None and window <= 0:
        assert torch.equal(got, flash_attention_ref(q, k, v))


def test_rows_with_no_visible_key_are_zero():
    """A window that hides every key (queries far past a short cache)
    gives 0, not NaN, as the reference's guards do."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 8, 1, 16)).astype(np.float32)
    want = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(k), q_offset=100, window=5))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(k), q_offset=100, window=5)
    assert np.all(want == 0) and torch.equal(got, torch.zeros_like(got))


def test_wrapper_checks_its_input():
    q = torch.zeros((1, 4, 4, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 4, 3, 16)),
                            torch.zeros((1, 4, 3, 16)))
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def _tc_emulation(q, k, v, *, q_offset=0, window=None):
    """The bf16 tensor-core kernel's arithmetic (csrc/flash_attention_tc.cu)
    in plain torch: query tiles of 128 rows, each walking key tiles of 64
    from its first visible key; fp32 scores of the bf16 operands scaled
    by D^-0.5 log2(e); an fp32 online softmax in exp2; row sums of the
    fp32 P; P rounded to bf16 before P V, accumulated in fp32."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 * math.log2(math.e)
    win = window if window is not None and window > 0 else 0
    qf = q.float()
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    out = torch.zeros((b, sq, hq, d))
    for q0 in range(0, sq, 128):
        q1 = min(q0 + 128, sq)
        qp = q_offset + torch.arange(q0, q1)
        k_end = min(sk, q_offset + q1)
        k_begin = max(0, q_offset + q0 - win + 1) if win else 0
        m = torch.full((b, q1 - q0, hq), -torch.inf)
        l = torch.zeros((b, q1 - q0, hq))
        acc = torch.zeros((b, q1 - q0, hq, d))
        for j0 in range(k_begin, k_end, 64):
            keys = torch.arange(j0, min(j0 + 64, sk))
            s = torch.einsum("bqhd,bkhd->bqhk", qf[:, q0:q1],
                             kf[:, keys]) * scale
            ok = keys[None, :] <= qp[:, None]
            if win:
                ok &= (qp[:, None] - keys[None, :]) < win
            s = torch.where(ok[None, :, None, :], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp2(m - m_safe)
            p = torch.exp2(s - m_safe[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhk,bkhd->bqhd", p.bfloat16().float(), vf[:, keys])
            m = m_new
        out[:, q0:q1] = acc / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("case", FA_CASES + [
    (1, 200, 150, 4, 1, 48, 64, 20),        # ragged tiles, GQA 4:1, D 48
    (1, 300, 333, 2, 2, 128, None, 0)],     # Sq > 2 query tiles, D 128
    ids=str)
def test_tensor_core_design_meets_the_bf16_tolerance(case):
    """The tensor-core design (P rounded to bf16 per key tile of 64)
    against the JAX package's reference on bf16 inputs, at the kernel's
    bf16 tolerance."""
    _, _, _, _, _, _, win, off = case
    q, k, v = _inputs(case)
    want = jax_flash_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         q_offset=off, window=win)
    got = _tc_emulation(*(torch.from_numpy(a).bfloat16()
                          for a in (q, k, v)), q_offset=off, window=win)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


# ---- the fp32 kernel's split-TF32 design (csrc/flash_attention.cu)

FA_TOL_FP32 = 2e-6    # the fp32 kernel's tolerance against its plain version


def _tf32_emulation(q, k, v, *, q_offset=0, window=None, passes=3):
    """The fp32 kernel's arithmetic in plain torch: query tiles of 128
    rows and key tiles of 64 (64 and 32 past D = 128), each block walking
    key tiles from its first visible key; P V as split-TF32 products
    (`split_mm`), afresh per key tile, and S = (q D^-0.5) K^T too up to
    D = 64 (past it the kernel sums S in fp32 in the plain version's
    order); the plain version's online softmax in exp, and its final
    division."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    bq, bk = (128, 64) if d <= 128 else (64, 32)
    win = window if window is not None and window > 0 else 0
    qs = q.float() * d ** -0.5
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    out = torch.zeros((b, sq, hq, d))
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        qp = q_offset + torch.arange(q0, q1)
        k_end = min(sk, q_offset + q1)
        k_begin = max(0, q_offset + q0 - win + 1) if win else 0
        m = torch.full((b, q1 - q0, hq), -torch.inf)
        l = torch.zeros((b, q1 - q0, hq))
        acc = torch.zeros((b, q1 - q0, hq, d))
        for j0 in range(k_begin, k_end, bk):
            keys = torch.arange(j0, min(j0 + bk, sk))
            s = split_mm("bqhd,bkhd->bqhk", qs[:, q0:q1], kf[:, keys],
                          passes) if d <= 64 else torch.einsum(
                "bqhd,bkhd->bqhk", qs[:, q0:q1], kf[:, keys])
            ok = keys[None, :] <= qp[:, None]
            if win:
                ok &= (qp[:, None] - keys[None, :]) < win
            s = torch.where(ok[None, :, None, :], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp(m - m_safe)
            p = torch.exp(s - m_safe[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + split_mm(
                "bqhk,bkhd->bqhd", p, vf[:, keys], passes)
            m = m_new
        out[:, q0:q1] = acc / l.clamp(min=1e-30)[..., None]
    return out


LONG_CASE = (1, 2048, 2048, 4, 4, 64, None, 0)


def _tf32_error(case, passes=3):
    """max |emulation - plain version| on fp32 inputs, and the emulated
    output beside the JAX package's reference."""
    _, _, _, _, _, _, win, off = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(case))
    got = _tf32_emulation(q, k, v, q_offset=off, window=win, passes=passes)
    want = flash_attention_ref(q, k, v, q_offset=off, window=win)
    return float((got - want).abs().max()), got


@pytest.mark.parametrize("case", FA_CASES + [
    (1, 200, 150, 4, 1, 48, 64, 20),        # ragged tiles, GQA 4:1, D 48
    (1, 150, 170, 2, 1, 192, None, 0),      # 64-row, 32-key tiles
    LONG_CASE], ids=str)
def test_split_tf32_design_meets_the_fp32_tolerance(case):
    """The fp32 kernel's design (three TF32 products per fp32 product)
    against the plain version at the kernel's fp32 tolerance (2e-6), and
    against the JAX package's reference at this file's fp32 tolerance."""
    _, _, _, _, _, _, win, off = case
    err, got = _tf32_error(case)
    assert err <= FA_TOL_FP32, err
    want = jax_flash_ref(*(jnp.asarray(a) for a in _inputs(case)),
                         q_offset=off, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("passes", [1, 2])
def test_fewer_tf32_products_miss_the_fp32_tolerance(passes):
    """One TF32 product (hi hi), or two (hi hi + hi lo), per fp32 product
    misses the fp32 tolerance by over 100x at 2048 tokens: three is the
    fewest, which is what chip_smoke.py's fp32 flash bound counts."""
    err, _ = _tf32_error(LONG_CASE, passes=passes)
    assert err > 100 * FA_TOL_FP32, err


def test_tf32_rounding_and_split():
    """`_tf32` keeps 10 explicit mantissa bits, rounding to nearest with
    ties to even; hi + lo carries x to about 2^-22 relative."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, one + 2.0 ** -11,
                      -(1.0 + 3 * 2.0 ** -12), 3.0e-20, -7.5e8],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one, 1.0, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 3.0e-20, -7.5e8],
                        dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi, lo = tf32_split(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -22
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11


def test_fp32_passes_match_the_kernel_source():
    """chip_smoke.py's `FA_PASSES_FP32` (its fp32 flash bound) is the
    number of TF32 products the kernel takes per fp32 product: the shared
    header's `kPasses`, which the kernel's products are held to."""
    import importlib.util
    import pathlib
    import re
    kernels = pathlib.Path(ops.__file__).parents[1]
    src = (kernels / "flash_attention" / "csrc" /
           "flash_attention.cu").read_text()
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
    assert smoke.FA_PASSES_FP32 == passes == 3
    assert smoke.FA_TOL["float32"] == FA_TOL_FP32


def _dense64(q, k, v, *, q_offset, window):
    """Attention in float64, densely: the result both fp32 versions
    approximate."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kd = k.double().repeat_interleave(hq // hkv, dim=2)
    vd = v.double().repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) * d ** -0.5
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    ok = (kp <= qp) & ((qp - kp) < window if window else True)
    p = torch.softmax(torch.where(ok, s, -torch.inf), -1).nan_to_num()
    return torch.einsum("bhqk,bkhd->bqhd", p, vd)


def test_wide_heads_sum_s_in_the_plain_order(monkeypatch):
    """Why the fp32 kernel sums S in fp32 past D = 64: at D = 256 the
    plain fp32 version is itself about 1e-6 from a float64 result, so an
    S of split TF32 products, about as far from it on its own account,
    parts from the plain version by more than the 2e-6 tolerance on some
    of six inputs; S summed in the plain version's order (the kernel's
    FMA chains) stays within it on all six."""
    case = (1, 200, 260, 4, 1, 256, 70, 60)
    b, sq, sk, hq, hkv, d, win, off = case
    fp32_s, split_s, plain_err = [], [], []
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=g) for shape in
                   ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
        want = flash_attention_ref(q, k, v, q_offset=off, window=win)
        plain_err.append(float((want.double() - _dense64(
            q, k, v, q_offset=off, window=win)).abs().max()))
        fp32_s.append(float((_tf32_emulation(
            q, k, v, q_offset=off, window=win) - want).abs().max()))
        real_einsum = torch.einsum

        def split_s_einsum(eq, a, c):
            if eq == "bqhd,bkhd->bqhk":
                ah, al = tf32_split(a)
                ch, cl = tf32_split(c)
                return real_einsum(eq, ah, ch) + (real_einsum(eq, ah, cl) +
                                                  real_einsum(eq, al, ch))
            return real_einsum(eq, a, c)

        monkeypatch.setattr(torch, "einsum", split_s_einsum)
        got = _tf32_emulation(q, k, v, q_offset=off, window=win)
        monkeypatch.setattr(torch, "einsum", real_einsum)
        split_s.append(float((got - want).abs().max()))
    assert max(plain_err) > 1e-6, plain_err
    assert max(fp32_s) <= FA_TOL_FP32, fp32_s
    assert max(split_s) > FA_TOL_FP32, split_s


def _chip_smoke():
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (8, 8, 0, None), (8, 8, 0, 0), (16, 16, 0, 4), (10, 30, 20, 7),
    (7, 20, 13, None), (1, 512, 511, 100), (12, 5, 0, 3), (300, 333, 60, 70),
    (4, 8, 100, 5)], ids=str)
def test_flash_bound_counts_the_masks_pairs(sq, sk, q_offset, window):
    """chip_smoke.py's `flash_bound` counts the (query, key) pairs that
    the reference's `causal_window_mask` lets through (keys below Sk),
    with and without a window and a q_offset; its FLOP are 4 D of them
    per head and batch row."""
    from repro.models.attention import causal_window_mask
    smoke = _chip_smoke()
    mask = causal_window_mask(q_offset + jnp.arange(sq), jnp.arange(sk),
                              window)
    want = int(np.asarray(mask).sum())
    assert smoke.visible_pairs(sq, sk, q_offset, window) == want
    bound = smoke.flash_bound(2, sq, sk, 3, 16, 1000, q_offset=q_offset,
                              window=window)
    assert bound["pairs"] == want and bound["flop"] == 4 * 16 * want * 3 * 2


def test_flash_bound_at_the_path_shapes():
    """Plain causal at 8192 is S (S + 1) / 2 pairs a head, as before the
    window was counted (zamba2's bound unchanged); gemma3's local layers
    (window 1024) see 7.86e6 of them, not 33.6e6."""
    smoke = _chip_smoke()
    s = 8192
    assert smoke.visible_pairs(s, s) == s * (s + 1) // 2
    assert smoke.visible_pairs(s, s, 0, 0) == s * (s + 1) // 2
    assert smoke.visible_pairs(s, s, 0, 1024) == \
        1024 * 1025 // 2 + (s - 1024) * 1024 == 7_864_832
