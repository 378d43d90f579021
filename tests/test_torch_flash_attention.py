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
