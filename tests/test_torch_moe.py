"""The port's mixture-of-experts FFN, its grouped product and MLA against
the JAX package, on seeded numpy inputs.

- `ragged_dot`'s plain version against ``jax.lax.ragged_dot`` (bf16
  operands, empty groups included): within one bf16 ulp of the
  reference (each group's product in fp32, rounded once; the two sum in
  other orders, so a result next to a rounding edge can take the other
  side: 3 of 57,600 entries at the first case's shape).
- fp32 weights with bf16 x (the expert stacks as the FFN passes them):
  the plain version rounds them to bf16 first, bit for bit a cast, and
  stays within one bf16 ulp of the reference on its cast weights; other
  mixed pairs raise; `ops.tc_route` sends exactly the aligned shapes to
  the TMA kernel; the FFN on fp32 stacks equals the FFN on cast ones.
- `moe_ffn` and `moe_ffn_capacity` against the reference's functions
  compiled without XLA's excess precision (the reference's own bf16
  roundings, equal to its run under ``jax.disable_jit()``): the routing
  (top-k experts, the stable sort, the group sizes) exactly, the output
  within one bf16 ulp (measured: equal), the aux loss within 1e-6.
- MLA: the no-cache forward and both cached paths (absorbed and naive)
  against the reference's, and the two cached paths against each other
  at the reference's own 2e-2 (tests/test_models.py:136).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as RA  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.ragged_dot import ops as rd_ops  # noqa: E402
from repro_torch.kernels.ragged_dot import ragged_dot  # noqa: E402
from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}


def strict_jit(fn, *args):
    """``fn`` compiled for ``args`` without excess precision."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


def within_one_ulp(got, want) -> np.ndarray:
    """bf16 results at most one bf16 ulp apart (an ulp of |v| is at most
    2^-7 |v|)."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return np.abs(got - want) <= 2.0 ** -7 * np.maximum(np.abs(got),
                                                         np.abs(want))


def _offsets(sizes) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32)


# ------------------------------------------------------------ ragged_dot
RAGGED_CASES = [  # (M, K, N, group sizes)
    (240, 64, 240, [60, 0, 100, 0, 80]),
    (96, 64, 96, [96, 0, 0, 0]),
    (37, 72, 40, [0, 0, 20, 17]),
    (130, 48, 33, [1, 128, 1]),
    (8, 16, 8, [2, 2, 2, 2, 0, 0, 0, 0]),
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=str)
def test_plain_ragged_dot_matches_jax(case):
    m, k, n, sizes = case
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5) \
        .astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax.lax.ragged_dot(xb, wb, jnp.asarray(sizes, jnp.int32))
    got = ragged_dot(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(w).bfloat16(), _offsets(sizes))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    ok = within_one_ulp(got.float().numpy(), want)
    print(f"{case}: {int((~ok).sum())} beyond an ulp, "
          f"{int((got.float().numpy() != np.asarray(want, np.float32)).sum())}"
          f" of {m * n} differ")
    assert ok.all()


def test_plain_ragged_dot_zeroes_rows_outside_the_groups():
    """Rows before offsets[0] and past offsets[G] are zero, and offsets
    that go down make empty groups (as the kernel reads them)."""
    x = torch.randn(10, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(3, 8, 4, generator=torch.Generator().manual_seed(1))
    got = ragged_dot_ref(x, w, torch.tensor([2, 5, 4, 8]))
    assert not got[:2].any() and not got[8:].any()
    torch.testing.assert_close(got[2:5], x[2:5] @ w[0], rtol=0, atol=0)
    torch.testing.assert_close(got[5:8], x[5:8] @ w[2], rtol=0, atol=0)


def test_ragged_dot_wrapper_runs_the_plain_version_on_the_cpu():
    x = torch.randn(12, 16).bfloat16()
    w = torch.randn(3, 16, 8).bfloat16()
    offs = _offsets([4, 0, 8])
    before = LAUNCHES["ragged_dot"]
    assert torch.equal(ragged_dot(x, w, offs), ragged_dot_ref(x, w, offs))
    assert LAUNCHES["ragged_dot"] == before        # nothing launched
    with pytest.raises(ValueError, match="disagree"):
        ragged_dot(x, w, _offsets([4, 8]))
    with pytest.raises(ValueError, match="disagree"):
        ragged_dot(x, torch.randn(3, 15, 8).bfloat16(), offs)
    # bf16 x takes fp32 weights (rounded as they are read); fp32 x with
    # bf16 weights is a mixed pair it refuses.
    assert torch.equal(ragged_dot(x, w.float(), offs),
                       ragged_dot(x, w, offs))
    with pytest.raises(TypeError):
        ragged_dot(x.float(), w, offs)
    with pytest.raises(TypeError):
        ragged_dot(x, w, offs.float())


# fp32 weights with bf16 x: the plain version rounds them to bf16 first, as
# the kernel does on load and the reference's ``astype`` before its call.
# (M, K, N, group sizes): empty groups, a group across the 256-row tile
# edge (300 rows), groups of one row.
FP32_WEIGHT_CASES = [
    (300, 64, 96, [0, 300, 0]),
    (520, 72, 40, [100, 0, 300, 120]),
    (9, 16, 24, [1, 0, 1, 1, 0, 6]),
    (64, 128, 256, [64]),
]


@pytest.mark.parametrize("case", FP32_WEIGHT_CASES, ids=str)
def test_plain_ragged_dot_rounds_fp32_weights_like_a_cast(case):
    m, k, n, sizes = case
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5) \
        .astype(np.float32)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w)
    got = ragged_dot_ref(xt, wt, _offsets(sizes))
    assert torch.equal(got, ragged_dot_ref(xt, wt.bfloat16(),
                                           _offsets(sizes)))
    assert torch.equal(got, ragged_dot(xt, wt, _offsets(sizes)))
    want = jax.lax.ragged_dot(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w).astype(jnp.bfloat16),
                              jnp.asarray(sizes, jnp.int32))
    assert within_one_ulp(got.float().numpy(), want).all()


@pytest.mark.parametrize("offs", [[3, 5, 5, 9], [0, 4, 2, 7], [-2, 4, 6, 20]],
                         ids=str)
def test_plain_ragged_dot_fp32_weights_rows_outside_the_groups(offs):
    """Rows outside the clamped groups are zero with fp32 weights too, and
    the rest equals the call on the weights cast first."""
    x = torch.randn(10, 8, generator=torch.Generator().manual_seed(0)) \
        .bfloat16()
    w = torch.randn(3, 8, 4, generator=torch.Generator().manual_seed(1))
    o = torch.tensor(offs, dtype=torch.int32)
    got = ragged_dot_ref(x, w, o)
    assert torch.equal(got, ragged_dot_ref(x, w.bfloat16(), o))
    lo, hi = min(max(offs[0], 0), 10), min(max(max(offs), 0), 10)
    assert not got[:lo].any() and not got[hi:].any()


@pytest.mark.parametrize("pair", [
    (torch.float32, torch.bfloat16), (torch.float16, torch.float32),
    (torch.bfloat16, torch.float16), (torch.float32, torch.float16),
    (torch.float16, torch.bfloat16)], ids=str)
def test_ragged_dot_refuses_other_mixed_pairs(pair):
    x = torch.randn(6, 8).to(pair[0])
    w = torch.randn(2, 8, 4).to(pair[1])
    with pytest.raises(TypeError, match="float32 with bfloat16 x"):
        ragged_dot(x, w, _offsets([2, 4]))


def test_ragged_dot_route_names_are_checked():
    x, w = torch.randn(6, 8).bfloat16(), torch.randn(2, 8, 4)
    with pytest.raises(ValueError, match="route"):
        ragged_dot(x, w, _offsets([2, 4]), route="tma")
    # On the CPU a named bf16 route still runs the plain version.
    assert torch.equal(ragged_dot(x, w, _offsets([2, 4]), route="mma"),
                       ragged_dot_ref(x, w, _offsets([2, 4])))


# (K, N, weights' type, x at an offset of 2 elements, groups) -> whether a
# CUDA call would take the TMA + wgmma kernel: K a multiple of 8, N of 4
# (fp32) or 8 (bf16), x and w on 16 bytes, at most 1024 groups.
TC_ROUTE_CASES = [
    ((64, 96, torch.float32, False, 4), True),
    ((64, 100, torch.float32, False, 4), True),
    ((64, 100, torch.bfloat16, False, 4), False),
    ((70, 96, torch.float32, False, 4), False),
    ((64, 98, torch.float32, False, 4), False),
    ((64, 96, torch.float32, True, 4), False),
    ((64, 96, torch.bfloat16, False, 1025), False),
    ((4096, 14336, torch.float32, False, 8), True),
]


@pytest.mark.parametrize("case,want", TC_ROUTE_CASES, ids=str)
def test_ragged_dot_tma_route_takes_the_aligned_shapes(case, want):
    k, n, w_dtype, offset, groups = case
    x = torch.zeros(4 * k + 8, dtype=torch.bfloat16)
    x = (x[2:2 + 4 * k] if offset else x[:4 * k]).view(4, k)
    # The rule reads shapes, element sizes and addresses: a view of 16
    # elements stands in for the stack.
    w = torch.zeros(16, dtype=w_dtype).as_strided((groups, k, n), (0, 0, 0))
    assert rd_ops.tc_route(x, w) is want


# -------------------------------------------------------------- MoE FFN
def _moe_pair(d, n_experts, d_ff, n_shared, seed=0):
    """The reference's moe_init params and the port's `MoE` holding
    them."""
    p = RMoE.moe_init(jax.random.PRNGKey(seed), d, n_experts=n_experts,
                      moe_d_ff=d_ff, n_shared=n_shared)
    m = PM.MoE(d, n_experts=n_experts, moe_d_ff=d_ff, n_shared=n_shared,
               device="meta").to_empty(device="cpu")
    pn = jax.tree.map(np.asarray, p)
    state = {"router.w": pn["router"]["w"], "w_gate": pn["w_gate"],
             "w_up": pn["w_up"], "w_down": pn["w_down"]}
    if n_shared:
        state.update({f"shared.{k}.w": v["w"]
                      for k, v in pn["shared"].items()})
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in state.items()})
    return p, m


MOE_CASES = [  # (d, experts, d_ff, shared, top_k, (B, S))
    (64, 8, 96, 0, 2, (2, 24)),      # mixtral's smoke shape
    (64, 16, 48, 2, 6, (3, 40)),     # deepseek-like: top-6 + shared
    (32, 4, 40, 1, 1, (1, 7)),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_routing_matches_reference(case):
    """The top-k experts, the dispatch sort and the group sizes equal the
    reference's exactly (its code path, ``moe.py:53-63``)."""
    d, e, f, sh, top_k, (b, s) = case
    p, m = _moe_pair(d, e, f, sh)
    x = np.random.default_rng(1).standard_normal((b * s, d)) \
        .astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    logits = jnp.einsum("td,de->te", xb.astype(jnp.float32),
                        p["router"]["w"].astype(jnp.float32))
    gate_w, gate_i = jax.lax.top_k(logits, top_k)
    gate_w = jax.nn.softmax(gate_w, axis=-1)
    order = jnp.argsort(gate_i.reshape(-1))
    sorted_tok = jnp.repeat(jnp.arange(b * s), top_k)[order]
    sizes = jnp.bincount(gate_i.reshape(-1), length=e)

    xt = torch.from_numpy(x).bfloat16()
    plog, pw, pi = PM.route(m, xt, top_k)
    porder, ptok, poffs = PM.dispatch(pi, e)
    assert np.array_equal(pi.numpy(), np.asarray(gate_i))
    assert np.array_equal(porder.numpy(), np.asarray(order))
    assert np.array_equal(ptok.numpy(), np.asarray(sorted_tok))
    assert poffs.dtype == torch.int32
    assert np.array_equal(np.diff(poffs.numpy()), np.asarray(sizes))
    np.testing.assert_allclose(pw.numpy(), np.asarray(gate_w), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(plog.numpy(), np.asarray(logits), rtol=1e-5,
                               atol=1e-5)


def test_top_k_breaks_ties_to_the_lower_expert():
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    m = PM.MoE(5, n_experts=5, moe_d_ff=4, device="cpu")
    with torch.no_grad():
        m.router.w.copy_(torch.eye(5))
    _, _, idx = PM.route(m, logits, 3)
    _, want = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.asarray(want).tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_moe_ffn_matches_reference(case, impl):
    d, e, f, sh, top_k, (b, s) = case
    p, m = _moe_pair(d, e, f, sh)
    x = np.random.default_rng(2).standard_normal((b, s, d)) \
        .astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref_fn = RMoE.moe_ffn_capacity if impl == "capacity" else RMoE.moe_ffn
    want, want_aux = strict_jit(
        lambda p, x: ref_fn(p, x, top_k=top_k), p, xb)(p, xb)
    got, aux = m(torch.from_numpy(x).bfloat16(), top_k=top_k, impl=impl)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, d)
    ok = within_one_ulp(got.float().numpy(), want)
    diff = int((got.float().numpy() != np.asarray(want, np.float32)).sum())
    print(f"{case} {impl}: {diff} of {got.numel()} differ")
    assert ok.all()
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_moe_ffn_on_fp32_stacks_equals_the_cast_stacks(case):
    """The FFN passes its fp32 expert stacks uncast: its output is bit
    for bit what it gives with the stacks cast to bf16 first (the
    earlier per-call cast)."""
    d, e, f, sh, top_k, (b, s) = case
    _, m = _moe_pair(d, e, f, sh)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, s, d)).astype(np.float32)).bfloat16()
    got, aux = PM.moe_ffn(m, x, top_k=top_k)
    for name in ("w_gate", "w_up", "w_down"):
        setattr(m, name, torch.nn.Parameter(getattr(m, name).bfloat16()))
    want, want_aux = PM.moe_ffn(m, x, top_k=top_k)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_combine_adds_in_the_sorted_order():
    """The combine rounds after each add in the sorted (expert-ascending)
    order, as the reference's scatter-add does; adding the same rows in
    the top-k's own (gate-descending) order gives other bf16 values."""
    rng = np.random.default_rng(3)
    t, k, d = 64, 6, 32
    gate_i = np.stack([rng.permutation(16)[:k] for _ in range(t)])
    order = np.argsort(gate_i.reshape(-1), kind="stable")
    sorted_tok = np.repeat(np.arange(t), k)[order]
    rows = rng.standard_normal((t * k, d)).astype(np.float32)
    rb = jnp.asarray(rows, jnp.bfloat16)
    want = strict_jit(lambda r, i: jnp.zeros((t, d), r.dtype).at[i].add(r),
                      rb, jnp.asarray(sorted_tok))(rb, jnp.asarray(sorted_tok))
    got = PM.combine(torch.from_numpy(rows).bfloat16(),
                     torch.from_numpy(order), t, k)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    by_slot = torch.from_numpy(rows).bfloat16()[torch.from_numpy(inv)] \
        .view(t, k, d)
    other = torch.zeros((t, d), dtype=torch.bfloat16)
    for j in range(k):
        other = other + by_slot[:, j]
    assert not torch.equal(other, got)


def test_moe_path_reads_nothing_back_to_the_host(monkeypatch):
    """With the grouped product replaced by a device-only stand-in (each
    group's rows picked by comparing row indices with the offsets), the
    dispatch, the combine and the aux loss run with every host read-back
    (``item``, ``tolist``, ``bool``, ``int``) raising."""
    p, m = _moe_pair(64, 16, 48, 2)

    def on_device(x, w, offs):
        rows = torch.arange(x.shape[0])[:, None]
        member = (rows >= offs[:-1]) & (rows < offs[1:])          # (M, G)
        # The weights rounded to x's type first, as `ragged_dot` rounds
        # the fp32 stacks the FFN passes.
        y = torch.einsum("mk,gkn->mgn", x.float(), w.to(x.dtype).float())
        return (y * member[..., None]).sum(1).to(x.dtype)

    x = torch.randn(2, 20, 64).bfloat16()
    want, want_aux = m(x, top_k=6)
    monkeypatch.setattr(rd_ops, "ragged_dot", on_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read-back on the MoE path")

    for name in ("item", "tolist", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got, aux = m(x, top_k=6)
    monkeypatch.undo()
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


# ------------------------------------------------------------------- MLA
MLA_KW = dict(n_heads=4, kv_lora=32, qk_nope_dim=32, qk_rope_dim=16,
              v_dim=32)


def _mla_pair(d=64, seed=3):
    p = RA.mla_init(jax.random.PRNGKey(seed), d, MLA_KW["n_heads"],
                    kv_lora=MLA_KW["kv_lora"],
                    qk_nope_dim=MLA_KW["qk_nope_dim"],
                    qk_rope_dim=MLA_KW["qk_rope_dim"],
                    v_dim=MLA_KW["v_dim"])
    m = A.MLA(d, MLA_KW["n_heads"], kv_lora=MLA_KW["kv_lora"],
              qk_nope_dim=MLA_KW["qk_nope_dim"],
              qk_rope_dim=MLA_KW["qk_rope_dim"], v_dim=MLA_KW["v_dim"],
              device="meta").to_empty(device="cpu")
    m.load_state_dict({f"{k}.w": torch.from_numpy(np.array(v["w"]))
                       for k, v in jax.tree.map(np.asarray, p).items()})
    return p, m


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def test_mla_no_cache_forward_matches_reference():
    p, m = _mla_pair()
    b, s = 2, 16
    x = np.random.default_rng(4).standard_normal((b, s, 64)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    xb = jnp.asarray(x, jnp.bfloat16)
    want, cache = strict_jit(
        lambda p, x, q: RA.mla_attention(p, x, q, **MLA_KW), p, xb,
        jnp.asarray(pos))(p, xb, jnp.asarray(pos))
    got, new_cache = m(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(pos.copy()), **MLA_KW)
    assert cache is None and new_cache is None
    assert got.shape == (b, s, 64)
    assert within_one_ulp(got.float().numpy(), want).all()


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_cached_step_matches_reference(absorbed):
    """A 3-token cached step at position 8 of a 16-slot cache, as the
    reference's test (tests/test_models.py:136) sets it up, against the
    reference's step on the same cache; the cache writes equal."""
    p, m = _mla_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    c_kv = rng.standard_normal((2, 16, 32)).astype(np.float32)
    k_pe = rng.standard_normal((2, 16, 16)).astype(np.float32)
    pos = np.array([[8, 9, 10]] * 2)
    xb = jnp.asarray(x, jnp.bfloat16)

    def ref(p, x, q, c, k):
        return RA.mla_attention(p, x, q, cache={"c_kv": c, "k_pe": k,
                                                "pos": jnp.asarray(8)},
                                absorbed=absorbed, **MLA_KW)

    args = (p, xb, jnp.asarray(pos), jnp.asarray(c_kv, jnp.bfloat16),
            jnp.asarray(k_pe, jnp.bfloat16))
    want, wcache = strict_jit(ref, *args)(*args)
    cache = {"c_kv": torch.from_numpy(c_kv).bfloat16(),
             "k_pe": torch.from_numpy(k_pe).bfloat16(), "pos": 8}
    got, new_cache = m(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(pos), cache=cache,
                       absorbed=absorbed, **MLA_KW)
    assert new_cache["pos"] == 11 == int(wcache["pos"])
    for name in ("c_kv", "k_pe"):
        assert np.array_equal(new_cache[name].float().numpy(),
                              _bits(wcache[name]))
    ok = within_one_ulp(got.float().numpy(), want)
    print(f"absorbed={absorbed}: max |d| "
          f"{np.abs(got.float().numpy() - _bits(want)).max()}")
    assert ok.all()


def test_mla_absorbed_equals_naive():
    """The port's two cached paths against each other at the reference's
    own tolerance (tests/test_models.py:136, one decode token)."""
    _, m = _mla_pair()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 1, 64))
                         .astype(np.float32))
    base = {"c_kv": torch.from_numpy(rng.standard_normal((2, 16, 32))
                                     .astype(np.float32)),
            "k_pe": torch.from_numpy(rng.standard_normal((2, 16, 16))
                                     .astype(np.float32)), "pos": 8}
    pos = torch.tensor([[8], [8]])
    o1, _ = m(x, pos, cache={k: (v.clone() if torch.is_tensor(v) else v)
                             for k, v in base.items()}, absorbed=True,
              **MLA_KW)
    o2, _ = m(x, pos, cache={k: (v.clone() if torch.is_tensor(v) else v)
                             for k, v in base.items()}, absorbed=False,
              **MLA_KW)
    np.testing.assert_allclose(o1.float().numpy(), o2.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_mla_cache_overflow_raises():
    _, m = _mla_pair()
    cache = {"c_kv": torch.zeros(1, 4, 32), "k_pe": torch.zeros(1, 4, 16),
             "pos": 3}
    with pytest.raises(ValueError, match="KV cache holds 4"):
        m(torch.zeros(1, 2, 64), torch.tensor([[3, 4]]), cache=cache,
          **MLA_KW)
