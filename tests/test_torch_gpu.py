"""Tests of the port that need a CUDA GPU: the hand-written kernels
against their plain torch versions, the engine on the card against the
engine on the CPU, the conflict build's CUDA route against the host
build, and the zamba2, mamba2, gemma3, mixtral and deepseek-v2-lite
smoke models on the card against the CPU.  They
skip without a GPU; on the card they run with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports only torch and the port (no JAX), so that it runs
where JAX is not installed.  The counts, the adjacency bits and the
engine state are integers and bools, compared exactly.  Flash attention
is held to the reference's kernel tolerances (2e-6 fp32, 2e-2 bf16);
the SSD scan to the reference's 1e-4 in fp32 and, in bf16, to one bf16
ulp of y (both sides compute in fp32 and round y once).  Each call must
take its dtype's kernel, counted in ``LAUNCHES["flash_attention_bf16"]``
or ``LAUNCHES["flash_attention_fp32"]`` (``ssd_bf16``, ``ssd_fp32``):
both dtypes run on the tensor cores, fp32 in split-TF32 products; flash
takes head dims up to 256 on both.  `ragged_dot` (the MoE FFN's grouped
product) is held to its plain version at one bf16 ulp (1e-4 + 2^-7 |y|:
both sum in fp32 and round once) on both bf16 kernels (TMA + wgmma,
mma.sync), on fp32 weights rounded as they are loaded bit for bit as on
the weights cast first, makes no host sync, and launches 3 times a MoE
layer a forward, on the TMA kernel; its fp32 route (the TF32 tensor
cores, the CUDA cores where TMA cannot take the rows), forward and
backward, to the plain version's float64 sums at 1e-4 + 1e-5 |y|.  `selection_counts` runs on the .b1 tensor
cores and the packed conflict kernel ORs group masks: both are held to
plain versions bit for bit, and launch counts to exactness across
threads.  Training: the SSD backward kernels (`ssd_bwd`: bf16 on the
tensor cores, `csrc/ssd_bwd_tc.cu`; fp32 on the TF32 tensor cores,
`csrc/ssd_bwd.cu`) against autograd through the plain scan (tolerances
at `SSD_BWD_GPU_CASES`), bit for bit from call to call, each dtype on
its own library, behind `ops.ssd`'s autograd; the backward kernels of
`ragged_dot` (`csrc/ragged_dot_bwd.cu`, at the forward's tolerances) and
of flash attention (`csrc/flash_attention_bwd.cu`, 1e-5 max |ref| in
fp32, 1e-2 in bf16) against their plain versions, bit for bit from call
to call, behind the wrappers' autograd; and one train step of the zamba2
smoke model on the card against the CPU.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CGRAConfig, DeviceSBTS,  # noqa: E402
                              build_conflict_graph, make_cnkm, map_dfg,
                              mii, schedule_dfg)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.conflict_matrix import (  # noqa: E402
    conflict_matrix_dense, conflict_matrix_words)
from repro_torch.kernels.conflict_matrix.ref import (  # noqa: E402
    conflict_matrix_packed_plain, conflict_matrix_plain)
from repro_torch.kernels.sbts_step import selection_counts  # noqa: E402
from repro_torch.kernels.sbts_step.ref import (  # noqa: E402
    selection_counts_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _words(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         generator=g).to(device)


@pytest.mark.parametrize("k,n,w", [(1, 128, 4), (13, 256, 8),
                                   (37, 2176, 68), (1024, 512, 16)])
def test_kernel_equals_plain_version(cuda, k, n, w):
    rows, sel = _words((n, w), k, cuda), _words((k, w), n, cuda)
    rows[0] = -1
    sel[0] = -1
    before = LAUNCHES["selection_counts"]
    got = selection_counts(rows, sel)
    torch.cuda.synchronize()
    assert LAUNCHES["selection_counts"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, selection_counts_plain(rows, sel))
    assert int(got[0, 0]) == 32 * w


# The tensor-core kernel's edges: K off its 128-trajectory tile (1, 32,
# 1000) and on it (1024); W of 4, 68 and 264 words (one panel of 32
# words, ragged at 68 and 264); n_pad off the 256-vertex tile, odd for
# 8549 (the stores then go one int32 at a time).
@pytest.mark.parametrize("k", [1, 32, 1000, 1024])
@pytest.mark.parametrize("w,n", [(4, 200), (68, 2176), (264, 8549)])
def test_tensor_core_counts_equal_plain_version(cuda, k, w, n):
    rows, sel = _words((n, w), k + w, cuda), _words((k, w), n + w, cuda)
    rows[0] = -1
    sel[0] = -1
    before = LAUNCHES["selection_counts"]
    got = selection_counts(rows, sel)
    torch.cuda.synchronize()
    assert LAUNCHES["selection_counts"] == before + 1
    assert torch.equal(got, selection_counts_plain(rows, sel))
    assert int(got[0, 0]) == 32 * w
    ones = selection_counts(torch.full_like(rows, -1),
                            torch.full_like(sel, -1))
    assert bool((ones == 32 * w).all())


@pytest.mark.parametrize("case", ["w5", "rows+1", "sel+1"])
def test_tensor_core_counts_plain_loads(cuda, case):
    """W % 4 != 0, or an operand off 16-byte alignment: the kernel fills
    its ring with plain loads instead of cp.async."""
    w = 5 if case == "w5" else 8
    rows, sel = _words((300, w), 7, cuda), _words((70, w), 8, cuda)
    if case != "w5":
        which = rows if case == "rows+1" else sel
        moved = torch.empty(which.numel() + 1, dtype=torch.int32,
                            device=cuda)[1:].view(which.shape)
        moved.copy_(which)
        assert moved.data_ptr() % 16 != 0
        rows, sel = (moved, sel) if case == "rows+1" else (rows, moved)
    got = selection_counts(rows, sel)
    torch.cuda.synchronize()
    assert torch.equal(got, selection_counts_plain(rows, sel))


def test_mma_probe_measures_four_rates(cuda):
    """The probe behind the .b1 choice runs and gives a positive rate for
    each of its instructions: the four that could carry selection_counts
    and the two TF32 forms."""
    from repro_torch.kernels.sbts_step.probe import PROBES, mma_rates
    rates = mma_rates(iters=50)
    assert set(rates) == {name for name, _, _ in PROBES.values()}
    assert all(r > 0 for r in rates.values())


def test_launch_counts_are_exact_from_threads(cuda):
    """Kernels launched from several threads: every launch counted."""
    import threading
    rows, sel = _words((512, 16), 1, cuda), _words((64, 16), 2, cuda)
    n_threads, per = 6, 40
    before = LAUNCHES["selection_counts"]
    start = threading.Barrier(n_threads, timeout=60)

    def work() -> None:
        start.wait()
        for _ in range(per):
            selection_counts(rows, sel)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert LAUNCHES["selection_counts"] - before == n_threads * per


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        selection_counts(_words((128, 4), 0, "cpu"),
                         _words((3, 4), 1, cuda))


def _graph():
    dfg, cgra = make_cnkm(2, 6), CGRAConfig()
    ii = mii(dfg, cgra)
    sched = schedule_dfg(dfg, cgra, mode="bandmap", ii=ii, max_ii=ii,
                         jitter=0, seed=0)
    return build_conflict_graph(sched, cgra).bits


def test_engine_on_the_card_equals_the_cpu(cuda):
    g = _graph()
    engines = [DeviceSBTS(g, k=8, seed=4, device=d) for d in (cuda, "cpu")]
    for eng in engines:
        eng.run(40)
    for a, b in zip(*(eng.state for eng in engines)):
        assert torch.equal(a.cpu(), b)


def test_map_dfg_defaults_run_on_the_card(cuda):
    before = LAUNCHES["selection_counts"]
    r = map_dfg(make_cnkm(5, 5), CGRAConfig(), mode="bandmap",
                device_seeds=64)
    assert r.ok and (r.ii, r.n_routing_pes) == (3, 0)
    assert LAUNCHES["selection_counts"] > before


def _features(n, seed, device):
    """``int32 [n, 8]`` with every field in a small range, so that many
    pairs share a kind, op, slot, port or PE."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-1, 0, 0, -1, -1, -1, -1, 0])
    hi = torch.tensor([4, 8, 3, 3, 3, 3, 2, 3])
    u = torch.rand((n, 8), generator=g)
    return (lo + (u * (hi - lo)).long()).to(torch.int32).to(device)


@pytest.mark.parametrize("n", [1, 33, 64, 100, 1000, 2049])
def test_conflict_kernels_equal_plain_versions(cuda, n):
    feat = _features(n, n, cuda)
    before = (LAUNCHES["conflict_matrix"],
              LAUNCHES["conflict_matrix_packed"])
    dense, words = conflict_matrix_dense(feat), conflict_matrix_words(feat)
    torch.cuda.synchronize()
    assert (LAUNCHES["conflict_matrix"],
            LAUNCHES["conflict_matrix_packed"]) == (before[0] + 1,
                                                    before[1] + 1)
    assert dense.device.type == "cuda" and dense.dtype == torch.int8
    assert dense.shape == (n, n)
    assert torch.equal(dense, conflict_matrix_plain(feat))
    assert torch.equal(words, conflict_matrix_packed_plain(feat))


@pytest.mark.parametrize("kind", ["random", "one-op", "wide"])
@pytest.mark.parametrize("n", [1, 31, 32, 65, 777, 4097])
def test_packed_group_kernels_equal_plain_versions(cuda, kind, n):
    """The packed kernels (the OR of two group masks) byte-equal to the
    pair predicate and to their own plain version: on random fields
    (kinds -1 and 3 lie outside TIN/TOUT/QUAD), with every vertex in one
    op, and with op ids and slots across the int32 range (sorted ids)."""
    from repro_torch.kernels.conflict_matrix.ref import (
        conflict_matrix_packed_groups, radix_plan)
    feat = _features(n, n, cuda)
    if kind == "one-op":
        feat[:, 1] = 5
    elif kind == "wide":
        g = torch.Generator().manual_seed(n)
        pick = torch.tensor([-2**31, -7, 0, 2**31 - 1], dtype=torch.int32)
        feat[:, 1] = pick[torch.randint(0, 4, (n,), generator=g)].to(cuda)
        feat[:, 2] = pick[torch.randint(0, 4, (n,), generator=g)].to(cuda)
    if kind == "wide" and n > 4:
        assert radix_plan(feat) is None
    before = LAUNCHES["conflict_matrix_packed"]
    words = conflict_matrix_words(feat)
    torch.cuda.synchronize()
    assert LAUNCHES["conflict_matrix_packed"] == before + 1
    assert torch.equal(words, conflict_matrix_packed_plain(feat))
    assert torch.equal(words, conflict_matrix_packed_groups(feat))
    if kind == "one-op":
        assert int(conflict_matrix_dense(feat).sum()) == n * (n - 1)


def _dense_features(n, kind, cuda):
    """`_features`, or: every vertex in one op; every vertex placed
    (kinds 0-2) with a slot across the int32 range, so every tile takes
    the dense kernel's general loop; slots, ports and PEs at the ends of
    its fold's signed widths, so every tile folds; one vertex with a
    slot past them, so its row tile and strip go general and the other
    tiles fold."""
    from repro_torch.kernels.conflict_matrix import ref
    feat = _features(n, n, "cpu")
    g = torch.Generator().manual_seed(n + 1)

    def pick(values):
        values = torch.tensor(values, dtype=torch.int32)
        return values[torch.randint(0, len(values), (n,), generator=g)]

    if kind == "one-op":
        feat[:, 1] = 5
    elif kind == "wide":
        feat[:, 0] = pick([0, 1, 2])
        feat[:, 2] = pick([-2**31, 2**31 - 1, 1 << 13])
    elif kind == "fold-edge":
        for col, bits in ((2, ref.M_BITS), (3, ref.PORT_BITS),
                          (4, ref.PE_BITS), (5, ref.PE_BITS)):
            feat[:, col] = pick([-(1 << (bits - 1)), -1, 0,
                                 (1 << (bits - 1)) - 1])
    elif kind == "mixed":
        feat[n // 2, 0], feat[n // 2, 2] = 2, 1 << (ref.M_BITS - 1)
    return feat.to(cuda)


def _check_dense(feat):
    """The dense kernel once: one launch (none for n = 0), byte-equal to
    the plain version and the fold's plain version, zero past column n
    up to its pitch."""
    from repro_torch.kernels.conflict_matrix.ref import (
        conflict_matrix_folded)
    n = feat.shape[0]
    before = LAUNCHES["conflict_matrix"]
    dense = conflict_matrix_dense(feat)
    torch.cuda.synchronize()
    assert LAUNCHES["conflict_matrix"] == before + (1 if n else 0)
    assert dense.device.type == "cuda" and dense.dtype == torch.int8
    assert dense.shape == (n, n)
    assert torch.equal(dense, conflict_matrix_plain(feat))
    assert torch.equal(dense, conflict_matrix_folded(feat))
    if n:
        pitch = dense.stride(0)
        assert pitch == -(-n // 16) * 16
        full = torch.as_strided(dense, (n, pitch), (pitch, 1))
        assert not bool(full[:, n:].any())
    return dense


@pytest.mark.parametrize("n", [0, 1, 15, 17, 31, 32, 33, 63, 64, 65, 511,
                               512, 513, 1000, 1023, 1024, 1025, 4161])
def test_dense_kernel_at_its_tile_edges(cuda, n):
    """n = 0 and 1, n off 16 (the pitch), and one below, at and one above
    one and two of the kernel's 32-row tiles and 512-column strips."""
    _check_dense(_features(n, n, cuda))


def test_dense_kernel_at_the_16x16_size(cuda):
    _check_dense(_features(16656, 0, cuda))


@pytest.mark.parametrize("kind", ["one-op", "wide", "fold-edge", "mixed"])
@pytest.mark.parametrize("n", [65, 1025, 3000])
def test_dense_kernel_on_the_fold_model_cases(cuda, kind, n):
    """The cases that the reference model of the kernel's tiles
    (`ref.fold_tiles`, whose tile and widths a CPU test holds to the
    CUDA source) sends all to the general loop, all to the folded one,
    or some to each.  Which loop a tile took is the model's prediction:
    the kernel itself is held byte-equal on every case."""
    from repro_torch.kernels.conflict_matrix.ref import STRIP, fold_tiles
    feat = _dense_features(n, kind, cuda)
    tiles = fold_tiles(feat)
    if kind == "wide":
        assert not bool(tiles.any())
    elif kind == "mixed" and n > STRIP:
        assert 0 < int(tiles.sum()) < tiles.numel()
    elif kind in ("one-op", "fold-edge"):
        assert bool(tiles.all())
    dense = _check_dense(feat)
    if kind == "one-op":
        assert int(dense.sum()) == n * (n - 1)


def test_dense_kernel_on_unaligned_features(cuda):
    """Features 4 bytes off 16-byte alignment: the wrapper copies them
    to an aligned buffer for the kernel's 16-byte loads."""
    feat = _features(1000, 3, cuda)
    moved = torch.empty(feat.numel() + 1, dtype=torch.int32,
                        device=cuda)[1:].view(feat.shape)
    moved.copy_(feat)
    assert moved.data_ptr() % 16 != 0
    assert torch.equal(_check_dense(moved), conflict_matrix_dense(feat))


def test_vertex_entry_points_default_to_the_card(cuda):
    from repro_torch.kernels.conflict_matrix import (conflict_matrix,
                                                     conflict_matrix_packed)
    dfg, cgra = make_cnkm(2, 6), CGRAConfig()
    sched = schedule_dfg(dfg, cgra, mode="bandmap")
    cg = build_conflict_graph(sched, cgra)
    before = (LAUNCHES["conflict_matrix"],
              LAUNCHES["conflict_matrix_packed"])
    dense = conflict_matrix(cg.vertices)
    rows = conflict_matrix_packed(cg.vertices)
    assert (LAUNCHES["conflict_matrix"],
            LAUNCHES["conflict_matrix_packed"]) == (before[0] + 1,
                                                    before[1] + 1)
    assert (dense == conflict_matrix(cg.vertices, use_cuda=False)).all()
    assert rows.tobytes() == conflict_matrix_packed(
        cg.vertices, use_cuda=False).tobytes()


def test_packed_cuda_route_equals_host_build(cuda):
    dfg, cgra = make_cnkm(4, 8), CGRAConfig(rows=8, cols=8)
    ii = mii(dfg, cgra)
    sched = schedule_dfg(dfg, cgra, mode="busmap", ii=ii, max_ii=ii + 4,
                         jitter=0, seed=0)
    for bus_pressure in (True, False):
        host = build_conflict_graph(sched, cgra, bus_pressure=bus_pressure)
        got = build_conflict_graph(sched, cgra, bus_pressure=bus_pressure,
                                   use_kernel="packed-cuda", device=cuda)
        assert got.bits.rows.tobytes() == host.bits.rows.tobytes()


def _route_counts(name):
    return tuple(LAUNCHES[k] for k in (name, f"{name}_bf16",
                                       f"{name}_fp32"))


def _moved(name, before, dtype):
    """The counts ``name``'s call must leave: one launch, on ``dtype``'s
    route."""
    bf16 = int(dtype == torch.bfloat16)
    return (before[0] + 1, before[1] + bf16, before[2] + 1 - bf16)


def _flash_case(b, sq, sk, hq, hkv, d, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(device)
            for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 64, None, 0), (1, 256, 256, 4, 4, 32, None, 0),
    (2, 128, 384, 4, 1, 64, None, 256), (1, 256, 256, 8, 2, 64, 100, 0),
    (1, 64, 64, 2, 2, 128, 16, 0), (1, 1, 512, 4, 2, 64, None, 511),
    (1, 100, 70, 2, 1, 48, 0, 3), (1, 4, 8, 2, 1, 16, 5, 100),
    # the tensor-core kernel's edges: Sq and Sk off its 128-row query and
    # 64-key tiles, D 48 and 128, a window, q_offset > 0, GQA 4:1
    (2, 300, 333, 8, 2, 128, None, 0), (1, 200, 260, 8, 2, 48, 70, 60),
    (1, 129, 65, 4, 1, 128, None, 0), (1, 777, 900, 4, 1, 64, 300, 123),
    # D off a multiple of 8: the bf16 kernel's plain loads; D = 5 also
    # the fp32 kernel's (off a multiple of 4)
    (1, 150, 170, 4, 2, 5, None, 0), (1, 200, 260, 8, 2, 44, 70, 60),
    # the fp32 kernel's two-stage ring over many key tiles, and its
    # rows past Sq in the last 128-row tile
    (1, 1000, 1100, 2, 1, 64, None, 100), (1, 257, 257, 2, 2, 64, 70, 0)],
    ids=str)
def test_flash_attention_equals_plain_version(cuda, case, dtype, tol):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    b, sq, sk, hq, hkv, d, window, q_offset = case
    q, k, v = _flash_case(b, sq, sk, hq, hkv, d, dtype, cuda, sum(case[:6]))
    before = _route_counts("flash_attention")
    got = flash_attention(q, k, v, q_offset=q_offset, window=window)
    torch.cuda.synchronize()
    assert _route_counts("flash_attention") == \
        _moved("flash_attention", before, dtype)
    want = flash_attention_ref(q, k, v, q_offset=q_offset, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 192, None, 0), (1, 300, 333, 8, 2, 256, None, 0),
    (1, 200, 260, 4, 1, 256, 70, 60), (1, 129, 65, 4, 4, 192, None, 0),
    (1, 150, 170, 2, 1, 250, None, 0), (1, 65, 33, 2, 1, 192, None, 0),
    (2, 97, 300, 4, 2, 256, None, 203),
    # gemma3's local layers: D = 256, GQA 2:1, window 1024, Sq = Sk past it
    (1, 2048, 2048, 8, 4, 256, 1024, 0)], ids=str)
def test_flash_attention_head_dims_to_256(cuda, case, dtype, tol):
    """D = 192 and 256, the repository's widest heads (and 250, off a
    multiple of 8 and of 4: both kernels' plain loads): three and four
    64-column panels, with the two-stage K/V ring on the bf16 route and
    64-row query, 32-key tiles on the fp32 route (Sq 65, 97 and Sk 33
    off them)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    b, sq, sk, hq, hkv, d, window, q_offset = case
    q, k, v = _flash_case(b, sq, sk, hq, hkv, d, dtype, cuda, sum(case[:6]))
    before = _route_counts("flash_attention")
    got = flash_attention(q, k, v, q_offset=q_offset, window=window)
    torch.cuda.synchronize()
    assert _route_counts("flash_attention") == \
        _moved("flash_attention", before, dtype)
    want = flash_attention_ref(q, k, v, q_offset=q_offset, window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_refuses_heads_past_256(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_case(1, 8, 8, 2, 1, 257, dtype, cuda, 0)
    with pytest.raises(ValueError, match="ROADMAP"):
        flash_attention(q, k, v)


def _ssd_case(b, s, h, p, n, dtype, device, seed, g=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    a_log = torch.randn((h,), generator=gen) * 0.3
    bb = torch.randn((b, s, g, n), generator=gen)
    cc = torch.randn((b, s, g, n), generator=gen)
    return [x.to(dtype).to(device), dt.to(dtype).to(device),
            a_log.to(device), bb.to(dtype).to(device),
            cc.to(dtype).to(device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 64, 4, 16, 32, 16), (1, 128, 8, 32, 64, 32),
    (2, 128, 4, 64, 128, 64), (2, 1000, 4, 64, 64, 256),
    (1, 5, 4, 16, 16, 8), (1, 12, 2, 96, 16, 64),
    # the tensor-core stages' edges: one chunk, S < chunk, P = 96 (two
    # column tiles, the second ragged), N off 64, a ragged last chunk
    (1, 256, 4, 64, 64, 256), (2, 100, 4, 64, 64, 256),
    (1, 1000, 3, 96, 64, 256), (2, 700, 3, 40, 24, 128),
    # P or N off a multiple of 8: the bf16 stages' plain loads; off a
    # multiple of 4 (P = 18, N = 10): the fp32 stages' too
    (1, 300, 3, 20, 64, 128), (2, 300, 3, 64, 12, 128),
    (1, 200, 3, 18, 10, 64),
    # N = 100: the fp32 stages' 128-column N tiles, two chunks of 1024
    (1, 2000, 2, 64, 100, 1024),
    # mamba2's N = 128 at chunk 256, the last chunk ragged
    (1, 1000, 4, 64, 128, 256), (2, 300, 3, 64, 128, 256)], ids=str)
def test_ssd_equals_plain_version(cuda, case, dtype):
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked
    b, s, h, p, n, chunk = case
    args = _ssd_case(b, s, h, p, n, dtype, cuda, sum(case))
    before = _route_counts("ssd")
    y, fin = ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert _route_counts("ssd") == _moved("ssd", before, dtype)
    wy, wf = ssd_chunked(*args, chunk=chunk)
    assert y.dtype == dtype and fin.dtype == torch.float32
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert ((y.float() - wy.float()).abs()
            <= 1e-4 + rtol * wy.float().abs()).all()
    torch.testing.assert_close(fin, wf, atol=1e-4, rtol=1e-5)


def _at_offset(t):
    """A contiguous copy of ``t`` that starts 2 elements into its
    storage, so its address is off 16-byte alignment."""
    out = torch.empty(t.numel() + 2, dtype=t.dtype,
                      device=t.device)[2:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_attention_at_an_unaligned_address(cuda, which, dtype, tol):
    """An input 2 elements off 16-byte alignment takes its kernel's plain
    loads and still meets the dtype's tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    qkv = _flash_case(2, 200, 260, 4, 2, 64, dtype, cuda, 11)
    qkv[which] = _at_offset(qkv[which])
    assert qkv[which].data_ptr() % 16 != 0
    before = _route_counts("flash_attention")
    got = flash_attention(*qkv, q_offset=60)
    torch.cuda.synchronize()
    assert _route_counts("flash_attention") == \
        _moved("flash_attention", before, dtype)
    want = flash_attention_ref(*qkv, q_offset=60)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1, 3, 4])
def test_ssd_at_an_unaligned_address(cuda, which, dtype):
    """An input (x, dt, B or C) 2 elements off 16-byte alignment takes
    its stages' plain loads and still meets the dtype's tolerances."""
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked
    args = _ssd_case(2, 300, 3, 64, 64, dtype, cuda, 5)
    args[which] = _at_offset(args[which])
    before = _route_counts("ssd")
    y, fin = ssd(*args, chunk=128)
    torch.cuda.synchronize()
    assert _route_counts("ssd") == _moved("ssd", before, dtype)
    wy, wf = ssd_chunked(*args, chunk=128)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert ((y.float() - wy.float()).abs()
            <= 1e-4 + rtol * wy.float().abs()).all()
    torch.testing.assert_close(fin, wf, atol=1e-4, rtol=1e-5)


def test_ssd_kernel_takes_one_group(cuda):
    from repro_torch.kernels.ssd import ssd
    with pytest.raises(ValueError, match="one group"):
        ssd(*_ssd_case(1, 16, 4, 8, 16, torch.float32, cuda, 0, g=2))


def test_zamba2_smoke_model_on_the_card_equals_the_cpu(cuda):
    """The smoke model's no-cache forward (both kernels: S = 4160 takes
    the flash path) and a served wave on the card, against the same
    weights on the CPU.  bf16 rounds apart over 4160 positions, so the
    argmax must agree wherever the CPU's top-2 margin exceeds twice the
    reference's 0.15; at S = 32 the logits agree within 0.15."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("zamba2-1.2b")
    on_card = M.init_params(cfg, 0, device=cuda)
    on_cpu = M.init_params(cfg, 0, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (1, 4160),
                         generator=torch.Generator().manual_seed(0))
    before = dict(LAUNCHES)
    got, _, _ = T.forward(cfg, on_card, {"tokens": toks})
    torch.cuda.synchronize()
    # bf16 compute: every launch takes the bf16 kernels
    for name in ("flash_attention", "flash_attention_bf16"):
        assert LAUNCHES[name] - before[name] == \
            T.n_hybrid_attn_invocations(cfg)
    for name in ("ssd", "ssd_bf16"):
        assert LAUNCHES[name] - before[name] == cfg.n_layers
    want, _, _ = T.forward(cfg, on_cpu, {"tokens": toks})
    assert torch.isfinite(got).all()
    top2 = want[0].topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 0.3
    assert (got[0].cpu().argmax(-1) == want[0].argmax(-1))[sure].all()
    short, _, _ = T.forward(cfg, on_card, {"tokens": toks[:, :32]})
    want, _, _ = T.forward(cfg, on_cpu, {"tokens": toks[:, :32]})
    assert (short.cpu() - want).abs().max() <= 0.15
    prompts = toks[0, :64].reshape(4, 16).numpy()
    out = WaveServer(cfg, on_card, slots=4, s_max=32).run_wave(prompts, 8)
    assert out.shape == (4, 8)


@pytest.mark.parametrize("arch,kernel,calls", [
    ("mamba2-2.7b", "ssd", 2), ("gemma3-4b", "flash_attention", 4)])
def test_family_smoke_models_on_the_card_equal_the_cpu(cuda, arch, kernel,
                                                       calls):
    """mamba2's and gemma3's smoke models: the no-cache forward at
    S = 4160 on the card (the SSD scan in each Mamba2 layer; flash in each
    of gemma3's layers, with window 8 and plain causal in turn) against
    the same weights on the CPU, and a served wave.  Both have tied
    embeddings, whose logits reach tens: one bf16 ulp of the final hidden
    state moves a logit by about 0.1, so the argmax must agree wherever
    the CPU's top-2 margin exceeds 0.3, at S = 4160 and S = 32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_smoke_config(arch)
    on_card = M.init_params(cfg, 0, device=cuda)
    on_cpu = M.init_params(cfg, 0, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (1, 4160),
                         generator=torch.Generator().manual_seed(0))
    for s in (4160, 32):
        before = dict(LAUNCHES)
        got, _, _ = T.forward(cfg, on_card, {"tokens": toks[:, :s]})
        torch.cuda.synchronize()
        moved = {k: LAUNCHES[k] - before[k] for k in
                 ("ssd", "ssd_bf16", "flash_attention",
                  "flash_attention_bf16")}
        want_calls = calls if s == 4160 or kernel == "ssd" else 0
        assert moved[kernel] == moved[f"{kernel}_bf16"] == want_calls
        assert sum(moved.values()) == 2 * want_calls
        want, _, _ = T.forward(cfg, on_cpu, {"tokens": toks[:, :s]})
        assert torch.isfinite(got).all()
        top2 = want[0].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 0.3
        assert sure.any()
        assert (got[0].cpu().argmax(-1) == want[0].argmax(-1))[sure].all()
    prompts = toks[0, :64].reshape(4, 16).numpy()
    out = WaveServer(cfg, on_card, slots=4, s_max=32).run_wave(prompts, 8)
    assert out.shape == (4, 8)


# ------------------------------------------------------------ ragged_dot
def _ragged(m, k, n, sizes, device, seed=0):
    """bf16 x, fp32 weights (the stacks as the model stores them) and
    the int32 offsets of ``sizes``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    w = torch.randn((len(sizes), k, n), generator=g) * k ** -0.5
    offs = torch.tensor([0] + list(torch.tensor(sizes).cumsum(0)),
                        dtype=torch.int32)
    return x.to(device), w.to(device), offs.to(device)


def _ragged_ok(got, want, ulps: int = 1) -> bool:
    d = (got.float() - want.float()).abs()
    return bool((d <= 1e-4 + ulps * 2.0 ** -7 * want.float().abs()).all())


def _tma_aligned(k, n, w_dtype) -> bool:
    """The shapes the TMA + wgmma kernel takes (from 16-byte bases)."""
    return k % 8 == 0 and n % (4 if w_dtype == torch.float32 else 8) == 0


def _launched(before, route):
    return (LAUNCHES["ragged_dot"] - before["ragged_dot"],
            LAUNCHES[f"ragged_dot_{route}"] - before[f"ragged_dot_{route}"])


@pytest.mark.parametrize("case", [
    (8, 64, 96, [3, 0, 5, 0]), (300, 72, 200, [0, 100, 0, 150, 50]),
    (257, 64, 96, [257]), (129, 64, 128, [0, 0, 129, 0]),
    (300, 70, 198, [0, 100, 0, 150, 40]), (200, 64, 100, [50] * 4),
    (1000, 256, 384, [100, 0, 300, 250, 0, 350]),
    (24, 2048, 1408, [1] * 24 + [0] * 40),
    (600, 4104, 520, [0, 300, 300]), (40, 256, 4360, [10, 0, 30]),
    (520, 128, 4104, [300, 0, 220])], ids=str)
def test_ragged_dot_equals_plain_version(cuda, case):
    """Empty groups, one group holding every row, M off the row tiles,
    groups across a tile edge, K or N off a multiple of 8 (the mma.sync
    kernel), deepseek's decode shape, K or N past 4096; bf16 x with
    fp32 weights (rounded on load) and with the same weights cast to
    bf16 first, one launch a call on its route; then the fp32 route."""
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref
    m, k, n, _ = case
    x, w, offs = _ragged(*case, cuda)
    for weights in (w, w.bfloat16()):
        route = "wgmma" if _tma_aligned(k, n, weights.dtype) else "mma"
        before = dict(LAUNCHES)
        got = ragged_dot(x, weights, offs)
        torch.cuda.synchronize()
        assert _launched(before, route) == (1, 1)
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert _ragged_ok(got, ragged_dot_ref(x, w, offs))
    # The fp32 route (the fp32 compute mode's): the plain version's sums
    # (in float64: the kernels sum in another order than its fp32 ones)
    # within 1e-4 + 1e-5 |y|.
    x = x.float()
    before = dict(LAUNCHES)
    got = ragged_dot(x, w, offs)
    torch.cuda.synchronize()
    assert _launched(before, "fp32") == (1, 1)
    want = ragged_dot_ref(x, w, offs, acc=torch.float64)
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-4 + 1e-5 * want.abs()).all())


@pytest.mark.parametrize("route", ["wgmma", "mma"])
@pytest.mark.parametrize("case", [
    (300, 72, 200, [0, 100, 0, 150, 50]), (8, 4096, 1024, [2, 0, 6]),
    (1000, 256, 384, [100, 0, 300, 250, 0, 350])], ids=str)
def test_ragged_dot_fp32_weights_equal_the_cast_weights(cuda, case, route):
    """Each bf16 kernel on fp32 weights, rounded as it loads them, gives
    the bits it gives on the weights cast to bf16 first; either kernel
    is within one bf16 ulp of the plain version."""
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref
    x, w, offs = _ragged(*case, cuda, seed=1)
    before = dict(LAUNCHES)
    got = ragged_dot(x, w, offs, route=route)
    cast = ragged_dot(x, w.bfloat16(), offs, route=route)
    torch.cuda.synchronize()
    assert _launched(before, route) == (2, 2)
    assert torch.equal(got, cast)
    assert _ragged_ok(got, ragged_dot_ref(x, w, offs))


def test_ragged_dot_unaligned_shapes_take_the_mma_kernel(cuda):
    """K off a multiple of 8, N off 4 (fp32) or 8 (bf16 weights) and x
    off 16 bytes take the mma.sync kernel, counted as its route; naming
    the TMA kernel for them raises."""
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref
    x, w, offs = _ragged(300, 64, 100, [100, 100, 100], cuda)
    shifted = torch.empty(x.numel() + 2, dtype=x.dtype,
                          device=cuda)[2:].view(x.shape)
    shifted.copy_(x)
    for xx, ww in ((shifted, w), (x, w.bfloat16()), (x[:, :60].contiguous(),
                                                    w[:, :60].contiguous())):
        before = dict(LAUNCHES)
        got = ragged_dot(xx, ww, offs)
        torch.cuda.synchronize()
        assert _launched(before, "mma") == (1, 1)
        assert _ragged_ok(got, ragged_dot_ref(xx, ww, offs))
        with pytest.raises(ValueError, match="TMA"):
            ragged_dot(xx, ww, offs, route="wgmma")


def test_ragged_dot_edges_of_its_inputs(cuda):
    """x off 16-byte alignment; rows outside the groups are zero on both
    bf16 kernels; fp16, fp32 x with bf16 weights and int64 offsets are
    refused on the card; no host sync."""
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref
    x, w, offs = _ragged(300, 64, 96, [100, 100, 100], cuda)
    shifted = torch.empty(x.numel() + 2, dtype=x.dtype,
                          device=cuda)[2:].view(x.shape)
    shifted.copy_(x)
    assert _ragged_ok(ragged_dot(shifted, w, offs),
                      ragged_dot_ref(x, w, offs))
    inner = torch.tensor([20, 120, 120, 250], dtype=torch.int32,
                         device=cuda)
    for route in ("wgmma", "mma"):
        got = ragged_dot(x, w, inner, route=route)
        assert not got[:20].any() and not got[250:].any()
        assert _ragged_ok(got, ragged_dot_ref(x, w, inner))
    with pytest.raises(TypeError):
        ragged_dot(x.half(), w.half(), offs)
    with pytest.raises(TypeError):
        ragged_dot(x.float(), w.bfloat16(), offs)
    with pytest.raises(TypeError):
        ragged_dot(x, w, offs.long())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ragged_dot(x, w, offs)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _moe_summand_magnitudes(m, x, top_k: int):
    """Per token and channel, the magnitudes of what the ragged MoE FFN
    adds up: sum over its k experts of |w y| plus |the shared MLP's
    output|, computed on the CPU with the plain grouped product."""
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.models import layers as L
    from repro_torch.models import moe as PM
    xf = x.reshape(-1, x.shape[-1])
    _, gate_w, gate_i = PM.route(m, xf, top_k)
    order, sorted_tok, offsets = PM.dispatch(gate_i, m.router.w.shape[-1])
    xd = xf.bfloat16()[sorted_tok]
    h = L.silu(ragged_dot(xd, m.w_gate, offsets)) * \
        ragged_dot(xd, m.w_up, offsets)
    y = ragged_dot(h, m.w_down, offsets).float()
    y = y * gate_w.reshape(-1)[order][:, None]
    mag = PM.combine(y.abs(), order, xf.shape[0], top_k)
    if m.shared is not None:
        mag = mag + m.shared(xf).float().abs()
    return mag.reshape(x.shape)


def test_moe_ffn_on_the_card_makes_no_host_sync(cuda):
    """The ragged MoE FFN (routing, dispatch, three grouped products,
    combine, aux loss) raises under the sync debug mode if any op reads
    back to the host; its routing equals the CPU's and its output is
    within two bf16 ulps of the CPU's, counted on the magnitudes of what
    each output adds up (the k experts' |w y| and the shared MLP's
    |output|), not on the sum: where those cancel, an ulp of one summand
    is many ulps of the sum.  Each grouped product is within one ulp; an
    ulp in the gate or up product is carried through the down product.
    x comes from a seeded generator, so the inputs are the same in every
    run."""
    from repro_torch.models import moe as PM
    m = PM.MoE(64, n_experts=16, moe_d_ff=48, n_shared=2, device=cuda,
               generator=torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn(3, 40, 64, generator=torch.Generator().manual_seed(0)
                    ).bfloat16().to(cuda)
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = m(x, top_k=6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # The fp32 stacks go uncast, each product on the TMA + wgmma kernel.
    assert _launched(before, "wgmma") == (3, 3)
    cpu = PM.MoE(64, n_experts=16, moe_d_ff=48, n_shared=2, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    _, _, gi = PM.route(m, x.reshape(-1, 64), 6)
    _, _, gi_cpu = PM.route(cpu, x.cpu().reshape(-1, 64), 6)
    assert torch.equal(gi.cpu(), gi_cpu)
    want, want_aux = cpu(x.cpu(), top_k=6)
    mag = _moe_summand_magnitudes(cpu, x.cpu(), 6)
    d = (out.cpu().float() - want.float()).abs()
    assert bool((d <= 1e-4 + 2 * 2.0 ** -7 * mag).all())
    assert abs(float(aux) - float(want_aux)) < 1e-5


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_smoke_models_on_the_card_equal_the_cpu(cuda, arch):
    """The moe family's smoke models: the no-cache forward on the card
    (`ragged_dot` 3 times a layer; mixtral's GQA layers take flash with
    window 8 at S = 4160, deepseek's MLA never) against the same weights
    on the CPU, both dispatches, and a served wave.  The argmax agrees
    on at least 99% of the rows where the CPU's top-2 margin exceeds
    0.3: the card's sums round the router's inputs otherwise than the
    CPU's, and a token whose top-k sits on a near tie takes another
    expert there, which can move its logits past any margin."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_smoke_config(arch)
    on_card = M.init_params(cfg, 0, device=cuda)
    on_cpu = M.init_params(cfg, 0, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (1, 4160),
                         generator=torch.Generator().manual_seed(0))
    flash = cfg.n_layers if cfg.attn_kind == "gqa" else 0
    for s, impl in ((4160, "ragged"), (32, "ragged"), (32, "capacity")):
        c = dataclasses.replace(cfg, moe_impl=impl)
        before = dict(LAUNCHES)
        got, aux, _ = T.forward(c, on_card, {"tokens": toks[:, :s]})
        torch.cuda.synchronize()
        assert LAUNCHES["ragged_dot"] - before["ragged_dot"] == \
            (3 * cfg.n_layers if impl == "ragged" else 0)
        assert LAUNCHES["flash_attention_bf16"] - \
            before["flash_attention_bf16"] == (flash if s == 4160 else 0)
        want, want_aux, _ = T.forward(c, on_cpu, {"tokens": toks[:, :s]})
        assert torch.isfinite(got).all() and float(aux) > 0
        top2 = want[0].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 0.3
        assert sure.any()
        agree = got[0].cpu().argmax(-1) == want[0].argmax(-1)
        assert agree[sure].float().mean() >= 0.99
    prompts = toks[0, :64].reshape(4, 16).numpy()
    out = WaveServer(cfg, on_card, slots=4, s_max=32).run_wave(prompts, 8)
    assert out.shape == (4, 8)


# ------------------------------------------------------ the service tier
def test_race_on_the_card(cuda):
    """The forced-loser race (only the prover can be sound): the exact
    side wins, the device portfolio launched and was cancelled within
    a chunk, and neither side raised."""
    from repro_torch.obs import Tracer
    chunk = DeviceSBTS.__init__.__kwdefaults__["chunk"]
    tr = Tracer()
    before = LAUNCHES["selection_counts"]
    r = map_dfg(make_cnkm(5, 5), CGRAConfig(), mode="busmap", max_ii=2,
                backend="race", certify=False, seed=7, device_seeds=64,
                device=cuda, tracer=tr)
    assert LAUNCHES["selection_counts"] > before
    assert r.backend == "race:exact" and r.proved_infeasible
    (race,) = [s.attrs for s in tr.finished if s.name == "race"]
    assert race["winner"] == "exact"
    assert race["loser_iters_after_cancel"] <= chunk
    sides = [s.attrs for s in tr.finished if s.name == "race-side"]
    assert len(sides) == 2 and all("ok" in a for a in sides)


def test_co_map_on_the_card(cuda):
    """A pair whose regions reach the portfolio: the merged binding is
    valid and the device engine launched."""
    from repro_torch.comap import co_map
    from repro_torch.core import serve_catalog
    from repro_torch.core.validate import validate_mapping
    catalog = {s.name: s for s in serve_catalog("8x8")}
    cgra = CGRAConfig(rows=8, cols=8)
    before = LAUNCHES["selection_counts"]
    cm = co_map([catalog["loop2x0"].build(), catalog["reduce6a3"].build()],
                cgra, max_ii=8, device=cuda)
    assert LAUNCHES["selection_counts"] > before
    assert cm.ok, cm.summary()
    assert validate_mapping(cm.sched, cgra, cm.placement).ok


def test_serve_trace_on_the_card(cuda):
    """A 4x4 request trace through the service on the card (16 requests,
    seed 1: one computed request reaches the portfolio): no crash, every
    ok result valid, and the device engine launched."""
    from repro_torch.core import make_request_trace
    from repro_torch.core.validate import validate_mapping
    from repro_torch.serve import MappingService, MapRequest
    svc = MappingService(max_workers=2, device=cuda)
    cgra = CGRAConfig()
    before = LAUNCHES["selection_counts"]
    reqs = [MapRequest(dfg=t.dfg, cgra=cgra, deadline=t.deadline,
                       req_id=f"r{i}")
            for i, t in enumerate(make_request_trace(16, scale="4x4",
                                                     seed=1))]
    outs = svc.map_batch(reqs)
    assert LAUNCHES["selection_counts"] > before
    assert not [o.req_id for o in outs if o.source == "crash"]
    assert not [e for e in svc.flight.dump() if e["kind"] == "serve-crash"]
    for o in outs:
        if o.ok:
            assert validate_mapping(o.result.sched, cgra,
                                    o.result.placement).ok
    assert sum(o.ok for o in outs) == len(outs)


def test_service_with_no_device_maps_on_the_card(cuda):
    """``device=None`` is the card: the service's scheduler holds a CUDA
    device and its maps launch the kernel."""
    from repro_torch.serve import MappingService
    svc = MappingService(max_workers=1)
    assert svc.scheduler.device.type == "cuda"
    before = LAUNCHES["selection_counts"]
    out = svc.map(make_cnkm(5, 5), CGRAConfig(), mode="bandmap")
    assert out.ok and out.source == "computed"
    assert LAUNCHES["selection_counts"] > before


# ------------------------------------------------------------- training
# The SSD backward kernels (bf16: csrc/ssd_bwd_tc.cu, fp32:
# csrc/ssd_bwd.cu) against autograd through the plain scan on fp32
# copies of the same inputs (`ref.ssd_chunked_bwd`, which rounds nothing
# but its result): fp32 within 1e-5 max |ref|, bf16
# within half a bf16 ulp of each value (the kernel rounds once) + 1e-5
# max |ref|, d_a_log within 1e-3 max |ref| (a sum over every step of
# terms that cancel: chip_smoke.py's `SSD_BWD_DA_TOL`).
SSD_BWD_GPU_CASES = [(2, 2048, 64, 64, 64, 256), (2, 2048, 80, 64, 128, 256),
                     (1, 1000, 4, 64, 64, 256), (2, 300, 3, 40, 24, 128),
                     (1, 200, 3, 18, 10, 64), (1, 130, 2, 130, 12, 100),
                     (1, 37, 2, 8, 16, 8), (1, 2100, 2, 64, 64, 1024),
                     # the bf16 route's head groups of 8: 8 + 4 heads, and
                     # 8 + 8 + 1 with P = 24, N = 40
                     (1, 300, 12, 64, 64, 128), (2, 130, 17, 24, 40, 32),
                     # S under one chunk (a short training sequence)
                     (2, 100, 4, 64, 64, 256),
                     # mamba2's heads at N = 128: the fp32 training
                     # check's (1, 512), and S off the chunk
                     (1, 512, 80, 64, 128, 256), (1, 300, 80, 64, 128, 128)]


def _hold_bwd(got, want, dtype):
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    for name, g, w in zip(("dx", "ddt", "d_a_log", "db", "dc"), got, want):
        assert g.dtype == (torch.float32 if name == "d_a_log" else dtype)
        err = (g.float() - w).abs()
        if name == "d_a_log":
            assert (err <= 1e-3 * w.abs().max()).all(), name
        else:
            assert (err <= rtol * w.abs() + 1e-5 * w.abs().max()).all(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("case", SSD_BWD_GPU_CASES, ids=str)
def test_ssd_bwd_equals_plain_version(cuda, case, with_final, dtype):
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd
    b, s, h, p, n, chunk = case
    args = _ssd_case(b, s, h, p, n, dtype, cuda, sum(case))
    gen = torch.Generator().manual_seed(len(case))
    dy = torch.randn((b, s, h, p), generator=gen).to(dtype).to(cuda)
    d_final = torch.randn((b, h, p, n), generator=gen).to(cuda) \
        if with_final else None
    before = _route_counts("ssd_bwd")
    got = ops.ssd_bwd(*args, dy, d_final, chunk=chunk)
    torch.cuda.synchronize()
    assert _route_counts("ssd_bwd") == _moved("ssd_bwd", before, dtype)
    want = ssd_chunked_bwd(*(t.float() for t in args), dy.float(), d_final,
                           chunk=chunk)
    _hold_bwd(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_is_deterministic(cuda, dtype):
    from repro_torch.kernels.ssd import ops
    args = _ssd_case(2, 1000, 8, 64, 64, dtype, cuda, 3)
    dy = torch.randn_like(args[0].float()).to(dtype)
    d_final = torch.randn((2, 8, 64, 64), device=cuda)
    first = ops.ssd_bwd(*args, dy, d_final, chunk=256)
    for _ in range(3):
        again = ops.ssd_bwd(*args, dy, d_final, chunk=256)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_takes_its_dtypes_library(cuda, dtype, monkeypatch):
    """A bf16 call builds and launches the bf16 library (``ssd_bwd_tc``)
    and not the fp32 one; an fp32 call the fp32 library (``ssd_bwd``, on
    the TF32 tensor cores): the libraries the call loads, and its route's
    launch count."""
    from repro_torch.kernels.ssd import ops
    loaded = []
    real = ops.load
    monkeypatch.setattr(ops, "load",
                        lambda name: loaded.append(name) or real(name))
    args = _ssd_case(1, 300, 12, 64, 64, dtype, cuda, 9)
    dy = torch.randn_like(args[0].float()).to(dtype)
    before = _route_counts("ssd_bwd")
    ops.ssd_bwd(*args, dy, chunk=128)
    torch.cuda.synchronize()
    assert _route_counts("ssd_bwd") == _moved("ssd_bwd", before, dtype)
    assert loaded == ["ssd_bwd_tc" if dtype == torch.bfloat16 else "ssd_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_autograd_on_the_card_takes_the_backward_kernel(cuda, dtype):
    """`ops.ssd` under autograd on the card: the forward kernels, then
    one `ssd_bwd` launch, with the gradients of the plain version; with
    grad off (serving) no autograd Function is made."""
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd
    args = _ssd_case(1, 300, 4, 64, 64, dtype, cuda, 5)
    leaves = [t.clone().requires_grad_() for t in args]
    y, fin = ops.ssd(*leaves, chunk=128)
    assert y.grad_fn is not None
    dy = torch.randn_like(y.float()).to(dtype)
    before = LAUNCHES["ssd_bwd"]
    grads = torch.autograd.grad(y, leaves, dy)
    assert LAUNCHES["ssd_bwd"] == before + 1
    want = ssd_chunked_bwd(*(t.float() for t in args), dy.float(), None,
                           chunk=128)
    _hold_bwd(grads, want, dtype)
    with torch.no_grad():
        y, _ = ops.ssd(*leaves, chunk=128)
    assert y.grad_fn is None


def test_flash_and_ragged_dot_raise_under_grad(cuda):
    """Under autograd on the card both wrappers no longer raise: each
    call is an autograd Function whose forward launches the forward
    kernel once and whose backward launches the backward kernels once;
    with grad off (serving) no Function is made."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ragged_dot import ragged_dot
    q, k, v = _flash_case(1, 64, 64, 2, 2, 64, torch.bfloat16, cuda, 0)
    x = torch.randn(8, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(2, 64, 32, device=cuda, requires_grad=True)
    offsets = torch.tensor([0, 4, 8], dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    out = flash_attention(q.requires_grad_(), k, v)
    y = ragged_dot(x, w, offsets)
    assert out.grad_fn is not None and y.grad_fn is not None
    (out.float().sum() + y.float().sum()).backward()
    torch.cuda.synchronize()
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert moved["flash_attention"] == moved["flash_attention_bwd"] == 1
    assert moved["ragged_dot"] == moved["ragged_dot_bwd"] == 1
    assert q.grad is not None and w.grad is not None
    with torch.no_grad():                  # serving: no Function
        assert flash_attention(q, k, v).grad_fn is None
        assert ragged_dot(x, w, offsets).grad_fn is None


# ---------------------------------------------- the two backward pairs
# ragged_dot's backward (csrc/ragged_dot_bwd.cu) against the plain
# backward on the same inputs: bf16 within one bf16 ulp (1e-4 + 2^-7
# |ref|: both sum in fp32 and round once), fp32 within 1e-4 + 1e-5 |ref|.
RAGGED_BWD_CASES = [
    (8, 64, 96, [3, 0, 5, 0]), (300, 72, 200, [0, 100, 0, 150, 50]),
    (257, 64, 96, [257]), (129, 64, 128, [0, 0, 129, 0]),
    (300, 70, 198, [0, 100, 0, 150, 40]),   # K, N off 8: plain loads
    (200, 64, 100, [50] * 4), (1000, 256, 384, [100, 0, 300, 250, 0, 350]),
    (600, 2048, 1408, [10] * 60 + [0] * 4),  # deepseek's widths
    # deepseek's widths, group edges inside dw's 64-row boxes
    (1000, 2048, 1408, [100, 37, 250, 13, 150, 0, 443]),
    (520, 128, 4104, [300, 0, 220]), (50, 64, 64, [0, 0, 0])]


def _bwd_kernel_routes(name):
    return tuple(LAUNCHES[f"{name}_{r}"] for r in ("wgmma", "mma"))


def _ragged_bwd_ok(got, want, dtype) -> bool:
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    d = (got.float() - want.float()).abs()
    return bool((d <= 1e-4 + rtol * want.float().abs()).all())


@pytest.mark.parametrize("route", ["bf16-fp32w", "bf16-bf16w", "fp32"])
@pytest.mark.parametrize("case", RAGGED_BWD_CASES, ids=str)
def test_ragged_dot_bwd_equals_plain_version(cuda, case, route):
    """dx and dw against `ragged_dot_bwd_ref` (rows past the groups and
    before them, empty groups, unaligned K and N, one group holding every
    row, groups across tile edges and inside dw's row boxes), one counted
    launch on its route: bf16 on the TMA + wgmma kernels where K and N
    are multiples of 8 (every model path's shape), on the mma.sync ones
    (``ragged_dot_bwd_mma``) elsewhere; and the same bits from a second
    call."""
    from repro_torch.kernels.ragged_dot import ops
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_bwd_ref
    m, k, n, sizes = case
    x, w, offs = _ragged(*case, cuda)
    if route == "bf16-bf16w":
        w = w.bfloat16()
    elif route == "fp32":
        x = x.float()
    offs = offs + 3 if m > 3 + int(offs[-1]) else offs   # rows before
    gen = torch.Generator().manual_seed(m)
    dy = torch.randn((m, n), generator=gen).to(x.dtype).to(cuda)
    before = _route_counts("ragged_dot_bwd")
    kernels = _bwd_kernel_routes("ragged_dot_bwd")
    dx, dw = ops.ragged_dot_bwd(x, w, offs, dy)
    torch.cuda.synchronize()
    assert _route_counts("ragged_dot_bwd") == _moved("ragged_dot_bwd",
                                                     before, x.dtype)
    tma = k % 8 == 0 and n % 8 == 0
    want_kernels = (kernels if route == "fp32" else
                    (kernels[0] + tma, kernels[1] + (not tma)))
    assert _bwd_kernel_routes("ragged_dot_bwd") == want_kernels
    want = ragged_dot_bwd_ref(x, w, offs, dy, acc=torch.float64
                              if route == "fp32" else torch.float32)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert _ragged_bwd_ok(dx, want[0], x.dtype)
    assert _ragged_bwd_ok(dw, want[1], x.dtype)
    again = ops.ragged_dot_bwd(x, w, offs, dy)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


# The fp32 route: forward, dx and dw on the TF32 tensor cores (3xTF32,
# csrc/ragged_tf32.cuh) where TMA takes the rows (K and N multiples of 4
# from 16-byte bases), on the CUDA cores elsewhere, each against the
# plain version's float64 sums at the fp32 tolerance (1e-4 + 1e-5 |ref|),
# bit for bit from call to call.  (M, K, N, group sizes, rows before the
# first group): the edges of chip_smoke.py's `RAGGED_BWD_EDGES` in fp32 (K
# and N off 4, one group holding every row, N past 4096, rows outside the
# groups, empty groups, a 2000-row group), tiles across group edges, and
# deepseek's captured gate/up training shape (24576 rows routed over 64
# experts).
FP32_TC_CASES = [(1000, 256, 384, [100, 0, 300, 250, 0, 300], 20),
                 (300, 70, 198, [0, 100, 0, 150, 40], 3),
                 (300, 72, 202, [100, 100, 100], 0),
                 (257, 64, 96, [257], 0), (520, 128, 4104, [300, 0, 220], 0),
                 (600, 2048, 1408, [10] * 50 + [0] * 14, 37),
                 (4096, 4096, 1024, [1000, 0, 2000, 1096], 0),
                 (37, 36, 44, [5, 20, 3], 4), (50, 64, 64, [0, 0, 0], 0),
                 (24576, 2048, 1408, "deepseek", 0)]


@pytest.mark.parametrize("case", FP32_TC_CASES, ids=str)
def test_ragged_dot_fp32_tensor_cores(cuda, case):
    """fp32 forward, dx and dw against the plain version's float64 sums,
    one launch each on its kernel's route key, the same bits twice."""
    from repro_torch.kernels.ragged_dot import ops
    from repro_torch.kernels.ragged_dot.ref import (ragged_dot_bwd_ref,
                                                    ragged_dot_ref)
    m, k, n, sizes, lead = case
    if sizes == "deepseek":
        gen = torch.Generator().manual_seed(64)
        sizes = torch.multinomial(torch.ones(64), m, replacement=True,
                                  generator=gen).bincount(minlength=64)
        sizes = sizes.tolist()
    _, w, offs = _ragged(m, k, n, sizes, cuda, seed=2)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((m, k), generator=gen).to(cuda)
    dy = torch.randn((m, n), generator=gen).to(cuda)
    offs = offs + lead
    kernel = "fp32_tc" if k % 4 == 0 and n % 4 == 0 else "fp32_cores"
    before = dict(LAUNCHES)
    y = ops.ragged_dot(x, w, offs)
    dx, dw = ops.ragged_dot_bwd(x, w, offs, dy)
    torch.cuda.synchronize()
    for name in ("ragged_dot", "ragged_dot_bwd"):
        for key in (name, f"{name}_fp32", f"{name}_{kernel}"):
            assert LAUNCHES[key] - before[key] == 1, key
    wants = (ragged_dot_ref(x, w, offs, acc=torch.float64),
             *ragged_dot_bwd_ref(x, w, offs, dy, acc=torch.float64))
    for got, want in zip((y, dx, dw), wants):
        assert got.dtype == torch.float32
        assert _ragged_bwd_ok(got, want, torch.float32)
    if lead:
        assert (y[:lead] == 0).all() and (dx[:lead] == 0).all()
    assert torch.equal(y, ops.ragged_dot(x, w, offs))
    again = ops.ragged_dot_bwd(x, w, offs, dy)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


def test_ragged_dot_fp32_unaligned_bases_take_the_cuda_cores(cuda):
    """fp32 inputs 2 elements into their storage, which TMA cannot take,
    go to the CUDA-core kernels."""
    from repro_torch.kernels.ragged_dot import ops
    from repro_torch.kernels.ragged_dot.ref import (ragged_dot_bwd_ref,
                                                    ragged_dot_ref)
    x, w, offs = _ragged(200, 64, 96, [50, 0, 150], cuda)
    x = x.float()

    def shifted(t):
        out = torch.empty(t.numel() + 2, dtype=t.dtype,
                          device=cuda)[2:].view(t.shape)
        return out.copy_(t)
    dy = torch.randn(200, 96, device=cuda)
    before = dict(LAUNCHES)
    y = ops.ragged_dot(shifted(x), w, offs)
    dx, dw = ops.ragged_dot_bwd(x, w, offs, shifted(dy))
    for key in ("ragged_dot_fp32_cores", "ragged_dot_bwd_fp32_cores"):
        assert LAUNCHES[key] - before[key] == 1, key
    assert _ragged_bwd_ok(y, ragged_dot_ref(x, w, offs, acc=torch.float64),
                          torch.float32)
    want = ragged_dot_bwd_ref(x, w, offs, dy, acc=torch.float64)
    assert _ragged_bwd_ok(dx, want[0], torch.float32)
    assert _ragged_bwd_ok(dw, want[1], torch.float32)


def test_ragged_dot_bwd_unaligned_bases(cuda):
    """Inputs 2 elements into their storage, which TMA cannot take, go to
    the mma.sync kernels and their plain loads."""
    from repro_torch.kernels.ragged_dot import ops
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_bwd_ref
    x, w, offs = _ragged(200, 64, 96, [50, 0, 150], cuda)

    def shifted(t):
        out = torch.empty(t.numel() + 2, dtype=t.dtype,
                          device=cuda)[2:].view(t.shape)
        return out.copy_(t)
    dy = torch.randn(200, 96, device=cuda).bfloat16()
    before = _bwd_kernel_routes("ragged_dot_bwd")
    dx, dw = ops.ragged_dot_bwd(shifted(x), shifted(w), offs, shifted(dy))
    assert _bwd_kernel_routes("ragged_dot_bwd") == (before[0],
                                                    before[1] + 1)
    want = ragged_dot_bwd_ref(x, w, offs, dy)
    assert _ragged_bwd_ok(dx, want[0], torch.bfloat16)
    assert _ragged_bwd_ok(dw, want[1], torch.bfloat16)


# Flash attention's backward (csrc/flash_attention_bwd.cu) on the card's
# own forward output and LSE, against the plain backward on fp32 copies
# of the same inputs: each gradient within 1e-5 max |ref| in fp32 (the
# orders of fp32 sums) and 1e-2 max |ref| in bf16 (the bf16 design's
# tolerance, fixed by tests/test_torch_flash_bwd.py's emulation).
FA_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FA_BWD_CASES = [
    (2, 128, 128, 4, 2, 64, None, 0), (1, 256, 256, 4, 4, 32, None, 0),
    (2, 128, 384, 4, 1, 64, None, 256), (1, 256, 256, 8, 2, 64, 100, 0),
    (1, 64, 64, 2, 2, 128, 16, 0), (1, 100, 70, 2, 1, 48, 0, 3),
    (1, 96, 96, 2, 1, 32, None, -40),        # rows that see no key
    (2, 300, 333, 8, 2, 128, None, 0), (1, 200, 260, 8, 2, 48, 70, 60),
    (1, 777, 900, 4, 1, 64, 300, 123), (1, 150, 170, 4, 2, 5, None, 0),
    (1, 200, 260, 8, 2, 44, 70, 60), (1, 300, 300, 8, 4, 256, None, 0),
    (1, 300, 300, 8, 4, 256, 100, 0), (1, 200, 230, 4, 2, 192, 50, 30),
    (1, 129, 129, 2, 1, 200, None, 0), (1, 1, 512, 4, 2, 64, None, 511),
    # the path's widths: gemma3's global layer, mixtral's window
    (1, 1024, 1024, 8, 4, 256, None, 0), (1, 1024, 1024, 32, 8, 128, 512, 0),
    # GQA groups of 9 (starcoder2's 36:4): D = 128 (fp32 on mma.sync), D =
    # 64 (fp32 on wgmma) off the tiles, and starcoder2's heads
    (1, 300, 300, 9, 1, 128, None, 0), (2, 200, 260, 18, 2, 64, None, 60),
    (1, 1024, 1024, 36, 4, 128, None, 0)]


def _flash_bwd_case(case, dtype, device, seed=0):
    from repro_torch.kernels.flash_attention import ops
    b, sq, sk, hq, hkv, d, win, off = case
    q, k, v = _flash_case(b, sq, sk, hq, hkv, d, dtype, device, seed)
    out, lse = ops._forward(q, k, v, off, win, 512, True)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn((b, sq, hq, d), generator=g).to(dtype).to(device)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_BWD_CASES, ids=str)
def test_flash_bwd_equals_plain_version(cuda, case, dtype):
    """dq, dk and dv against `flash_attention_bwd_ref` (GQA, windows,
    q_offset on both sides of 0, D off 8 and 64, D up to 256, the path's
    widths), one counted launch on its route (bf16: the wgmma kernels,
    which take every shape, D off 8 through plain loads), the same bits
    from a second call; and the forward's LSE against the plain
    forward's."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    *_, win, off = case
    args = _flash_bwd_case(case, dtype, cuda)
    q, k, v, out, lse, do = args
    _, want_lse = flash_attention_ref(q.float(), k.float(), v.float(),
                                      q_offset=off, window=win,
                                      return_lse=True)
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert ((lse - want_lse)[fin].abs() <=
            1e-5 + 1e-5 * want_lse[fin].abs()).all()
    before = _route_counts("flash_attention_bwd")
    got = ops.flash_attention_bwd(*args, q_offset=off, window=win)
    torch.cuda.synchronize()
    assert _route_counts("flash_attention_bwd") == _moved(
        "flash_attention_bwd", before, dtype)
    want = flash_attention_bwd_ref(*(t.float() for t in args), q_offset=off,
                                   window=win)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == dtype, name
        err = float((g_.float() - w_).abs().max())
        assert err <= FA_BWD_TOL[dtype] * float(w_.abs().max()) + 1e-7, \
            (name, err)
    again = ops.flash_attention_bwd(*args, q_offset=off, window=win)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,shift", [(64, True), (130, False), (256, True)],
                         ids=["d64-unaligned-q", "d130", "d256-unaligned-q"])
def test_flash_bwd_plain_loads(cuda, d, shift, dtype):
    """The backward kernels' plain loads on both routes: q 2 elements off
    16-byte alignment (fp32 at D = 64 takes the wgmma kernels, at D = 256
    the mma.sync ones), or D = 130, off a multiple of 4 and of 8; one
    counted launch on the dtype's route and the gradients within
    `FA_BWD_TOL`."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    q, k, v, out, lse, do = _flash_bwd_case((1, 200, 230, 4, 2, d, 50, 30),
                                            dtype, cuda, seed=d)
    if shift:
        q = _at_offset(q)
        assert q.data_ptr() % 16 != 0
    before = _route_counts("flash_attention_bwd")
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, q_offset=30,
                                  window=50)
    torch.cuda.synchronize()
    assert _route_counts("flash_attention_bwd") == _moved(
        "flash_attention_bwd", before, dtype)
    want = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out)), lse,
                                   do.float(), q_offset=30, window=50)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        err = float((g_.float() - w_).abs().max())
        assert err <= FA_BWD_TOL[dtype] * float(w_.abs().max()) + 1e-7, \
            (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_is_the_same_with_and_without_the_lse(cuda, dtype):
    """Writing the LSE changes no bit of the forward's output."""
    from repro_torch.kernels.flash_attention import ops
    for case in ((1, 300, 333, 8, 2, 128, None, 0),
                 (1, 200, 260, 8, 4, 256, 70, 60),
                 (1, 150, 170, 4, 2, 44, None, -20)):
        b, sq, sk, hq, hkv, d, win, off = case
        q, k, v = _flash_case(b, sq, sk, hq, hkv, d, dtype, cuda, 4)
        plain, none = ops._forward(q, k, v, off, win, 512, False)
        with_lse, lse = ops._forward(q, k, v, off, win, 512, True)
        assert none is None and lse.shape == (b, hq, sq)
        assert torch.equal(plain, with_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_the_card_matches_the_plain_autograd(cuda, dtype):
    """`ops.flash_attention` under autograd on the card against autograd
    through the plain forward on fp32 copies, at the same tolerances."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _flash_case(1, 300, 320, 8, 2, 64, dtype, cuda, 6)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, q_offset=20, window=128)
    do = torch.randn_like(out.float()).to(dtype)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = flash_attention_ref(*ref_leaves, q_offset=20, window=128)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    for g_, w_ in zip(got, want):
        err = float((g_.float() - w_).abs().max())
        assert err <= FA_BWD_TOL[dtype] * float(w_.abs().max()) + 1e-7


def test_zamba2_smoke_train_step_on_the_card_equals_the_cpu(cuda):
    """One `make_train_step` step of the zamba2 smoke model in fp32
    compute on the card and on the CPU from the same weights: loss and
    grad norm within 1e-4, every parameter within 1e-4 max |p| + 1e-6
    where the clipped gradient is at least 100 eps (and within the
    first step's reach elsewhere: tests/test_torch_train.py), one
    `ssd_bwd` launch (fp32 route) per Mamba2 layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW
    cfg = get_smoke_config("zamba2-1.2b")
    batch = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=2)).batch(0)
    saved = (L.dense.__kwdefaults__["compute_dtype"], L.embed.__defaults__,
             L.unembed.__defaults__)
    L.dense.__kwdefaults__["compute_dtype"] = torch.float32
    L.embed.__defaults__ = (torch.float32,)
    L.unembed.__defaults__ = (torch.float32, torch.float32)
    try:
        out = {}
        for dev in ("cpu", cuda):
            model = M.init_params(cfg, 0, device="cpu").to(dev)
            model.requires_grad_()
            opt = AdamW(lr=1e-3)
            state = (model, opt.init(dict(model.named_parameters())),
                     torch.zeros((), dtype=torch.int32, device=dev))
            before = dict(LAUNCHES)
            (model, opt_state, _), metrics = M.make_train_step(cfg, opt)(
                state, batch)
            out[str(dev)] = (model, opt_state, metrics, {
                k: LAUNCHES[k] - before[k] for k in LAUNCHES})
    finally:
        (L.dense.__kwdefaults__["compute_dtype"], L.embed.__defaults__,
         L.unembed.__defaults__) = saved
    host, card = out["cpu"], out[str(cuda)]
    assert card[3]["ssd_bwd"] == card[3]["ssd_bwd_fp32"] == cfg.n_layers
    assert host[3]["ssd_bwd"] == 0
    for key in ("loss", "grad_norm"):
        want = float(host[2][key])
        assert abs(float(card[2][key]) - want) <= 1e-4 * abs(want) + 1e-6
    host_params = dict(host[0].named_parameters())
    for name, p in card[0].named_parameters():
        got, want = p.detach().cpu(), host_params[name].detach()
        well = (host[1]["mu"][name] / 0.1).abs() >= 100 * 1e-8
        err = (got - want).abs()
        assert (err[well] <= 1e-4 * want.abs().max() + 1e-6).all(), name
        assert (err[~well] <= 2e-3 * (1 + 0.1 * want[~well].abs())).all()
