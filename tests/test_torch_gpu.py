"""Tests of the port that need a CUDA GPU: the hand-written kernels
against their plain torch versions, the engine on the card against the
engine on the CPU, the conflict build's CUDA route against the host
build, and the zamba2 smoke model on the card against the CPU.  They
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
takes head dims up to 256 on both.  `selection_counts` runs on the .b1 tensor
cores and the packed conflict kernel ORs group masks: both are held to
plain versions bit for bit, and launch counts to exactness across
threads.
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
    (2, 97, 300, 4, 2, 256, None, 203)], ids=str)
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
    (1, 2000, 2, 64, 100, 1024)], ids=str)
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
