"""The port's conflict-matrix module against the JAX package: its
`encode`, the plain torch versions of the two CUDA kernels (held to the
Pallas kernels in interpret mode and to the numpy oracle) and the
vertex-level entry points.  Every value is a bit or an integer, so
every comparison is exact (tolerance zero)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import schedule_dfg as ref_schedule_dfg  # noqa: E402
from repro.core.bitset import pack_bool_rows  # noqa: E402
from repro.core.cgra import CGRAConfig as RefCGRA  # noqa: E402
from repro.core.conflict import \
    build_conflict_graph as ref_build  # noqa: E402
from repro.core.kernels_cnkm import make_cnkm as ref_make_cnkm  # noqa: E402
from repro.kernels.conflict_matrix import ops as ref_ops  # noqa: E402
from repro.kernels.conflict_matrix import ref as ref_ref  # noqa: E402
from repro.kernels.conflict_matrix.kernel import (  # noqa: E402
    conflict_matrix_packed_pallas, conflict_matrix_pallas)
from repro_torch.core import CGRAConfig, make_cnkm, schedule_dfg  # noqa: E402
from repro_torch.core.bitset import n_words  # noqa: E402
from repro_torch.core.conflict import build_conflict_graph  # noqa: E402
from repro_torch.kernels.conflict_matrix import ops, ref  # noqa: E402


def _graphs(n: int, m: int, mode: str = "bandmap", side: int = 4):
    """The same kernel's conflict graph, built by both packages."""
    ref_cgra, cgra = RefCGRA(rows=side, cols=side), \
        CGRAConfig(rows=side, cols=side)
    ref_sched = ref_schedule_dfg(ref_make_cnkm(n, m), ref_cgra, mode=mode)
    sched = schedule_dfg(make_cnkm(n, m), cgra, mode=mode)
    return ref_build(ref_sched, ref_cgra), build_conflict_graph(sched, cgra)


def _random_features(n: int, seed: int) -> np.ndarray:
    """Fields in small ranges, so that many pairs share a kind, op, slot,
    port or PE; kinds beyond QUAD and -1 match no occupancy rule."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(-1, 4, n), rng.integers(0, 6, n),
                     rng.integers(0, 3, n), rng.integers(-1, 3, n),
                     rng.integers(-1, 3, n), rng.integers(-1, 3, n),
                     rng.integers(-1, 2, n), rng.integers(0, 3, n)],
                    axis=1).astype(np.int32).reshape(n, 8)


def _words_as_u64(words: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(words.numpy()).view(np.uint64)


@pytest.mark.parametrize("n,m,mode,side", [
    (2, 4, "bandmap", 4), (2, 6, "busmap", 4), (3, 6, "bandmap", 4),
    (2, 8, "busmap", 4), (4, 8, "busmap", 8)])
def test_encode_matches_reference(n, m, mode, side):
    ref_cg, cg = _graphs(n, m, mode, side)
    want = ref_ref.encode(ref_cg.vertices)
    got = ref.encode(cg.vertices)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # C2K8 under busmap on 4x4 schedules routing ops: drive is encoded.
    if (n, m, mode, side) == (2, 8, "busmap", 4):
        assert (got[:, 7] > 0).any()


@pytest.mark.parametrize("n,m,blk", [(2, 4, 32), (2, 6, 64), (4, 4, 128)])
def test_dense_plain_equals_pallas_interpret(n, m, blk):
    ref_cg, _ = _graphs(n, m)
    feat = ref_ref.encode(ref_cg.vertices)
    pallas = np.asarray(conflict_matrix_pallas(
        jnp.asarray(feat), block=blk, interpret=True))
    got = ref.conflict_matrix_plain(torch.from_numpy(feat))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy().astype(bool),
                                  ref_ref.conflict_matrix_ref(feat))


@pytest.mark.parametrize("n,m,bi,bj", [(2, 4, 32, 64), (2, 6, 64, 128),
                                       (4, 4, 128, 256)])
def test_packed_plain_equals_pallas_interpret(n, m, bi, bj):
    ref_cg, _ = _graphs(n, m)
    feat = ref_ref.encode(ref_cg.vertices)
    nv = feat.shape[0]
    pallas = np.ascontiguousarray(np.asarray(conflict_matrix_packed_pallas(
        jnp.asarray(feat), block_i=bi, block_j=bj, interpret=True)))
    got = ref.conflict_matrix_packed_plain(torch.from_numpy(feat))
    assert got.dtype == torch.int32 and got.shape == (nv, 2 * n_words(nv))
    assert got.numpy().tobytes() == \
        np.ascontiguousarray(pallas[:, :2 * n_words(nv)]).tobytes()
    assert (pallas[:, 2 * n_words(nv):] == 0).all()
    np.testing.assert_array_equal(
        _words_as_u64(got),
        pack_bool_rows(ref_ref.conflict_matrix_ref(feat)))


def test_plain_versions_on_ragged_sizes():
    for n in range(131):
        feat = _random_features(n, seed=n)
        want = ref_ref.conflict_matrix_ref(feat)
        t = torch.from_numpy(feat)
        dense = ref.conflict_matrix_plain(t)
        words = ref.conflict_matrix_packed_plain(t)
        assert dense.shape == (n, n) and words.shape == (n, 2 * n_words(n))
        np.testing.assert_array_equal(dense.numpy().astype(bool), want)
        np.testing.assert_array_equal(_words_as_u64(words),
                                      pack_bool_rows(want))
        # The port's own oracle copy is the reference's.
        np.testing.assert_array_equal(ref.conflict_matrix_ref(feat), want)


def test_every_pair_of_one_op_conflicts():
    feat = _random_features(70, seed=1)
    feat[:, 1] = 3
    dense = ref.conflict_matrix_plain(torch.from_numpy(feat)).numpy()
    np.testing.assert_array_equal(dense, 1 - np.eye(70, dtype=np.int8))


@pytest.mark.parametrize("n,m,mode", [(2, 6, "bandmap"), (3, 6, "busmap"),
                                      (4, 4, "bandmap")])
def test_host_entry_points_match_reference(n, m, mode):
    ref_cg, cg = _graphs(n, m, mode)
    want = ref_ops.conflict_matrix(ref_cg.vertices)
    got = ops.conflict_matrix(cg.vertices, use_cuda=False)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    want_rows = ref_ops.conflict_matrix_packed(ref_cg.vertices)
    got_rows = ops.conflict_matrix_packed(cg.vertices, use_cuda=False)
    assert got_rows.dtype == np.uint64
    assert got_rows.tobytes() == want_rows.tobytes()
    # The tensor wrappers on CPU tensors run the plain versions.
    feat = torch.from_numpy(ref.encode(cg.vertices))
    np.testing.assert_array_equal(
        ops.conflict_matrix_dense(feat).numpy().astype(bool), want)
    assert _words_as_u64(ops.conflict_matrix_words(feat)).tobytes() == \
        want_rows.tobytes()


def test_use_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    _, cg = _graphs(2, 4)
    for fn in (ops.conflict_matrix, ops.conflict_matrix_packed):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(cg.vertices, use_cuda=True)
        with pytest.raises(ValueError, match="CUDA device"):
            fn(cg.vertices, use_cuda=True, device="cpu")


def test_vertex_entry_points_default_to_the_card():
    """With no flag the vertex-level entry points take the card: without
    a GPU they raise, never fall back to the host's oracle."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    _, cg = _graphs(2, 4)
    for fn in (ops.conflict_matrix, ops.conflict_matrix_packed):
        with pytest.raises(RuntimeError, match="use_cuda=False"):
            fn(cg.vertices)
        with pytest.raises(ValueError, match="CUDA device"):
            fn(cg.vertices, device="cpu")


@pytest.mark.parametrize("wrapper", [ops.conflict_matrix_dense,
                                     ops.conflict_matrix_words])
def test_tensor_wrappers_check_their_input(wrapper):
    with pytest.raises(ValueError, match="meta"):
        wrapper(torch.zeros((4, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):
        wrapper(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        wrapper(torch.zeros((4, 7), dtype=torch.int32))
    with pytest.raises(ValueError):
        wrapper(torch.zeros((8, 4), dtype=torch.int32).t())


# The packed kernel's formulation: the OR of each row's op-group and
# place-group masks (ref.conflict_matrix_packed_groups), proven here
# against the pair predicate and the Pallas kernel before the card runs
# its CUDA form.
def _wide_features(n: int, seed: int) -> np.ndarray:
    """Op ids and slots spread over the whole int32 range, so the
    mixed-radix ids would span too many rows and the ids are sorted."""
    feat = _random_features(n, seed)
    rng = np.random.default_rng(seed + 1)
    feat[:, 1] = rng.choice([-2**31, -7, 0, 2**31 - 1], n)
    feat[:, 2] = rng.choice([-2**31, 1, 2**31 - 1], n)
    return feat


@pytest.mark.parametrize("n,m,bi,bj", [(2, 4, 32, 64), (2, 6, 64, 128),
                                       (4, 4, 128, 256)])
def test_packed_groups_equal_pallas_interpret(n, m, bi, bj):
    ref_cg, _ = _graphs(n, m)
    feat = ref_ref.encode(ref_cg.vertices)
    nv = feat.shape[0]
    pallas = np.ascontiguousarray(np.asarray(conflict_matrix_packed_pallas(
        jnp.asarray(feat), block_i=bi, block_j=bj, interpret=True)))
    t = torch.from_numpy(feat)
    assert ref.radix_plan(t) is not None    # real graphs: the radix ids
    got = ref.conflict_matrix_packed_groups(t)
    assert got.dtype == torch.int32 and got.shape == (nv, 2 * n_words(nv))
    assert got.numpy().tobytes() == \
        np.ascontiguousarray(pallas[:, :2 * n_words(nv)]).tobytes()
    assert got.numpy().tobytes() == \
        ref.conflict_matrix_packed_plain(t).numpy().tobytes()


@pytest.mark.parametrize("kind", ["random", "one-op", "wide"])
def test_packed_groups_equal_pair_predicate_on_ragged_sizes(kind):
    for n in range(131):
        feat = _wide_features(n, n) if kind == "wide" \
            else _random_features(n, seed=n)
        if kind == "one-op":
            feat[:, 1] = 3
        t = torch.from_numpy(feat)
        got = ref.conflict_matrix_packed_groups(t)
        assert got.numpy().tobytes() == \
            ref.conflict_matrix_packed_plain(t).numpy().tobytes(), n
        np.testing.assert_array_equal(
            _words_as_u64(got), pack_bool_rows(ref_ref.conflict_matrix_ref(
                feat)))


def test_group_ids_take_both_methods():
    """Narrow fields give the mixed-radix ids; wide ones sorted ids; the
    two partition the vertices alike, and kinds outside TIN/TOUT/QUAD
    have no place."""
    feat = torch.from_numpy(_random_features(500, seed=5))
    plan = ref.radix_plan(feat)
    assert plan is not None and len(plan) == len(ref.PLAN_FIELDS)
    op_r, place_r = ref.radix_ids(feat, plan)
    op_s, place_s, rows = ref.sorted_ids(feat)
    assert rows <= ref.group_rows(plan)
    for a, b in ((op_r, op_s), (place_r, place_s)):
        same_a = a[:, None] == a[None, :]
        same_b = b[:, None] == b[None, :]
        assert torch.equal(same_a, same_b)
    kind = feat[:, 0]
    placed = (kind >= 0) & (kind <= 2)
    assert bool((place_r[~placed] == -1).all())
    assert bool((place_r[placed] >= plan[5]).all())   # after the op rows
    assert ref.radix_plan(torch.from_numpy(_wide_features(500, 6))) is None


def test_packed_wrapper_on_the_cpu_takes_the_groups():
    """On CPU tensors the packed wrapper runs its kernel's plain version,
    the group formulation, byte-equal to the pair predicate."""
    for seed, make in ((1, _random_features), (2, _wide_features)):
        t = torch.from_numpy(make(777, seed))
        assert torch.equal(ops.conflict_matrix_words(t),
                           ref.conflict_matrix_packed_plain(t))


# The dense CUDA kernel's arithmetic: folded op and place words on tiles
# whose fields fit them, the fields themselves on the rest
# (ref.conflict_matrix_folded), held here to the Pallas kernel and the
# numpy oracle before the card runs it.
def _fold_features(n: int, seed: int, kind: str) -> np.ndarray:
    """``random`` and ``wide`` as above; ``one-op``: every vertex in op
    3; ``fold-edge``: slots, ports and PEs at both ends of the fold's
    signed widths (every tile folds); ``past-edge``: one past them, or
    aliasing an in-range value modulo the width (no tile folds);
    ``mixed``: one vertex with a slot past 14 bits, whose row tile and
    strip take the general loop while the other tiles fold."""
    if kind == "wide":
        return _wide_features(n, seed)
    feat = _random_features(n, seed)
    rng = np.random.default_rng(seed + 2)
    if kind == "one-op":
        feat[:, 1] = 3
    elif kind in ("fold-edge", "past-edge"):
        past = kind == "past-edge"
        for col, bits in ((2, ref.M_BITS), (3, ref.PORT_BITS),
                          (4, ref.PE_BITS), (5, ref.PE_BITS)):
            lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
            ends = [lo - 1, hi + 1, hi + (1 << bits)] if past \
                else [lo, -1, 0, hi]
            feat[:, col] = rng.choice(ends, n)
        if past:
            feat[:, 0] = rng.integers(0, 3, n)
    elif kind == "mixed":
        feat[n // 2, 0], feat[n // 2, 2] = 2, 1 << (ref.M_BITS - 1)
    return feat


@pytest.mark.parametrize("kind", ["random", "one-op", "wide", "fold-edge",
                                  "past-edge", "mixed"])
@pytest.mark.parametrize("n", [1, 63, 65, 1025, 1100])
def test_folded_equals_pallas_interpret_and_ref(kind, n):
    feat = _fold_features(n, n, kind)
    pallas = np.asarray(conflict_matrix_pallas(jnp.asarray(feat),
                                               interpret=True))
    got = ref.conflict_matrix_folded(torch.from_numpy(feat))
    assert got.dtype == torch.int8 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy().astype(bool),
                                  ref_ref.conflict_matrix_ref(feat))
    tiles = ref.fold_tiles(torch.from_numpy(feat))
    assert tiles.shape == (-(-n // ref.TILE_ROWS), -(-n // ref.STRIP))
    if kind == "fold-edge":
        assert bool(tiles.all())
    if kind == "past-edge":
        assert not bool(tiles.any())
    if kind == "mixed" and n > ref.STRIP:
        assert 0 < int(tiles.sum()) < tiles.numel()


def test_fold_constants_match_the_kernel_source():
    """`ref`'s tile and fold widths, which `fold_tiles` and
    `conflict_matrix_folded` model the dense kernel with, are the CUDA
    source's ``constexpr`` values."""
    import pathlib
    import re
    src = (pathlib.Path(ref.__file__).parent / "csrc" /
           "conflict_matrix.cu").read_text()
    consts: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    assert (consts["kTileRows"], consts["kStrip"]) == (ref.TILE_ROWS,
                                                       ref.STRIP)
    assert (consts["kMBits"], consts["kPortBits"], consts["kPeBits"]) == \
        (ref.M_BITS, ref.PORT_BITS, ref.PE_BITS)
    assert (consts["kTin"], consts["kTout"], consts["kQuad"]) == \
        (ref.TIN, ref.TOUT, ref.QUAD)


def test_folded_words_are_exact_where_the_fields_fit():
    """Off the diagonal, fitting vertices share a place word iff they
    share a place; out-of-range fields that alias an in-range value
    modulo the width do not fit (the general loop compares them)."""
    feat = torch.from_numpy(np.concatenate([
        _fold_features(400, 7, "fold-edge"),
        _fold_features(400, 8, "past-edge")]))
    op, place, fits = ref.fold_keys(feat)
    assert bool(fits[:400].all()) and not bool(fits[400:].any())
    kind, m = feat[:, 0], feat[:, 2]
    port, pe_r, pe_c = feat[:, 3], feat[:, 4], feat[:, 5]
    same_kind = kind[:, None] == kind[None, :]
    port_kind = (kind == ref.TIN) | (kind == ref.TOUT)
    same_place = same_kind & (m[:, None] == m[None, :]) & (
        (port_kind[:, None] & (port[:, None] == port[None, :])) |
        ((kind == ref.QUAD)[:, None] & (pe_r[:, None] == pe_r[None, :]) &
         (pe_c[:, None] == pe_c[None, :])))
    same_place.fill_diagonal_(False)
    folded = place[:, None] == place[None, :]
    folded.fill_diagonal_(False)
    both = fits[:, None] & fits[None, :]
    assert torch.equal(folded[both], same_place[both])
    assert torch.equal(op, feat[:, 1].long())
    # Past the widths the words alias: that is why such tiles go general.
    assert bool((folded & ~same_place)[400:, 400:].any())


def test_conflict_matrix_views_the_card_result_as_bool(monkeypatch):
    """The dense vertex entry point hands back the kernel's bytes as a
    bool array: the same values, dtype and shape as the host oracle."""
    _, cg = _graphs(2, 6)
    monkeypatch.setattr(ops, "_cuda_features", lambda vertices, device:
                        torch.from_numpy(ref.encode(vertices)))
    got = ops.conflict_matrix(cg.vertices)
    want = ops.conflict_matrix(cg.vertices, use_cuda=False)
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
