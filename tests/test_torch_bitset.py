"""The port's bitset word view and conflict graph against the JAX
package.  Everything compared is integer or bool, so every comparison
is exact (byte-equal words, equal vertex lists)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import conflict as ref_conflict  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.core.bitset import BitsetGraph as RefGraph  # noqa: E402
from repro.core.bitset import pack_bool_rows  # noqa: E402
from repro.core.cgra import CGRAConfig as RefCGRA  # noqa: E402
from repro.core.kernels_cnkm import PAPER_KERNELS, cnkm_name  # noqa: E402
from repro.core.kernels_cnkm import make_cnkm as ref_make_cnkm  # noqa: E402
from repro_torch.core import conflict as port_conflict  # noqa: E402
from repro_torch.core import schedule as port_schedule  # noqa: E402
from repro_torch.core.bitset import (BitsetGraph, pack_words,  # noqa: E402
                                     unpack_words)
from repro_torch.core.cgra import CGRAConfig  # noqa: E402
from repro_torch.core.kernels_cnkm import make_cnkm  # noqa: E402

MODES = ("bandmap", "busmap")


def _graphs(n: int, m: int, mode: str):
    """The conflict graph of the first schedulable II (jitter 0), built
    by both packages from the same kernel."""
    ref_dfg, dfg = ref_make_cnkm(n, m), make_cnkm(n, m)
    ref_cgra, cgra = RefCGRA(), CGRAConfig()
    start = ref_schedule.mii(ref_dfg, ref_cgra)
    for ii in range(start, start + 6):
        try:
            ref_sched = ref_schedule.schedule_dfg(
                ref_dfg, ref_cgra, mode=mode, ii=ii, max_ii=ii, jitter=0,
                seed=0)
        except RuntimeError:
            continue
        sched = port_schedule.schedule_dfg(dfg, cgra, mode=mode, ii=ii,
                                           max_ii=ii, jitter=0, seed=0)
        return (ref_conflict.build_conflict_graph(ref_sched, ref_cgra,
                                                  bus_pressure=True),
                port_conflict.build_conflict_graph(sched, cgra,
                                                   bus_pressure=True))
    raise AssertionError("no schedulable II")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,m", PAPER_KERNELS,
                         ids=[cnkm_name(n, m) for n, m in PAPER_KERNELS])
def test_conflict_graph_and_word_view_match_reference(n, m, mode):
    ref_cg, cg = _graphs(n, m, mode)
    assert cg.vertices == [port_conflict.Vertex(**vars(v))
                           for v in ref_cg.vertices]
    np.testing.assert_array_equal(cg.bits.rows, ref_cg.bits.rows)
    n_pad = -(-cg.n // 128) * 128
    words = cg.bits.rows_i32(n_pad)
    assert words.dtype == torch.int32
    assert words.shape == (n_pad, n_pad // 32)
    assert words.numpy().tobytes() == \
        ref_cg.bits.rows_u32(n_pad).tobytes()


def test_from_rows_adopts_reference_rows():
    ref_cg, _ = _graphs(2, 6, "busmap")
    g = BitsetGraph.from_rows(ref_cg.bits.rows)
    np.testing.assert_array_equal(g.rows, ref_cg.bits.rows)
    assert g.rows is not ref_cg.bits.rows
    assert g.n_edges == ref_cg.bits.n_edges
    with pytest.raises(ValueError):
        BitsetGraph.from_rows(ref_cg.bits.rows.view(np.int64))
    with pytest.raises(ValueError):
        BitsetGraph.from_rows(ref_cg.bits.rows[:-1])
    with pytest.raises(ValueError):
        BitsetGraph.from_rows(ref_cg.bits.rows[0])


@pytest.mark.parametrize("k,n_pad", [(1, 32), (5, 128), (9, 2176)])
def test_pack_unpack_round_trip_and_layout(k, n_pad):
    rng = np.random.default_rng(k * n_pad)
    bits = rng.random((k, n_pad)) < 0.4
    bits[0, :] = True                       # every word all ones
    words = pack_words(torch.from_numpy(bits))
    assert words.dtype == torch.int32 and words.shape == (k, n_pad // 32)
    # Same layout as the reference's packed rows (bit j of word j//32).
    ref = pack_bool_rows(bits).view(np.uint32)[:, :n_pad // 32]
    assert words.numpy().tobytes() == np.ascontiguousarray(ref).tobytes()
    assert torch.equal(unpack_words(words), torch.from_numpy(bits))


def test_pack_rejects_unaligned_width():
    with pytest.raises(ValueError):
        pack_words(torch.zeros((2, 40), dtype=torch.bool))


def test_rows_i32_pads_with_empty_rows_and_words():
    g = RefGraph.from_dense(np.ones((40, 40), dtype=bool))
    port = BitsetGraph.from_rows(g.rows)
    words = port.rows_i32(128)
    assert (words[40:] == 0).all() and (words[:, 2:] == 0).all()
    assert words.numpy().tobytes() == g.rows_u32(128).tobytes()


@pytest.mark.parametrize("use_kernel",
                         [True, "packed", "packed-pallas", "packed-cuda"])
def test_conflict_kernels_not_ported_raise(use_kernel):
    """The occupancy/clique routes of `build_conflict_graph`: the host
    oracles (True, "packed") give rows byte-equal to the reference's
    same route and to the port's default build; "packed-pallas" has no
    port and raises ValueError naming "packed-cuda"; "packed-cuda"
    needs a GPU and raises without one."""
    ref_dfg, dfg = ref_make_cnkm(2, 6), make_cnkm(2, 6)
    ref_cgra, cgra = RefCGRA(), CGRAConfig()
    ref_sched = ref_schedule.schedule_dfg(ref_dfg, ref_cgra, mode="busmap")
    sched = port_schedule.schedule_dfg(dfg, cgra, mode="busmap")
    if use_kernel == "packed-pallas":
        with pytest.raises(ValueError, match="packed-cuda"):
            port_conflict.build_conflict_graph(sched, cgra,
                                               use_kernel=use_kernel)
        return
    if use_kernel == "packed-cuda":
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: tests/test_torch_gpu.py runs "
                        "this route")
        with pytest.raises(RuntimeError, match="CUDA"):
            port_conflict.build_conflict_graph(sched, cgra,
                                               use_kernel=use_kernel)
        return
    for bus_pressure in (False, True):
        want = ref_conflict.build_conflict_graph(
            ref_sched, ref_cgra, use_kernel=use_kernel,
            bus_pressure=bus_pressure)
        got = port_conflict.build_conflict_graph(
            sched, cgra, use_kernel=use_kernel, bus_pressure=bus_pressure)
        default = port_conflict.build_conflict_graph(
            sched, cgra, bus_pressure=bus_pressure)
        assert got.bits.rows.tobytes() == want.bits.rows.tobytes()
        assert got.bits.rows.tobytes() == default.bits.rows.tobytes()
        assert got.n_edges == default.n_edges
