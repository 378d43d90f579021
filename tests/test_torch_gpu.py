"""Tests of the port that need a CUDA GPU: the hand-written kernels
against their plain torch versions, the engine on the card against the
engine on the CPU, and the conflict build's CUDA route against the host
build.  They skip without a GPU; on the card they run with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports only torch and the port (no JAX), so that it runs
where JAX is not installed.  Every comparison is exact: the counts, the
adjacency bits and the engine state are integers and bools.
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
