"""The port's sbts_step conflict counts against the JAX package.

The plain torch version (`repro_torch.kernels.sbts_step.ref`) must equal
the reference's numpy oracle and its Pallas kernel (interpret mode, as
the reference's own tests run it on the CPU) exactly: the counts are
integers, so the tolerance is zero.  Inputs are numpy words from a seed,
with ragged K, several word counts, and all-ones / all-zero words to
catch sign-bit and masking faults in the int32 SWAR popcount.  The
wrapper's CPU route and its argument checks are covered here; the CUDA
kernel itself is held to the plain version in test_torch_gpu.py and by
chip_smoke.py on the card.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sbts_step.kernel import (  # noqa: E402
    selection_counts_pallas)
from repro.kernels.sbts_step.ref import selection_counts_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES, count_launch  # noqa: E402
from repro_torch.kernels.sbts_step import selection_counts  # noqa: E402
from repro_torch.kernels.sbts_step.ref import (  # noqa: E402
    popcount32, selection_counts_plain)


def _words(k: int, w: int, seed: int):
    """(rows uint32 [32w, w], sel uint32 [k, w]) with a full row, an
    empty row, a full selection and an empty selection planted."""
    rng = np.random.default_rng(seed)
    n = 32 * w
    rows = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    sel = rng.integers(0, 2**32, (k, w), dtype=np.uint32)
    rows[0] = 0xFFFFFFFF
    rows[1] = 0
    rows[2] = 0x80000000          # only the sign bit
    sel[0] = 0xFFFFFFFF
    if k > 1:
        sel[1] = 0
    if k > 2:
        sel[2] = 0x80000000
    return rows, sel


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("w", [4, 8, 68])
@pytest.mark.parametrize("k", [1, 5, 13])
def test_plain_equals_reference_oracle_and_pallas(k, w):
    rows, sel = _words(k, w, seed=100 * k + w)
    want = selection_counts_ref(rows, sel)
    pallas = np.asarray(selection_counts_pallas(rows, sel, interpret=True))
    got = selection_counts_plain(_t(rows), _t(sel))
    assert got.dtype == torch.int32 and got.shape == (k, 32 * w)
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 32 * w          # full row & full selection
    assert (got[:, 1] == 0).all()       # empty row


@pytest.mark.parametrize("pattern", [0, 0xFFFFFFFF, 0x80000000,
                                     0x7FFFFFFF, 0x55555555, 0xAAAAAAAA,
                                     0x0F0F0F0F, 0x00010001])
def test_popcount32_on_edge_words(pattern):
    x = torch.tensor([pattern], dtype=torch.int64).to(torch.int32)
    assert int(popcount32(x.clone())[0]) == bin(pattern).count("1")


def test_popcount32_matches_numpy_on_random_words():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    got = popcount32(_t(words).clone()).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words))


def test_wrapper_cpu_route_is_the_plain_version():
    rows, sel = _words(6, 8, seed=3)
    before = LAUNCHES["selection_counts"]
    got = selection_counts(_t(rows), _t(sel))
    np.testing.assert_array_equal(got.numpy(),
                                  selection_counts_ref(rows, sel))
    # Only a kernel launch counts; the CPU route launches nothing.
    assert LAUNCHES["selection_counts"] == before


def test_plain_version_slices_large_k_identically():
    """Above the per-slice element bound the plain version walks K in
    slices; the result must not depend on where the slices fall."""
    import repro_torch.kernels.sbts_step.ref as ref_mod
    rows, sel = _words(37, 4, seed=11)
    whole = selection_counts_plain(_t(rows), _t(sel))
    saved = dict(ref_mod._CHUNK_ELEMS)
    try:
        ref_mod._CHUNK_ELEMS["cpu"] = 128 * 4 * 5      # 5 rows a slice
        sliced = selection_counts_plain(_t(rows), _t(sel))
    finally:
        ref_mod._CHUNK_ELEMS.update(saved)
    assert torch.equal(whole, sliced)


@pytest.mark.parametrize("case", ["dtype", "dims", "words", "contig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    rows = torch.zeros((128, 4), dtype=torch.int32)
    sel = torch.zeros((3, 4), dtype=torch.int32)
    if case == "dtype":
        rows = rows.to(torch.int64)
    elif case == "dims":
        sel = sel.reshape(3, 2, 2)
    elif case == "words":
        sel = torch.zeros((3, 5), dtype=torch.int32)
    else:
        rows = torch.zeros((4, 128), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        selection_counts(rows, sel)


def test_launch_counts_are_exact_across_threads():
    """Every wrapper counts through `count_launch`, which holds a lock: a
    bare ``LAUNCHES[name] += 1`` is a read and a write that threads can
    interleave.  Eight threads, switching as often as the interpreter
    allows, lose no count and count each launch's route key with it."""
    import sys
    import threading
    n_threads, per = 8, 4000
    before = dict(LAUNCHES)
    start = threading.Barrier(n_threads, timeout=60)

    def work(route: str) -> None:
        start.wait()
        for _ in range(per):
            count_launch("ssd", route)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work,
                                    args=("bf16" if i % 2 else "fp32",))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert LAUNCHES["ssd"] - before["ssd"] == n_threads * per
    for route in ("bf16", "fp32"):
        assert LAUNCHES[f"ssd_{route}"] - before[f"ssd_{route}"] == \
            n_threads * per // 2
    assert all(LAUNCHES[k] == before[k] for k in LAUNCHES
               if k not in ("ssd", "ssd_bf16", "ssd_fp32"))
