"""The correctness check on the CPU at smoke widths: a sound run is
correct; a run with a fault planted under the timed path, and the
float8 control, are not; the result line has exactly its keys."""

from __future__ import annotations

import time

import pytest

from portbench.bench import harness, spec
from portbench.reference import compare
from portbench.tests import smoke

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = sorted(smoke.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(str(tmp_path_factory.mktemp("portbench")))


def _run(root, workload, seed, trace, fault=None):
    cell = spec.cell(root, workload)
    kind = spec.load(root, "kinds", cell.traffic["kind"])
    out = kind.run(cell, seed, 0.2, bool(trace), device="cpu",
                   t0=time.perf_counter(), fault=fault)
    return harness.result(root, cell, out, bool(trace),
                          {"platform": "cpu", "kind": "cpu", "count": 1})


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, monkeypatch, name, trace):
    smoke.use_smoke_widths(monkeypatch)
    line = _run(root, name + "-cell", 3, trace)
    assert line["correct"], line["checks"]
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    assert list(line) == keys
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # The host has no device trace: only the step's share of the
        # peak is read, and the card's run would fail for the rest.
        assert set(line["metrics"]) == {"train_mfu"}
        cell = spec.cell(root, name + "-cell")
        assert set(harness.unread(cell, line)) == {
            m["name"] for m in cell.per_layer} - {"train_mfu"}
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s",
                                        "train_peak_gb", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "bwd_scaled"])
def test_fault_under_the_timed_path_is_not_correct(root, monkeypatch, name,
                                                   fault):
    smoke.use_smoke_widths(monkeypatch)
    line = _run(root, name + "-cell", 4, 0, fault=fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_float8_control_is_not_correct(root, monkeypatch, name):
    smoke.use_smoke_widths(monkeypatch)
    cell = spec.cell(root, name + "-cell")
    kind = spec.load(root, "kinds", cell.traffic["kind"])
    for seed in (5, 6, 7):
        want = kind.reference(cell, seed, "cpu")
        got = kind.reference(cell, seed, "cpu", precision="float8")
        correct, checks = compare.checks(compare.gaps(got, want),
                                         cell.limits["limits"])
        assert not correct, (seed, checks)


def test_gaps_by_the_worst_leaf():
    want = {"losses": [2.0, 1.0], "grad_norms": {"a": 1.0, "b": 4.0,
                                                 "c": 1e-9},
            "change_norms": {"a": 1.0, "b": 1.0, "c": 1.0},
            "dims": {"a": 2, "b": 2, "c": 1}}
    got = {"losses": [2.5, 0.0], "grad_norms": {"a": 1.5, "b": 4.0,
                                                "c": 2.0},
           "change_norms": {"a": 1.0, "b": 1.2, "c": 9.0}}
    gaps = compare.gaps(got, want)
    # The worst step's loss is the second's; the first step's apart.
    assert gaps["loss_gap"] == 1.0
    assert gaps["loss_gap_first"] == 0.5
    # c's gap counts against the median leaf's norm (1.0), not its own.
    assert gaps["grad_gap"] == pytest.approx(2.0)
    # Of the matrices a's gap is the largest; c is a vector.
    assert gaps["grad_gap_matrices"] == pytest.approx(0.5)
    assert gaps["grad_gap_median"] == pytest.approx(0.5)
    # c has no gradient to speak of: its change is not compared.
    assert gaps["change_gap"] == pytest.approx(0.2)
