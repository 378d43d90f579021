"""Exact comparisons of the port's results with the reference's, shared
by the `test_torch_*` differentials of the mapper's service tier."""

from __future__ import annotations

import dataclasses

RESULT_FIELDS = ("ok", "mode", "ii", "mii", "n_routing_pes",
                 "ports_per_vio", "cg_size", "mis_size", "n_ops",
                 "attempts", "optimal", "proved_infeasible", "backend")


def untimed(events) -> list:
    """Flight events (or coverage rows) without their clock reading."""
    return [{k: v for k, v in ev.items() if k != "t"} for ev in events]


def placement(res) -> dict:
    return {op: vars(v) for op, v in res.placement.items()}


def certificates(res) -> list:
    return [(c.ii, c.jitter, c.stage, c.nodes, c.detail)
            for c in res.certificates]


def assert_same_result(got, want) -> None:
    """Every field of two `MappingResult`s but the wall times."""
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert untimed(got.flight) == untimed(want.flight)
    assert placement(got) == placement(want)
    assert certificates(got) == certificates(want)
    assert (got.sched is None) == (want.sched is None)
    if got.sched is not None:
        assert got.sched.time == want.sched.time
        assert got.sched.n_routing_ops == want.sched.n_routing_ops
    assert (got.report is None) == (want.report is None)
    if got.report is not None:
        assert got.report.ok == want.report.ok
        assert got.report.violations == want.report.violations


def assert_same_comap(got, want) -> None:
    """Every field of two `CoMapResult`s but the wall times."""
    assert (got.ok, got.ii, got.attempts) == \
        (want.ok, want.ii, want.attempts)
    assert [vars(r) for r in got.regions] == \
        [vars(r) for r in want.regions]
    assert [dataclasses.astuple(c) for c in got.region_cfgs] == \
        [dataclasses.astuple(c) for c in want.region_cfgs]
    assert len(got.results) == len(want.results)
    for g, w in zip(got.results, want.results):
        assert (g is None) == (w is None)
        if g is not None:
            assert_same_result(g, w)
    assert placement(got) == placement(want)
    assert (got.sched is None) == (want.sched is None)
    if got.sched is not None:
        assert got.sched.time == want.sched.time
    assert (got.report is None) == (want.report is None)
    if got.report is not None:
        assert (got.report.ok, got.report.violations) == \
            (want.report.ok, want.report.violations)
    assert (got.arbiter is None) == (want.arbiter is None)
    if got.arbiter is not None:
        assert vars(got.arbiter) == vars(want.arbiter)
    assert untimed(got.flight) == untimed(want.flight)
