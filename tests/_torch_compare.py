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


# XLA's compile option that keeps every rounding the source writes: with
# it off (the default), XLA may carry a chain of bf16 operations in fp32
# and round once, so a jitted reference parts from its own ops run one by
# one.  The port's bf16 tests compare against the reference compiled
# with it.
STRICT_OPTIONS = {"xla_allow_excess_precision": False}


class strict_jit:
    """``fn`` jitted and compiled with `STRICT_OPTIONS`: lowered and
    compiled once for each structure, shape and dtype of its arguments,
    and the executable cached.  It equals the reference's run under
    ``jax.disable_jit()`` bit for bit on the smoke configs
    (tests/test_torch_families.py)."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self._compiled: dict = {}

    def __call__(self, *args):
        import jax
        import numpy as np
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), str(np.asarray(a).dtype))
                           for a in leaves))
        exe = self._compiled.get(key)
        if exe is None:
            exe = jax.jit(self.fn).lower(*args).compile(
                compiler_options=STRICT_OPTIONS)
            self._compiled[key] = exe
        return exe(*args)


def fp32_compute(monkeypatch) -> None:
    """Both packages' dense layers, embeddings, tied unembeddings and MoE
    products compute in float32 (the tied unembedding rounds its
    operands to its own ``compute_dtype``, bf16 by default, and the MoE
    FFN to its own), through ``monkeypatch``."""
    import jax.numpy as jnp
    import torch

    import repro.models.layers as ref_layers
    import repro.models.moe as ref_moe
    from repro_torch.models import layers as L
    from repro_torch.models import moe as PM
    monkeypatch.setitem(ref_layers.dense.__kwdefaults__, "compute_dtype",
                        jnp.float32)
    monkeypatch.setattr(ref_layers.embed, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(ref_layers.unembed, "__defaults__",
                        (jnp.float32, jnp.float32))
    monkeypatch.setitem(L.dense.__kwdefaults__, "compute_dtype",
                        torch.float32)
    monkeypatch.setattr(L.embed, "__defaults__", (torch.float32,))
    monkeypatch.setattr(L.unembed, "__defaults__",
                        (torch.float32, torch.float32))
    for fn in (ref_moe.moe_ffn, ref_moe.moe_ffn_capacity):
        monkeypatch.setitem(fn.__kwdefaults__, "compute_dtype", jnp.float32)
    for fn in (PM.moe_ffn, PM.moe_ffn_capacity):
        monkeypatch.setitem(fn.__kwdefaults__, "compute_dtype",
                            torch.float32)
