"""The port's op-level FLOP count (`launch.op_analysis`) against the
reference's HLO count (`repro.launch.hlo_analysis.analyze` of the
compiled step's text), on the CPU: one smoke config of each family at a
small cell, for prefill and decode (train:
``tests/test_torch_op_analysis_train.py``).  The port's step is counted
twice, on the CPU (the kernels' plain versions run, each counted once by
its formula) and on ``meta`` (the dry run's device, where the kernels'
meta branches count by the same formulas), and the two counts are
equal.

One rewrite of XLA's is named: on the CPU backend XLA lowers
``ragged-dot`` (the MoE FFN's grouped products, `jax.lax.ragged_dot`) to
a dense product over every expert, 2·M·(E·K)·N FLOPs where the
``ragged-dot`` instruction would count 2·M·K·N (`hlo_analysis` counts
the latter where the instruction survives).  The port's `ragged_dot`
counts 2·M·K·N, so for the moe family the comparison adds (E - 1) times
the port's grouped-product FLOPs, forward and backward.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

#: One smoke config per family (the moe family twice: GQA and MLA with a
#: shared expert).
FAMILIES = ("gemma3-4b", "mixtral-8x7b", "deepseek-v2-lite-16b",
            "mamba2-2.7b", "zamba2-1.2b", "whisper-tiny")
KINDS = ("prefill", "decode")
B, S = 2, 32
TOL = 0.01


def _batch(cfg, dtype_i, dtype_e, s, labels, make):
    bt = {"tokens": make((B, s), dtype_i)}
    if labels:
        bt["labels"] = make((B, s), dtype_i)
    if cfg.n_vision_tokens:
        bt["vision_embeds"] = make((B, cfg.n_vision_tokens, cfg.d_model),
                                   dtype_e)
    if cfg.family == "encdec":
        bt["audio_embeds"] = make((B, cfg.enc_seq, cfg.d_model), dtype_e)
    return bt


def reference_dot_flops(arch: str, kind: str) -> float:
    cfg = ref_smoke(arch)
    params = RM.init_params(cfg, 0)

    def make(shape, dt):
        return jnp.zeros(shape, dt)
    if kind == "train":
        opt = RefAdamW()
        state = (params, opt.init(params), jnp.zeros((), jnp.int32))
        batch = _batch(cfg, jnp.int32, jnp.bfloat16,
                       S - cfg.n_vision_tokens, True, make)
        lowered = jax.jit(RM.make_train_step(cfg, opt)).lower(state, batch)
    else:
        cache = RM.init_cache(cfg, B, S)
        if kind == "prefill":
            batch = _batch(cfg, jnp.int32, jnp.bfloat16,
                           S - cfg.n_vision_tokens, False, make)
            step = RM.prefill_step
        else:
            batch = {"tokens": jnp.zeros((B, 1), jnp.int32)}
            step = RM.serve_step
        lowered = jax.jit(lambda p, b, c: step(cfg, p, b, c)).lower(
            params, batch, cache)
    return hlo_analysis.analyze(lowered.compile().as_text())["dot_flops"]


def port_count(arch: str, kind: str, device: str) -> dict:
    cfg = get_smoke_config(arch)
    dev = torch.device(device)
    model = T.build_model(cfg, device=dev) if device == "meta" else \
        M.init_params(cfg, 0, device=dev)

    def make(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)
    if kind == "train":
        model.requires_grad_()
        opt = AdamW()
        state = (model, opt.init(dict(model.named_parameters())),
                 torch.zeros((), dtype=torch.int32, device=dev))
        batch = _batch(cfg, torch.int32, torch.bfloat16,
                       S - cfg.n_vision_tokens, True, make)
        return op_analysis.analyze(M.make_train_step(cfg, opt), state,
                                   batch)
    cache = M.init_cache(cfg, B, S, device=dev)
    if kind == "prefill":
        batch = _batch(cfg, torch.int32, torch.bfloat16,
                       S - cfg.n_vision_tokens, False, make)
        return op_analysis.analyze(M.prefill_step, cfg, model, batch, cache)
    return op_analysis.analyze(M.serve_step, cfg, model,
                               {"tokens": make((B, 1), torch.int32)}, cache)


CASES = [(arch, kind) for arch in FAMILIES for kind in KINDS]


def check_against_the_reference(arch: str, kind: str) -> None:
    """The port's count on the CPU equals its count on meta, and is the
    reference's HLO count within `TOL` (the moe family's named
    rewrite added)."""
    cpu = port_count(arch, kind, "cpu")
    meta = port_count(arch, kind, "meta")
    assert cpu["dot_flops"] == meta["dot_flops"]
    assert cpu["kernels"].keys() <= meta["kernels"].keys()
    cfg = get_smoke_config(arch)
    got = meta["dot_flops"]
    if cfg.family == "moe":
        # XLA's CPU rewrite of ragged-dot (module docstring).
        grouped = sum(meta["kernels"].get(name, {}).get("dot_flops", 0.0)
                      for name in ("ragged_dot", "ragged_dot_bwd"))
        assert grouped > 0
        got += (cfg.n_experts - 1) * grouped
    want = reference_dot_flops(arch, kind)
    assert want > 0
    assert abs(got - want) <= TOL * want, (got, want)


@pytest.mark.parametrize("arch,kind", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_dot_flops_match_the_reference_hlo(arch, kind):
    check_against_the_reference(arch, kind)


def test_counter_counts_products_by_the_reference_rule():
    """2 · numel(result) · contracted size for every product, under
    autograd and under inference mode (where ``matmul`` and ``einsum``
    reach the counter whole and are counted by what they decompose
    into); views and ``empty`` move no bytes."""
    a = torch.ones(3, 5, 7)
    b = torch.ones(7, 4)
    want = 2.0 * 3 * 5 * 4 * 7
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            assert op_analysis.analyze(torch.matmul, a, b)[
                "dot_flops"] == want
            assert op_analysis.analyze(
                torch.einsum, "bsd,df->bsf", a, b)["dot_flops"] == want
    res = op_analysis.analyze(lambda: (a.view(15, 7) @ b, torch.empty(9)))
    assert res["dot_flops"] == 2.0 * 15 * 4 * 7
    assert res["hbm_bytes"] == 4.0 * (15 * 7 + 7 * 4 + 15 * 4)
    assert res["collective_counts"] == {k: 0 for k in
                                        op_analysis.COLLECTIVES}
    (top,) = res["counter"].top_ops(1)
    assert top[2] == "mm" and top[0] == res["hbm_bytes"]
