"""How far bf16 teacher-forced decoding drifts from the no-cache forward,
in the port and in the JAX package, at published widths.

mamba2-2.7b (cut to 4 of 64 layers) and deepseek-v2-lite-16b (cut to 2 of
27 layers) from the reference's weights (`repro.models.model.init_params(
cfg, 0)`, carried over by `convert.from_reference`): each package runs
its no-cache forward over a prompt of `PROMPT` tokens and `FORCED` more,
then prefills the prompt into a bf16 cache and decodes the `FORCED`
tokens one at a time, teacher-forced; the gap is the largest |logit|
difference between the two at the same position (the prompt's last and
each decoded one).  Everything computes in bf16, as served.  The reference
is compiled without XLA's excess precision (`_torch_compare.strict_jit`),
so its bf16 roundings are those its source writes.

The port's gap must be within twice the reference's: the cached and
uncached paths part by their own bf16 roundings in both packages (the
chunked scan over the prompt against the decode recurrence in fp32
state for mamba2; a bf16 cache and, for deepseek, top-6 routing near
ties), and a drift the reference shares is not a fault of the port.
``pytest -s -m slow tests/test_torch_decode_drift.py`` prints the
figures.  Slow: published widths on the CPU (deepseek's two layers hold
1.59e9 parameters, 6.4 GB in fp32, in each package).

At deepseek's two layers the reference's gap is exactly 0: XLA's CPU dot
sums each row alike whatever the rows beside it.  The port's was one
bf16 ulp (0.031 at logits of 4.5) while its CPU products took all their
rows at once: torch's float32 GEMM on the CPU picks its kernel and
blocking by the row count, so a row of a decode step (2 rows; a lone
query's attention scores; an expert's few rows) summed in another order
than the same row of the no-cache forward (80 rows).  The CPU products
now take their rows by fixed blocks (`kernels.row_blocks`); the tier-1
tests below hold a row's value to be the same whatever rows are beside
it (each fails with the products taken whole).
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from _torch_compare import strict_jit  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ragged_dot import ragged_dot  # noqa: E402
from repro_torch.models import attention, convert, layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PROMPT, FORCED, BATCH = 32, 8, 2
LAYERS = {"mamba2-2.7b": 4, "deepseek-v2-lite-16b": 2}


def _gaps(full, stepped) -> list:
    """Per compared position, max |stepped - full| over the batch and
    the vocabulary."""
    return [float(np.abs(s.astype(np.float32) -
                         full[:, i].astype(np.float32)).max())
            for i, s in enumerate(stepped)]


def _reference(ref_cfg, params, toks) -> tuple[list, float]:
    batch = {"tokens": jnp.asarray(toks)}
    full = np.asarray(strict_jit(lambda p, b: RT.forward(ref_cfg, p, b))(
        params, batch)[0], np.float32)[:, PROMPT - 1:]
    prefill = strict_jit(lambda p, b, c: RM.prefill_step(ref_cfg, p, b, c))
    decode = strict_jit(lambda p, b, c: RM.serve_step(ref_cfg, p, b, c))
    cache = RM.init_cache(ref_cfg, len(toks), PROMPT + FORCED,
                          dtype=jnp.bfloat16)
    logits, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                            cache)
    stepped = [np.asarray(logits[:, -1], np.float32)]
    for t in range(PROMPT, PROMPT + FORCED):
        _, logits, cache = decode(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cache)
        stepped.append(np.asarray(logits[:, -1], np.float32))
    return _gaps(full, stepped), float(np.abs(full).max())


def _port(cfg, model, toks) -> tuple[list, float]:
    with torch.no_grad():
        full = T.forward(cfg, model, {"tokens": toks})[0].float().numpy()
        full = full[:, PROMPT - 1:]
        cache = M.init_cache(cfg, len(toks), PROMPT + FORCED,
                             dtype=torch.bfloat16, device="cpu")
        logits, cache = M.prefill_step(cfg, model,
                                       {"tokens": toks[:, :PROMPT]}, cache)
        stepped = [logits[:, -1].float().numpy()]
        for t in range(PROMPT, PROMPT + FORCED):
            _, logits, cache = M.serve_step(
                cfg, model, {"tokens": toks[:, t:t + 1]}, cache)
            stepped.append(logits[:, -1].float().numpy())
    return _gaps(full, stepped), float(np.abs(full).max())


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(LAYERS))
def test_bf16_decode_drift_is_the_references(arch):
    cut = {"n_layers": LAYERS[arch]}
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **cut)
    cfg = dataclasses.replace(get_config(arch), **cut)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, PROMPT + FORCED)).astype(np.int32)
    params = RM.init_params(ref_cfg, 0)
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    port, port_max = _port(cfg, model, toks)
    del model
    gc.collect()
    ref, ref_max = _reference(ref_cfg, params, toks)
    print(f"\n{arch} at {LAYERS[arch]} layers, bf16, prompt {PROMPT}, "
          f"{FORCED} forced: teacher-forced against no-cache max |d| "
          f"port {max(port):.4g} (prefill {port[0]:.4g}; max |logit| "
          f"{port_max:.4g}), reference {max(ref):.4g} (prefill "
          f"{ref[0]:.4g}; max |logit| {ref_max:.4g}); by position port "
          f"{[round(g, 4) for g in port]}, reference "
          f"{[round(g, 4) for g in ref]}")
    assert all(np.isfinite(port)) and all(np.isfinite(ref))
    assert max(port) <= 2 * max(ref), (port, ref)


# ---- tier-1: a row's value does not depend on the rows beside it

ROWS = (1, 2, 3, 8, 31, 64, 65)


def test_cpu_dense_rows_do_not_depend_on_the_row_count():
    """`layers.dense` on bf16 rows at deepseek's K = 2048: each row's
    result is the same bits computed alone, with a few rows or with 300
    (torch's float32 GEMM on the CPU changes its kernel and blocking
    with the row count)."""
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(2048, 1408, generator=gen) * 0.02
    x = torch.randn(300, 2048, generator=gen).to(torch.bfloat16)
    full = layers.dense(w, None, x)
    for m in ROWS:
        assert torch.equal(layers.dense(w, None, x[:m]), full[:m]), m


def test_cpu_ragged_dot_rows_do_not_depend_on_the_group_size():
    """The MoE's grouped product on the CPU (`ragged_dot`'s plain
    version): a group's first rows give the same bits in a group of any
    size."""
    gen = torch.Generator().manual_seed(6)
    w = torch.randn(2, 2048, 1408, generator=gen) * 0.02
    x = torch.randn(300, 2048, generator=gen).to(torch.bfloat16)
    full = ragged_dot(x, w, torch.tensor([0, 300, 300], dtype=torch.int32))
    for m in ROWS:
        got = ragged_dot(x[:m], w, torch.tensor([0, m, m], dtype=torch.int32))
        assert torch.equal(got, full[:m]), m


def test_cpu_attention_rows_do_not_depend_on_the_query_count():
    """`attention.sdpa` on the CPU (its fp32 scores, `layers.scores`, and
    the weights' product with v): a query's output is the same bits alone
    or among 40 (a decode step against the no-cache forward), at
    deepseek's D = 192."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(2, 40, 4, 192, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(1, 1, 40, 40, dtype=torch.bool)
    full = attention.sdpa(q, k, v, mask)
    for i in (0, 17, 39):
        got = attention.sdpa(q[:, i:i + 1], k, v, mask[:, :, i:i + 1])
        assert torch.equal(got, full[:, i:i + 1]), i
