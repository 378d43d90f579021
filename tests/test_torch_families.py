"""The port's `ssm`, `dense`, `moe` and `encdec` families against the JAX
package, on the smoke configs of mamba2-2.7b, gemma3-4b, qwen1.5-4b,
glm4-9b, starcoder2-7b, mixtral-8x7b, deepseek-v2-lite-16b, whisper-tiny
and qwen2-vl-72b with the reference's own weights
(`repro.models.model.init_params(cfg, 0)`) carried over by
`repro_torch.models.convert.from_reference`.  whisper's frame embeddings
and qwen2-vl's patch embeddings are the same seeded bf16 arrays in both
packages (`_extras`).

Tolerances are the reference's own per family (tests/test_models.py:100,
``assert_allclose`` with atol = rtol): 0.15 for `ssm`, 3e-2 for `dense`
and `moe`, and the dense tolerance for `encdec`, which the reference's
test does not list.  Logits are computed in bf16 by both packages, and every
config's bf16 logits are held to its family's tolerance.

The yardstick is the reference compiled without XLA's excess precision
(``compiler_options={"xla_allow_excess_precision": False}``,
`_torch_compare.strict_jit`).  By default XLA may carry a chain of bf16
operations in fp32 and round once, dropping roundings the reference's
source writes: the default jitted reference parts from the reference's
own ops run one by one (``jax.disable_jit()``) by 0.116 on gemma3's
smoke logits, 0.280 on mamba2's and 0.029 on qwen1.5's, past the family
tolerance on the two tied-embedding configs (logits in the tens, where
one bf16 ulp of the last hidden state moves a logit by ~0.1).  Compiled
strictly it equals that eager run bit for bit on every smoke config
(`test_strict_compile_equals_the_eager_reference`), so it is the
reference's own rounding, and the eager port matches it.  fp32 compute
(both packages' dense layers, embeddings, tied unembeddings and MoE
products in float32) is held at 1e-4.  The teacher-forced prefill and
decode steps compare the port's steps with the reference's steps
compiled the same way.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from _torch_compare import fp32_compute, strict_jit  # noqa: E402
from repro.kernels.flash_attention import ops as ref_fa_ops  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, convert  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("mamba2-2.7b", "gemma3-4b", "qwen1.5-4b", "glm4-9b",
         "starcoder2-7b", "mixtral-8x7b", "deepseek-v2-lite-16b",
         "whisper-tiny", "qwen2-vl-72b")
MOE_ARCHS = ("mixtral-8x7b", "deepseek-v2-lite-16b")
FAMILY_TOL = {"ssm": 0.15, "dense": 3e-2, "moe": 3e-2, "encdec": 3e-2}
FP32_TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One arch's smoke config in both packages, the reference's weights
    in both, and the reference's forward and its prefill and decode
    steps, each compiled without excess precision."""
    arch = request.param
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    params = RM.init_params(ref_cfg, 0)
    return types.SimpleNamespace(
        arch=arch, ref_cfg=ref_cfg, cfg=cfg, params=params,
        model=convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu"),
        tol=FAMILY_TOL[cfg.family], steps=_ref_steps(ref_cfg),
        forward=_ref_forward(ref_cfg))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _extras(cfg, b, seed=0) -> tuple[dict, dict]:
    """(the port's batch entries, the reference's) of the arch's stub
    embeddings for ``b`` sequences: numpy standard normals times 0.1
    (the reference's ``make_batch`` scale) rounded to bf16 by both
    packages, ``audio_embeds`` for encdec and ``vision_embeds`` for a
    vision arch; empty for the others."""
    if cfg.family == "encdec":
        name, n = "audio_embeds", cfg.enc_seq
    elif cfg.n_vision_tokens:
        name, n = "vision_embeds", cfg.n_vision_tokens
    else:
        return {}, {}
    x = np.random.default_rng(100 + seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32) * np.float32(0.1)
    return ({name: torch.from_numpy(x).to(torch.bfloat16)},
            {name: jnp.asarray(x, jnp.bfloat16)})


def _step_extras(cfg, extras: dict) -> dict:
    """What a decode step takes of ``extras``: encdec's audio again (the
    reference's WaveServer passes it; the step ignores it), nothing of a
    vision prefix."""
    return extras if cfg.family == "encdec" else {}


def _ratio(got, want, tol) -> float:
    """The worst |got - want| / (tol + tol |want|): at most 1 where
    ``assert_allclose(got, want, atol=tol, rtol=tol)`` holds."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


def _margin(logits) -> np.ndarray:
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _hold_bf16(fam, got, want, what: str) -> None:
    """bf16 logits within the family tolerance."""
    ratio = _ratio(got, want, fam.tol)
    print(f"{fam.arch} {what} bf16: |d| / (tol + tol |want|) {ratio:.3f}")
    assert ratio <= 1.0, what


def test_config_is_copied_field_for_field(fam):
    assert dataclasses.asdict(fam.cfg) == dataclasses.asdict(fam.ref_cfg)
    assert dataclasses.asdict(get_config(fam.arch)) == dataclasses.asdict(
        ref_configs.get_config(fam.arch))


def test_conversion_round_trips_bit_for_bit(fam):
    tree = jax.tree.map(np.asarray, fam.params)
    back = convert.to_reference(fam.cfg, fam.model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ("unembed" in back) == (not fam.cfg.tie_embeddings)


def test_seeded_init_counts_like_the_reference(fam):
    m = M.init_params(fam.cfg, 0, device="cpu")
    again = M.init_params(fam.cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))
    assert not any(p.requires_grad for p in m.parameters())
    assert M.count_params(fam.cfg) == RM.count_params(fam.ref_cfg) == \
        sum(p.numel() for p in m.parameters())
    big = get_config(fam.arch)
    assert M.count_params(big) == RM.count_params(
        ref_configs.get_config(fam.arch))
    extras, _ = _extras(fam.cfg, 2)
    logits, _, _ = T.forward(fam.cfg, m, {"tokens": _tokens(fam.cfg, 2, 16),
                                          **extras})
    assert logits.shape == (2, fam.cfg.n_vision_tokens + 16, fam.cfg.vocab)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_cache_specs(fam, dtype):
    """Every tensor leaf has the spec's shape and type; each ``pos``
    (a Python int, or a list of them where the spec has a layer axis)
    has the spec's shape and starts at 0."""
    specs = RM.cache_specs(fam.ref_cfg, 3, 24, getattr(jnp, dtype))
    cache = M.init_cache(fam.cfg, 3, 24, getattr(torch, dtype),
                         device="cpu")

    def leaves(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", val

    got, want = dict(leaves(cache)), dict(leaves(specs))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        leaf = got[name]
        if name.split(".")[-1] == "pos":
            assert spec.dtype == jnp.int32
            assert np.shape(leaf) == spec.shape and not np.any(leaf)
        else:
            assert tuple(leaf.shape) == spec.shape, name
            assert str(leaf.dtype).split(".")[1] == str(spec.dtype), name
            assert not leaf.any()


def test_no_cache_forward_matches_reference(fam, monkeypatch):
    toks = _tokens(fam.cfg, 2, 32)
    extras, ref_extras = _extras(fam.cfg, 2)
    ref_batch = {"tokens": jnp.asarray(toks), **ref_extras}
    want, want_aux, _ = fam.forward(fam.params, ref_batch)
    got, aux, _ = T.forward(fam.cfg, fam.model, {"tokens": toks, **extras})
    _hold_bf16(fam, got.numpy(), want, "no-cache forward")
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    fp32_compute(monkeypatch)
    want, _, _ = _ref_forward(fam.ref_cfg)(fam.params, ref_batch)
    got, _, _ = T.forward(fam.cfg, fam.model, {"tokens": toks, **extras})
    ratio = _ratio(got.numpy(), want, FP32_TOL)
    print(f"{fam.arch} no-cache forward fp32: ratio {ratio:.3f} at "
          f"{FP32_TOL}")
    assert ratio <= 1.0


def _ref_steps(ref_cfg):
    """The reference's prefill and decode steps, jitted (as its
    WaveServer does) and compiled without excess precision.  A compiled
    step keeps the compute type it was traced with, so fp32 compute takes
    a fresh pair."""
    return (strict_jit(lambda p, b, c: RM.prefill_step(ref_cfg, p, b, c)),
            strict_jit(lambda p, b, c: RM.serve_step(ref_cfg, p, b, c)))


def _ref_forward(ref_cfg):
    """The reference's no-cache forward, compiled without excess
    precision."""
    return strict_jit(lambda p, b: RT.forward(ref_cfg, p, b))


def test_strict_compile_equals_the_eager_reference(fam):
    """The yardstick: the reference compiled without excess precision
    equals its own ops run one by one, bit for bit, for the no-cache
    forward and a prefill step."""
    batch = {"tokens": jnp.asarray(_tokens(fam.cfg, 2, 24)),
             **_extras(fam.cfg, 2)[1]}
    cache = RM.init_cache(fam.ref_cfg, 2, fam.cfg.n_vision_tokens + 28)
    want = fam.forward(fam.params, batch)[0]
    pre = fam.steps[0](fam.params, batch, cache)[0]
    with jax.disable_jit():
        eager = RT.forward(fam.ref_cfg, fam.params, batch)[0]
        eager_pre = RM.prefill_step(fam.ref_cfg, fam.params, batch,
                                    cache)[0]
    assert np.array_equal(np.asarray(want), np.asarray(eager))
    assert np.array_equal(np.asarray(pre), np.asarray(eager_pre))


def _teacher_forced(fam, cache_dtype, steps):
    """Prefill 8 tokens, then decode 4 teacher-forced ones, in both
    packages (the reference's through ``steps``); returns the pairs of
    last-position logits."""
    prefill, decode = steps
    b, s = 1, 12
    tv = fam.cfg.n_vision_tokens
    toks = _tokens(fam.cfg, b, s, seed=1)
    extras, ref_extras = _extras(fam.cfg, b)
    rc = RM.init_cache(fam.ref_cfg, b, tv + s + 4,
                       dtype=getattr(jnp, cache_dtype))
    tc = M.init_cache(fam.cfg, b, tv + s + 4,
                      dtype=getattr(torch, cache_dtype), device="cpu")
    want, rc = prefill(fam.params, {"tokens": jnp.asarray(toks[:, :8]),
                                    **ref_extras}, rc)
    got, tc = M.prefill_step(fam.cfg, fam.model,
                             {"tokens": toks[:, :8], **extras}, tc)
    pairs = [(got[:, -1].numpy(), np.asarray(want[:, -1]))]
    for t in range(8, s):
        step = toks[:, t:t + 1]
        _, want, rc = decode(fam.params, {
            "tokens": jnp.asarray(step),
            **_step_extras(fam.cfg, ref_extras)}, rc)
        nxt, got, tc = M.serve_step(fam.cfg, fam.model, {
            "tokens": step, **_step_extras(fam.cfg, extras)}, tc)
        assert nxt.dtype == torch.int32 and nxt.shape == (b, 1)
        pairs.append((got[:, -1].numpy(), np.asarray(want[:, -1])))
    assert tc["pos"] == tv + s
    if fam.cfg.family in ("dense", "moe", "encdec"):
        assert tc["layers"]["pos"] == [tv + s] * fam.cfg.n_layers
    return pairs


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(fam, cache_dtype):
    """Teacher-forced `prefill_step` + `serve_step` logits against the
    reference's jitted steps, by the rules of the module docstring."""
    for i, (got, want) in enumerate(_teacher_forced(fam, cache_dtype,
                                                    fam.steps)):
        _hold_bf16(fam, got, want, f"step {i} ({cache_dtype} cache)")


def test_prefill_and_decode_match_reference_in_fp32(fam, monkeypatch):
    fp32_compute(monkeypatch)
    ratios = [_ratio(got, want, FP32_TOL)
              for got, want in _teacher_forced(fam, "float32",
                                               _ref_steps(fam.ref_cfg))]
    print(f"{fam.arch} prefill/decode fp32: ratio {max(ratios):.3f}")
    assert max(ratios) <= 1.0


def test_wave_server_produces_the_reference_tokens(fam):
    """Token by token the port's greedy tokens equal the reference
    WaveServer's; a difference is allowed only where the reference's
    top-2 margin is within twice the family tolerance, and the row is
    not compared past it (the two sequences part there)."""
    slots, max_new = 4, 8
    s_max = fam.cfg.n_vision_tokens + 32
    prompts = _tokens(fam.cfg, 5, 12, seed=2)
    extras, ref_extras = _extras(fam.cfg, slots, seed=2)
    server = serve.WaveServer(fam.cfg, fam.model, slots=slots, s_max=s_max)
    compared = 0
    for lo in range(0, len(prompts), slots):
        wave = prompts[lo:lo + slots]
        got = server.run_wave(wave, max_new, extras)
        want, margins = _ref_wave(fam, wave, max_new, slots, s_max,
                                  ref_extras)
        assert got.shape == want.shape == (len(wave), max_new)
        for row in range(len(wave)):
            for t in range(max_new):
                if got[row, t] != want[row, t]:
                    assert margins[row, t] <= 2 * fam.tol, (row, t)
                    break
                compared += 1
    assert compared >= len(prompts) * max_new // 2


def _ref_wave(fam, prompts, max_new, slots, s_max, extras):
    """The reference's `WaveServer.run_wave` step by step, keeping each
    step's top-2 margins."""
    b = prompts.shape[0]
    toks = np.pad(prompts, ((0, slots - b), (0, 0)))
    cache = RM.init_cache(fam.ref_cfg, slots, s_max)
    prefill, decode = fam.steps
    logits, cache = prefill(fam.params, {"tokens": jnp.asarray(toks),
                                         **extras}, cache)
    nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
    out, margins = [np.asarray(nxt)], [_margin(logits[:, -1, :])]
    for _ in range(max_new - 1):
        nxt2, logits, cache = decode(fam.params, {
            "tokens": nxt[:, None], **_step_extras(fam.cfg, extras)}, cache)
        nxt = nxt2[:, 0]
        out.append(np.asarray(nxt))
        margins.append(_margin(logits[:, -1, :]))
    return np.stack(out, 1)[:b], np.stack(margins, 1)[:b]


def test_transfer_rounds_match_reference(fam):
    for cfg, ref_cfg in ((fam.cfg, fam.ref_cfg),
                         (get_config(fam.arch),
                          ref_configs.get_config(fam.arch))):
        for batch, seq in ((4, 48), (2, 1032)):
            assert serve.serving_transfer_rounds(
                cfg, batch=batch, seq=seq) == \
                ref_serve.serving_transfer_rounds(ref_cfg, batch=batch,
                                                  seq=seq)


def test_serve_main_runs_on_the_cpu(fam, capsys):
    outs = serve.main(["--arch", fam.arch, "--device", "cpu", "--requests",
                       "3", "--gen", "4", "--prompt-len", "8", "--slots",
                       "2"])
    assert [o.shape for o in outs] == [(2, 4), (1, 4)]
    assert "bandwidth round" in capsys.readouterr().out


def test_gemma3_flash_path_with_windows_matches_reference(monkeypatch):
    """gemma3's smoke config at S = 4160 > 4096: every layer takes the
    flash path in both packages, the local layers with window 8 and the
    global ones (every second) plain causal.  In fp32 compute the logits
    agree at 1e-4; in bf16 the argmax agrees wherever the reference's
    top-2 margin exceeds twice the dense tolerance."""
    arch = "gemma3-4b"
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), get_smoke_config(arch)
    params = RM.init_params(ref_cfg, 0)
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    windows = {"ref": [], "port": []}
    ref_fa, port_fa = ref_fa_ops.flash_attention, \
        attention.fa_ops.flash_attention

    def spy(name, fn):
        def wrapped(*a, **kw):
            windows[name].append(kw.get("window"))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ref_fa_ops, "flash_attention", spy("ref", ref_fa))
    monkeypatch.setattr(attention.fa_ops, "flash_attention",
                        spy("port", port_fa))
    toks = _tokens(cfg, 1, 4160, seed=3)
    want, _, _ = RT.forward(ref_cfg, params, {"tokens": jnp.asarray(toks)})
    got, _, _ = T.forward(cfg, model, {"tokens": toks})
    want = np.asarray(want)
    assert windows["port"] == [8, 0, 8, 0]
    assert len(windows["ref"]) == 1        # traced once inside the scan
    clear = _margin(want[0]) > 2 * FAMILY_TOL["dense"]
    agree = got[0].numpy().argmax(-1) == want[0].argmax(-1)
    print(f"gemma3 bf16 forward, S=4160: {clear.sum()} clear rows, "
          f"max |logit err| {np.abs(got.numpy() - want).max():.4f}")
    assert clear.sum() > 1000 and agree[clear].all()

    fp32_compute(monkeypatch)
    want, _, _ = RT.forward(ref_cfg, params, {"tokens": jnp.asarray(toks)})
    got, _, _ = T.forward(cfg, model, {"tokens": toks})
    ratio = _ratio(got.numpy(), want, FP32_TOL)
    print(f"gemma3 fp32 forward, S=4160: ratio {ratio:.3f} at {FP32_TOL}")
    assert len(windows["port"]) == 8
    assert ratio <= 1.0


def _pair(arch):
    """(reference config, port config, reference params, port model) of
    ``arch``'s smoke config, with the reference's weights in both."""
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), get_smoke_config(arch)
    params = RM.init_params(ref_cfg, 0)
    return ref_cfg, cfg, params, convert.from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


def test_qwen2_vl_flash_path_with_mrope_matches_reference(monkeypatch):
    """qwen2-vl's smoke config at S = 4160 > 4096 (its 16 patch
    embeddings and 4144 tokens): every layer takes the flash path in both
    packages, with M-RoPE applied to q and k before it.  In fp32 compute
    the logits agree at 1e-4; in bf16 the argmax agrees wherever the
    reference's top-2 margin exceeds twice the dense tolerance."""
    ref_cfg, cfg, params, model = _pair("qwen2-vl-72b")
    calls = {"ref": 0, "port": 0}
    ref_fa, port_fa = ref_fa_ops.flash_attention, \
        attention.fa_ops.flash_attention

    def spy(name, fn):
        def wrapped(q, *a, **kw):
            calls[name] += 1
            assert q.shape[1] == 4160 and kw.get("window") is None
            return fn(q, *a, **kw)
        return wrapped

    monkeypatch.setattr(ref_fa_ops, "flash_attention", spy("ref", ref_fa))
    monkeypatch.setattr(attention.fa_ops, "flash_attention",
                        spy("port", port_fa))
    toks = _tokens(cfg, 1, 4160 - cfg.n_vision_tokens, seed=3)
    extras, ref_extras = _extras(cfg, 1, seed=3)
    ref_batch = {"tokens": jnp.asarray(toks), **ref_extras}
    want, _, _ = RT.forward(ref_cfg, params, ref_batch)
    got, _, _ = T.forward(cfg, model, {"tokens": toks, **extras})
    want = np.asarray(want)
    assert got.shape == (1, 4160, cfg.vocab)
    assert calls["port"] == cfg.n_layers
    assert calls["ref"] == 1               # traced once inside the scan
    clear = _margin(want[0]) > 2 * FAMILY_TOL["dense"]
    agree = got[0].numpy().argmax(-1) == want[0].argmax(-1)
    print(f"qwen2-vl bf16 forward, S=4160: {clear.sum()} clear rows, "
          f"max |logit err| {np.abs(got.numpy() - want).max():.4f}")
    assert clear.sum() > 1000 and agree[clear].all()

    fp32_compute(monkeypatch)
    want, _, _ = RT.forward(ref_cfg, params, ref_batch)
    got, _, _ = T.forward(cfg, model, {"tokens": toks, **extras})
    ratio = _ratio(got.numpy(), want, FP32_TOL)
    print(f"qwen2-vl fp32 forward, S=4160: ratio {ratio:.3f} at {FP32_TOL}")
    assert calls["port"] == 2 * cfg.n_layers
    assert ratio <= 1.0


def test_whisper_serving_never_runs_the_encoder():
    """A reference quirk both packages keep: the served cache's
    ``cross_kv`` is zeros and not None, so a cached prefill skips the
    encoder and cross-attends to zeros.  Its logits are the same bits for
    two different ``audio_embeds`` in each package, and ``cross_kv``
    stays zero; the no-cache forward does read the audio."""
    ref_cfg, cfg, params, model = _pair("whisper-tiny")
    toks = _tokens(cfg, 2, 8, seed=4)
    prefill = strict_jit(lambda p, b, c: RM.prefill_step(ref_cfg, p, b, c))
    outs = {"ref": [], "port": [], "ref_full": [], "port_full": []}
    for seed in (0, 1):
        extras, ref_extras = _extras(cfg, 2, seed=seed)
        logits, rc = prefill(params, {"tokens": jnp.asarray(toks),
                                      **ref_extras},
                             RM.init_cache(ref_cfg, 2, 12))
        outs["ref"].append(np.asarray(logits))
        assert not np.any(np.asarray(rc["cross_kv"]["k"]))
        assert not np.any(np.asarray(rc["cross_kv"]["v"]))
        logits, tc = M.prefill_step(cfg, model, {"tokens": toks, **extras},
                                    M.init_cache(cfg, 2, 12, device="cpu"))
        outs["port"].append(logits.numpy())
        assert not tc["cross_kv"]["k"].any() and not tc["cross_kv"]["v"].any()
        outs["ref_full"].append(np.asarray(RT.forward(
            ref_cfg, params, {"tokens": jnp.asarray(toks),
                              **ref_extras})[0]))
        outs["port_full"].append(T.forward(
            cfg, model, {"tokens": toks, **extras})[0].numpy())
    for name in ("ref", "port"):
        assert np.array_equal(*outs[name]), name
        assert not np.array_equal(*outs[f"{name}_full"]), name


def test_qwen2_vl_decode_positions_jump_in_both_packages(monkeypatch):
    """A reference quirk both packages keep: a prefill places the 4x4
    patch grid at t = 0 and continues the text from 4, but a decode step
    gives all three M-RoPE streams the absolute position (16 patches +
    the tokens so far), so teacher-forced decode logits part from the
    no-cache forward's.  In fp32 compute the parting is the same in both
    packages within the dense tolerance (atol = rtol), and well past
    it."""
    fp32_compute(monkeypatch)
    ref_cfg, cfg, params, model = _pair("qwen2-vl-72b")
    tv, n = cfg.n_vision_tokens, 12
    toks = _tokens(cfg, 1, n, seed=5)
    extras, ref_extras = _extras(cfg, 1, seed=5)
    prefill, decode = _ref_steps(ref_cfg)
    partings = {}
    full = {"ref": np.asarray(_ref_forward(ref_cfg)(params, {
                "tokens": jnp.asarray(toks), **ref_extras})[0]),
            "port": T.forward(cfg, model, {"tokens": toks,
                                           **extras})[0].numpy()}
    rc = RM.init_cache(ref_cfg, 1, tv + n, dtype=jnp.float32)
    tc = M.init_cache(cfg, 1, tv + n, dtype=torch.float32, device="cpu")
    _, rc = prefill(params, {"tokens": jnp.asarray(toks[:, :8]),
                             **ref_extras}, rc)
    _, tc = M.prefill_step(cfg, model, {"tokens": toks[:, :8], **extras}, tc)
    steps = {"ref": [], "port": []}
    for t in range(8, n):
        _, logits, rc = decode(params, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, rc)
        steps["ref"].append(np.asarray(logits)[0, -1])
        steps["port"].append(M.serve_step(
            cfg, model, {"tokens": toks[:, t:t + 1]}, tc)[1][0, -1].numpy())
    for name in ("ref", "port"):
        partings[name] = np.stack(steps[name]) - full[name][0, tv + 8:tv + n]
    tol = FAMILY_TOL["dense"]
    print(f"qwen2-vl decode parting: ref {np.abs(partings['ref']).max():.3f}"
          f", port {np.abs(partings['port']).max():.3f}")
    assert _ratio(partings["ref"], 0 * partings["ref"], tol) > 1.0
    assert _ratio(partings["port"], partings["ref"], tol) <= 1.0


@pytest.mark.parametrize("arch,knob", [
    ("mixtral-8x7b", {"moe_impl": "capacity"}),
    ("deepseek-v2-lite-16b", {"moe_impl": "capacity"}),
    ("deepseek-v2-lite-16b", {"mla_absorbed": True})])
def test_moe_knobs_match_reference(arch, knob):
    """The capacity dispatch (``moe_impl="capacity"``) and MLA's absorbed
    decode (``mla_absorbed``): the no-cache forward, its aux loss and the
    teacher-forced prefill and decode steps against the reference's with
    the same knob, in bf16 at the family tolerance."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **knob)
    cfg = dataclasses.replace(get_smoke_config(arch), **knob)
    params = RM.init_params(ref_cfg, 0)
    fam = types.SimpleNamespace(
        arch=arch, ref_cfg=ref_cfg, cfg=cfg, params=params,
        model=convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu"),
        tol=FAMILY_TOL["moe"], steps=_ref_steps(ref_cfg))
    toks = _tokens(cfg, 2, 32)
    want, want_aux, _ = _ref_forward(ref_cfg)(params,
                                              {"tokens": jnp.asarray(toks)})
    got, aux, _ = T.forward(cfg, fam.model, {"tokens": toks})
    _hold_bf16(fam, got.numpy(), want, f"{knob} no-cache forward")
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    for i, (g, w) in enumerate(_teacher_forced(fam, "bfloat16", fam.steps)):
        _hold_bf16(fam, g, w, f"{knob} step {i}")
