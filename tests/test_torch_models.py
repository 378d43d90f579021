"""The port's zamba2 model against the JAX package, on zamba2's
SMOKE_CONFIG with the reference's own weights
(`repro.models.model.init_params(cfg, 0)`) carried over by
`repro_torch.models.convert.from_reference`.

Tolerances.  Logits are computed in bf16 by both packages (dense layers
in bf16, logits cast to fp32), so they are held to the reference's
hybrid tolerance of 0.15 (tests/test_models.py:100), the ceiling for
logits; the max errors measured here are 0.07-0.10.  The S = 4160
forward, which takes the flash path, is held in fp32 compute (both
packages' ``dense`` and ``embed`` defaults set to float32, as the
hopper-kernels practice of comparing the algorithm in fp32) at 1e-4
(measured 1.1e-5); in bf16 at that length the two packages' roundings
part by up to 0.3 in a few of the million logits (99.9% within 0.07),
so there the test holds the argmax wherever the reference's top-2
margin exceeds twice the 0.15 tolerance, as it does for WaveServer's
tokens.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as ref_layers  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels.flash_attention import ops as ref_fa_ops  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from _torch_compare import strict_jit  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "zamba2-1.2b"
LOGIT_TOL = 0.15


@pytest.fixture(scope="module")
def ref_cfg():
    return ref_smoke(ARCH)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def ref_params(ref_cfg):
    return RM.init_params(ref_cfg, 0)


@pytest.fixture(scope="module")
def ref_steps(ref_cfg):
    """The reference's prefill and decode steps, jitted once for the
    module (the reference's WaveServer jits them the same way) and
    compiled without excess precision (`_torch_compare.strict_jit`)."""
    return (strict_jit(lambda p, b, c: RM.prefill_step(ref_cfg, p, b, c)),
            strict_jit(lambda p, b, c: RM.serve_step(ref_cfg, p, b, c)))


@pytest.fixture(scope="module")
def model(cfg, ref_params):
    return convert.from_reference(cfg, jax.tree.map(np.asarray, ref_params),
                                  device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) -
                        np.asarray(b, np.float32)).max())


def test_config_is_copied_field_for_field(ref_cfg, cfg):
    ref_fields = [(f.name, f.default) for f in
                  dataclasses.fields(RT.ModelConfig)]
    fields = [(f.name, f.default) for f in dataclasses.fields(T.ModelConfig)]
    assert fields == ref_fields
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        __import__("repro.configs", fromlist=["x"]).get_config(ARCH))


def test_conversion_round_trips_bit_for_bit(cfg, ref_params, model):
    tree = jax.tree.map(np.asarray, ref_params)
    back = convert.to_reference(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_the_shared_block_is_one_module(ref_cfg, cfg, model):
    blocks = [m for m in model.modules() if isinstance(m, T.Block)]
    assert blocks == [model.shared_attn]
    assert T.n_hybrid_attn_invocations(cfg) == \
        RT.n_hybrid_attn_invocations(ref_cfg) == 2
    assert M.count_params(cfg) == RM.count_params(ref_cfg) == \
        sum(p.numel() for p in model.parameters())
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    assert cache["layers"]["attn"]["k"].shape[0] == 2


def test_seeded_init_runs_and_counts_like_the_reference(cfg):
    m = M.init_params(cfg, 0, device="cpu")
    again = M.init_params(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))
    assert not any(p.requires_grad for p in m.parameters())
    logits, _, _ = T.forward(cfg, m, {"tokens": _tokens(cfg, 2, 16)})
    assert logits.shape == (2, 16, cfg.vocab)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_no_cache_forward_matches_reference(ref_cfg, cfg, ref_params,
                                            model):
    toks = _tokens(cfg, 2, 32)
    want, _, _ = RT.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(toks)})
    got, _, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    err = _max_err(got.numpy(), want)
    print(f"no-cache forward, S=32: max |logit err| {err:.4f}")
    assert err <= LOGIT_TOL


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_cfg, cfg, ref_params,
                                            ref_steps, model, cache_dtype):
    """Teacher-forced `prefill_step` + `serve_step` logits equal the
    reference's at every step, and the reference's no-cache forward."""
    b, s = 1, 12
    toks = _tokens(cfg, b, s, seed=1)
    full, _, _ = RT.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(toks)})
    full = np.asarray(full)
    rc = RM.init_cache(ref_cfg, b, s + 4, dtype=getattr(jnp, cache_dtype))
    tc = M.init_cache(cfg, b, s + 4, dtype=getattr(torch, cache_dtype),
                      device="cpu")
    ref_prefill, ref_decode = ref_steps
    want, rc = ref_prefill(ref_params, {"tokens": jnp.asarray(toks[:, :8])},
                           rc)
    got, tc = M.prefill_step(cfg, model,
                             {"tokens": torch.from_numpy(toks[:, :8])}, tc)
    errs = [_max_err(got[:, -1].numpy(), want[:, -1]),
            _max_err(got[:, -1].numpy(), full[:, 7])]
    assert tc["pos"] == 8 and tc["layers"]["attn"]["pos"] == [8, 8]
    for t in range(8, s):
        step = toks[:, t:t + 1]
        _, want, rc = ref_decode(ref_params, {"tokens": jnp.asarray(step)},
                                 rc)
        nxt, got, tc = M.serve_step(cfg, model,
                                    {"tokens": torch.from_numpy(step)}, tc)
        errs.append(_max_err(got[:, -1].numpy(), want[:, -1]))
        if t + 1 < s:
            errs.append(_max_err(got[:, -1].numpy(), full[:, t]))
        assert nxt.dtype == torch.int32 and nxt.shape == (b, 1)
    print(f"prefill/decode ({cache_dtype} cache): max |logit err| "
          f"{max(errs):.4f}")
    assert max(errs) <= LOGIT_TOL
    assert tc["pos"] == s


def _ref_wave_tokens(ref_cfg, ref_steps, params, prompts, max_new, slots,
                     s_max):
    """The reference's `WaveServer.run_wave`, step by step, keeping each
    step's logits for the top-2 margins."""
    ref_prefill, ref_decode = ref_steps
    b = prompts.shape[0]
    toks = np.pad(prompts, ((0, slots - b), (0, 0)))
    cache = RM.init_cache(ref_cfg, slots, s_max)
    logits, cache = ref_prefill(params, {"tokens": jnp.asarray(toks)}, cache)
    nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
    out, margins = [np.asarray(nxt)], [_margin(logits[:, -1, :])]
    for _ in range(max_new - 1):
        nxt2, logits, cache = ref_decode(params, {"tokens": nxt[:, None]},
                                         cache)
        nxt = nxt2[:, 0]
        out.append(np.asarray(nxt))
        margins.append(_margin(logits[:, -1, :]))
    return np.stack(out, 1)[:b], np.stack(margins, 1)[:b]


def _margin(logits) -> np.ndarray:
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_wave_server_produces_the_reference_tokens(ref_cfg, cfg,
                                                   ref_params, ref_steps,
                                                   model):
    """Token by token the port's greedy tokens equal the reference's;
    a difference is allowed only where the reference's top-2 margin is
    within twice the logit tolerance, and the row is not compared past
    it (the two sequences part there)."""
    slots, s_max, max_new = 4, 40, 12
    prompts = _tokens(cfg, 6, 16, seed=2)
    server = serve.WaveServer(cfg, model, slots=slots, s_max=s_max)
    compared = 0
    for lo in range(0, len(prompts), slots):
        wave = prompts[lo:lo + slots]
        got = server.run_wave(wave, max_new)
        want, margins = _ref_wave_tokens(ref_cfg, ref_steps, ref_params,
                                         wave, max_new, slots, s_max)
        if lo == 0:     # the step-by-step loop is the reference's own
            ref_server = ref_serve.WaveServer(ref_cfg, ref_params,
                                              slots=slots, s_max=s_max)
            assert np.array_equal(ref_server.run_wave(wave, max_new), want)
        assert got.shape == want.shape == (len(wave), max_new)
        for row in range(len(wave)):
            for t in range(max_new):
                if got[row, t] != want[row, t]:
                    assert margins[row, t] <= 2 * LOGIT_TOL, (row, t)
                    break
                compared += 1
    assert compared >= len(prompts) * max_new // 2


def test_flash_path_forward_matches_reference(ref_cfg, cfg, ref_params,
                                              model, monkeypatch):
    """S = 4160 > 4096: both packages' `_flash_or_sdpa` take the flash
    path (the port's through `kernels.flash_attention`, its plain version
    on the CPU).  In fp32 compute the logits agree at 1e-4; in bf16 the
    argmax agrees wherever the reference's margin exceeds 0.3."""
    calls = {"ref": 0, "port": 0}
    ref_fa, port_fa = ref_fa_ops.flash_attention, \
        attention.fa_ops.flash_attention

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ref_fa_ops, "flash_attention",
                        count("ref", ref_fa))
    monkeypatch.setattr(attention.fa_ops, "flash_attention",
                        count("port", port_fa))
    toks = _tokens(cfg, 1, 4160, seed=3)

    want, _, _ = RT.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(toks)})
    got, _, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want)
    n_inv = T.n_hybrid_attn_invocations(cfg)
    assert calls == {"ref": n_inv, "port": n_inv}
    margin = _margin(want[0])
    agree = got[0].numpy().argmax(-1) == want[0].argmax(-1)
    print(f"bf16 forward, S=4160: max |logit err| "
          f"{_max_err(got.numpy(), want):.4f}")
    assert agree[margin > 2 * LOGIT_TOL].all()

    monkeypatch.setitem(ref_layers.dense.__kwdefaults__, "compute_dtype",
                        jnp.float32)
    monkeypatch.setattr(ref_layers.embed, "__defaults__", (jnp.float32,))
    monkeypatch.setitem(L.dense.__kwdefaults__, "compute_dtype",
                        torch.float32)
    monkeypatch.setattr(L.embed, "__defaults__", (torch.float32,))
    want, _, _ = RT.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(toks)})
    got, _, _ = T.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    err = _max_err(got.numpy(), want)
    print(f"fp32 forward, S=4160: max |logit err| {err:.2e}")
    assert calls == {"ref": 2 * n_inv, "port": 2 * n_inv}
    assert err <= 1e-4


def test_transfer_rounds_match_reference(ref_cfg, cfg):
    for batch, seq in ((4, 48), (2, 1032)):
        want = ref_serve.serving_transfer_rounds(ref_cfg, batch=batch,
                                                 seq=seq)
        assert serve.serving_transfer_rounds(cfg, batch=batch,
                                             seq=seq) == want
    from repro.core import planner as ref_planner
    from repro.launch.mesh import mesh_stub as ref_mesh_stub
    from repro_torch.core import planner
    from repro_torch.launch.mesh import mesh_stub
    big = get_config(ARCH)
    for kind in ("train", "decode"):
        want = ref_planner.plan(big, kind, 4096, 256,
                                ref_mesh_stub({"data": 16, "model": 16}))
        got = planner.plan(big, kind, 4096, 256,
                           mesh_stub({"data": 16, "model": 16}))
        assert got.summary() == want.summary()


@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_kv_cache_overflow_raises(ref_cfg, cfg, ref_params, model, where):
    """A write past the cache's s_max: a second prefill of 3 tokens after
    6, or a decode step after 8, into a cache of 8.  The port raises
    ValueError; the reference's `dynamic_update_slice` clamps the write's
    start and goes on silently.  The port keeps the stronger contract, a
    deliberate difference."""
    s_max, first = 8, 6 if where == "prefill" else 8
    toks = _tokens(cfg, 1, s_max + 1, seed=3)
    cache = M.init_cache(cfg, 1, s_max, device="cpu")
    _, cache = M.prefill_step(
        cfg, model, {"tokens": torch.from_numpy(toks[:, :first])}, cache)
    rc = RM.init_cache(ref_cfg, 1, s_max)
    _, rc = RM.prefill_step(ref_cfg, ref_params,
                            {"tokens": jnp.asarray(toks[:, :first])}, rc)
    rest = {"tokens": toks[:, first:]}
    step = M.prefill_step if where == "prefill" else M.serve_step
    ref_step = RM.prefill_step if where == "prefill" else RM.serve_step
    with pytest.raises(ValueError, match="KV cache holds 8"):
        step(cfg, model, {"tokens": torch.from_numpy(rest["tokens"])}, cache)
    out = ref_step(ref_cfg, ref_params,
                   {"tokens": jnp.asarray(rest["tokens"])}, rc)
    logits = out[0] if where == "prefill" else out[1]
    assert np.isfinite(np.asarray(logits)).all()   # the reference clamps


def test_unported_parts_raise_not_implemented(cfg, ref_cfg):
    """Every family builds and runs, the `encdec` family and vision
    inputs with M-RoPE included, and every arch's config is ported; the
    dry run's `input_specs` is ported too and gives the reference's
    shapes and types (training is ported:
    `test_loss_and_train_step_run`; every cell's specs:
    `tests/test_torch_dryrun.py`)."""
    from repro_torch.configs import ARCHS, input_specs
    dense = T.ModelConfig(name="d", family="dense", n_layers=2, d_model=32,
                          n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                          vocab=64)
    ssm = T.ModelConfig(name="s", family="ssm", n_layers=2, d_model=32,
                        vocab=64, d_state=8, ssm_head_dim=16, ssm_chunk=8)
    moe = dataclasses.replace(dense, family="moe", n_experts=4, top_k=2,
                              moe_d_ff=32)
    encdec = dataclasses.replace(dense, family="encdec", n_enc_layers=1,
                                 enc_seq=8)
    vision = dataclasses.replace(dense, n_vision_tokens=4,
                                 mrope_sections=(2, 3, 3))
    extras = {encdec: {"audio_embeds": torch.zeros(1, 8, 32)},
              vision: {"vision_embeds": torch.zeros(1, 4, 32)}}
    for ok in (dense, ssm, moe, dataclasses.replace(moe, kv_lora=16),
               encdec, vision):
        model = M.init_params(ok, device="cpu")
        cache = M.init_cache(ok, 1, 16, device="cpu")
        batch = {"tokens": np.zeros((1, 6), np.int32), **extras.get(ok, {})}
        logits, _, cache = T.forward(ok, model, batch, cache)
        assert logits.shape == (1, ok.n_vision_tokens + 6, 64)
        assert cache["pos"] == ok.n_vision_tokens + 6
    with pytest.raises(ValueError, match="unknown family"):
        M.init_params(dataclasses.replace(dense, family="rnn"), device="cpu")
    assert {get_config(arch).name for arch in ARCHS} >= {
        "whisper-tiny", "qwen2-vl-72b"}
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import input_specs as ref_input_specs
    from repro_torch.configs import SHAPES
    got = input_specs(cfg, SHAPES["train_4k"])
    want = ref_input_specs(ref_cfg, REF_SHAPES["train_4k"])
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in got["batch"].items()} == {
        k: (tuple(t.shape), str(t.dtype)) for k, t in want["batch"].items()}
    assert all(t.is_meta for t in got["batch"].values())


def test_loss_and_train_step_run(ref_cfg, cfg, ref_params):
    """`loss_fn` equals the reference's on the smoke model (bf16, the
    no-cache forward's tolerance), and `make_train_step` takes a step
    once the model requires gradients (a frozen model is refused) that
    updates every parameter and counts the step."""
    from repro.models import model as RMod
    from repro_torch.optim import AdamW
    toks = _tokens(cfg, 2, 33)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = RMod.loss_fn(ref_cfg, ref_params,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.from_reference(cfg, jax.tree.map(np.asarray,
                                                     ref_params),
                                   device="cpu")
    got, metrics = M.loss_fn(cfg, model, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= LOGIT_TOL
    assert set(metrics) == {"ce", "aux", "zloss", "ntokens"}
    opt = AdamW(lr=1e-3)
    step = M.make_train_step(cfg, opt)
    state = (model, opt.init(dict(model.named_parameters())),
             torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="requires_grad_"):
        step(state, batch)
    before = [p.detach().clone() for p in model.parameters()]
    model.requires_grad_()
    (model, opt_state, n), out = step(state, batch)
    assert int(n) == 1 and int(opt_state["count"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))
    assert np.isfinite(float(out["loss"])) and float(out["grad_norm"]) > 0


def _summary_lines(text: str) -> list[str]:
    """`run_map_trace`'s printed summary without its times: the serve
    line up to its latencies, the sources line, and the cache line
    without the replay wall."""
    import re
    serve_line, sources, cache = text.strip().splitlines()[-3:]
    return [serve_line.split(", p50")[0], sources,
            re.sub(r"'replay_wall_s': [^,]*, ", "", cache)]


def test_map_trace_prints_the_reference_summary(tmp_path, monkeypatch,
                                                capsys):
    """``--map-trace`` serves kernel-mapping requests through the port's
    `MappingService` (here on the CPU) and prints the reference's
    summary lines.  Both write their disk tier under the working
    directory, each in its own ``DEFAULT_ART_DIR``."""
    monkeypatch.chdir(tmp_path)
    got = serve.main(["--map-trace", "4", "--trace-scale", "4x4",
                      "--device", "cpu"])
    got_text = capsys.readouterr().out
    want = ref_serve.main(["--map-trace", "4", "--trace-scale", "4x4"])
    want_text = capsys.readouterr().out
    assert _summary_lines(got_text) == _summary_lines(want_text)
    assert got_text.startswith("serve: 4 requests (4 ok)")
    assert (got["requests"], got["ok"], got["sources"]) == \
        (want["requests"], want["ok"], want["sources"])
    assert os.listdir(tmp_path / "artifacts" / "serve_torch")
    assert os.listdir(tmp_path / "artifacts" / "serve")


def test_entry_points_default_to_the_card(cfg):
    """``device=None`` means cuda: without a GPU the entry points raise,
    never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the host without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_reference(cfg, {})


def test_serve_main_runs_on_the_cpu(capsys):
    outs = serve.main(["--device", "cpu", "--requests", "3", "--gen", "4",
                       "--prompt-len", "8", "--slots", "2"])
    assert [o.shape for o in outs] == [(2, 4), (1, 4)]
    assert "bandwidth round" in capsys.readouterr().out
