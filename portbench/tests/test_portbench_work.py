"""The frozen work counts: the step's FLOPs held to torch's own count of
the reference's forward and backward at smoke widths, the kernels' least
work independent of the route that runs them, and the readers that find
nothing returning nothing."""

from __future__ import annotations

import inspect

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.bench import spec, tokens, trace, weights
from portbench.metrics import (device_idle_share, flash_roofline,
                               optimizer_ms, ssd_roofline)
from portbench.reference import model as R
from portbench.reference.precision import Products
from portbench.tests import smoke
from portbench.work import flash, peaks, ssd, step


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def masked_flops(cfg: dict, b: int, s: int) -> float:
    """The forward FLOPs that the reference spends on pairs its masks
    hide, at a sequence no longer than one attention block: every (query,
    key) pair of the sequence is computed, and every (i, j) pair of each
    SSD chunk."""
    if cfg["family"] == "dense":
        hidden = s * s - flash.visible_pairs(s, s, cfg.get("sliding_window"))
        return cfg["n_layers"] * 4.0 * cfg["head_dim"] * hidden * \
            cfg["n_heads"] * b
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    h, p = d_inner // cfg["ssm_head_dim"], cfg["ssm_head_dim"]
    gn = cfg["ssm_groups"] * cfg["d_state"]
    hidden = sum(ln * (ln - 1) // 2 for ln in (
        min(cfg["ssm_chunk"], s - t0) for t0 in range(0, s, cfg["ssm_chunk"])))
    return cfg["n_layers"] * 2.0 * b * (gn + h * p) * hidden


@pytest.mark.parametrize("name", sorted(smoke.CELLS))
def test_step_flops_match_torch_count_of_the_reference(tmp_path, name):
    root = smoke.make_root(str(tmp_path))
    cell = spec.cell(root, name + "-cell")
    cfg, traffic = cell.config, cell.traffic
    b, s = traffic["batch"], traffic["seq_len"]
    assert s <= R.ATTN_BLOCK
    _, w = weights.make(R.param_specs(cfg), 0, "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    batch = tokens.Batches(traffic, cfg["vocab"], 0, "cpu")(0)

    def fwd():
        return R.loss(cfg, Products(), leaves, batch, remat=False)

    def fwd_bwd():
        torch.autograd.grad(fwd(), list(leaves.values()))

    counted = sum(step.forward_flops(cfg, b, s).values())
    computed = counted + masked_flops(cfg, b, s)
    assert masked_flops(cfg, b, s) > 0
    assert _count(fwd) == computed
    assert _count(fwd_bwd) == 3 * computed
    assert step.step_flops(cfg, traffic) == 3 * counted


def test_kernel_counts_match_torch_count_of_the_reference():
    """Each count, with the pairs the reference's masks hide added, is
    torch's count of the reference's products."""
    b, s, h, p, n, g, chunk = 2, 64, 4, 8, 16, 1, 16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen)
    bc = torch.randn(b, s, g, n, generator=gen)
    hidden = (s // chunk) * chunk * (chunk - 1) // 2
    assert _count(lambda: R.ssd_chunked(x, dt, torch.zeros(h), bc, bc,
                                        chunk)) == \
        ssd.forward_flops(b, s, h, p, n, g, chunk) + \
        2.0 * b * (g * n + h * p) * hidden
    q = torch.randn(b, s, h, p, generator=gen)
    for window in (None, 24):
        hidden = s * s - flash.visible_pairs(s, s, window)
        assert _count(lambda: R.causal_attention(
            Products(), q, q, q, window=window, remat=False)) == \
            flash.forward_flops(b, s, s, h, p, window) + \
            4.0 * p * hidden * h * b


@pytest.mark.parametrize("window", [None, 24, 40])
def test_reference_attention_in_blocks_is_the_masked_softmax(monkeypatch,
                                                              window):
    """Blocks of queries over the keys from their first visible one give
    the softmax over the whole masked sequence."""
    b, s, h, hkv, d = 1, 64, 4, 2, 8
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(b, s, h, d, generator=gen, dtype=torch.float64)
    k = torch.randn(b, s, hkv, d, generator=gen, dtype=torch.float64)
    v = torch.randn(b, s, hkv, d, generator=gen, dtype=torch.float64)
    monkeypatch.setattr(R, "ATTN_BLOCK", 16)
    got = R.causal_attention(Products(), q, k, v, window=window,
                             remat=False)
    i = torch.arange(s)
    seen = (i[:, None] >= i[None, :]) & \
        ((i[:, None] - i[None, :] < window) if window else True)
    kk = torch.repeat_interleave(k, h // hkv, dim=2)
    vv = torch.repeat_interleave(v, h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) * d ** -0.5
    probs = torch.softmax(logits.masked_fill(~seen, -torch.inf), dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    assert torch.allclose(got, want, atol=1e-12)
    assert flash.visible_pairs(s, s, window) == int(seen.sum())


def test_least_work_is_the_same_on_every_route():
    """The counts take shapes and the configuration's element size, no
    dtype, route or tile: bf16 and fp32 tensors of one shape give one
    bound."""
    for fn in (ssd.forward_flops, ssd.forward_bytes, ssd.backward_flops,
               ssd.backward_bytes, flash.forward_flops, flash.forward_bytes,
               flash.backward_flops, flash.backward_bytes):
        names = set(inspect.signature(fn).parameters)
        assert not names & {"dtype", "route", "block_k", "passes"}
    bounds = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.empty(1, 8192, 64, 64, dtype=dtype)
        bsz, s, h, p = x.shape
        bounds.append((
            peaks.least_seconds(ssd.forward_flops(bsz, s, h, p, 64, 1, 256),
                                ssd.forward_bytes(bsz, s, h, p, 64, 1, 2)),
            peaks.least_seconds(flash.backward_flops(bsz, s, s, h, p),
                                flash.backward_bytes(bsz, s, s, h, h, p, 2))))
    assert bounds[0] == bounds[1]
    # A scan at 8192 tokens is bound by its bytes, flash by FLOPs.
    assert bounds[0][0] == ssd.forward_bytes(1, 8192, 64, 64, 64, 1, 2) / \
        peaks.PEAK_BYTES_S
    assert flash.visible_pairs(8192, 8192) == 8192 * 8193 // 2
    assert flash.visible_pairs(8192, 8192, 4096) == \
        4096 * 4097 // 2 + 4096 * 4096


def _record(device, launches, arch="mamba2-2.7b", spans=None):
    cfg = smoke.smoke_config(arch, "z")
    return {"device": device, "host": [],
            "spans": spans or [("step", 0.0, 1000.0, 1)],
            "launches": launches, "steps": 1, "step_wall_s": 1000e-6,
            "config": cfg, "traffic": {"batch": 1, "seq_len": 64}}


def test_readers_that_find_nothing_return_nothing():
    for arch in ("mamba2-2.7b", "starcoder2-7b"):
        empty = _record([], {}, arch)
        for reader in (ssd_roofline, flash_roofline, optimizer_ms,
                       device_idle_share):
            assert reader.read(empty) is None


def test_roofline_and_idle_share_from_a_trace():
    dev = [("void (anonymous namespace)::ssd_states(float const*)",
            100.0, 300.0),
           ("void at::native::vectorized_elementwise_kernel<4>(int)",
            250.0, 400.0),
           ("fa_tc_kernel(bf16 const*)", 600.0, 700.0)]
    rec = _record(dev, {"ssd": 1, "ssd_bwd": 0, "flash_attention": 1})
    assert trace.busy_seconds(rec) == pytest.approx(400e-6)
    # Busy 0.4 ms of the untraced step's 1 ms.
    assert device_idle_share.read(rec) == pytest.approx(60.0)
    b, s, h, p, n, g, chunk = ssd.shape(rec["config"], rec["traffic"])
    least = peaks.least_seconds(ssd.forward_flops(b, s, h, p, n, g, chunk),
                                ssd.forward_bytes(b, s, h, p, n, g, 2))
    assert ssd_roofline.read(rec) == pytest.approx(100 * least / 200e-6)
    gaps = trace.idle_gaps(rec)
    assert sum(v for _, v in gaps) == pytest.approx(600e-6)
    assert trace.top_device_ops(rec, 1)[0] == [
        "ssd_states", pytest.approx(200e-6)]


def test_flash_roofline_counts_the_window():
    dev = [("fa_tc_kernel(bf16 const*)", 0.0, 100.0)]
    options = {"sliding_window": 24}
    rec = _record(dev, {"flash_attention": 1})
    rec["config"] = smoke.smoke_config("starcoder2-7b", "s", options)
    b, s, hq, hkv, d, win = flash.shape(rec["config"], rec["traffic"])
    assert win == 24
    least = peaks.least_seconds(
        flash.forward_flops(b, s, s, hq, d, win),
        flash.forward_bytes(b, s, s, hq, hkv, d, 2))
    assert flash_roofline.read(rec) == pytest.approx(100 * least / 100e-6)
    assert flash.forward_flops(b, s, s, hq, d, win) < \
        flash.forward_flops(b, s, s, hq, d)
