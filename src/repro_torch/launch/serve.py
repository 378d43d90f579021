"""Batched serving driver: wave-scheduled batching — a wave of requests is
admitted together, prefilled in one call, then decoded in lockstep; the
next wave starts when the wave completes.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --requests 8 --gen 32

``--arch`` takes every arch of the registry: zamba2-1.2b (`hybrid`),
mamba2-2.7b (`ssm`), gemma3-4b, qwen1.5-4b, glm4-9b, starcoder2-7b and
qwen2-vl-72b (`dense`; its 256 stub patch embeddings go before each
prompt), mixtral-8x7b and deepseek-v2-lite-16b (`moe`), and whisper-tiny
(`encdec`; 1500 stub frame embeddings a slot).  `main` draws those
embeddings from a seed.  The prefill of a wave fills the decode cache
(the Mamba2 layers' SSD scan and the MoE layers' grouped products run as
CUDA kernels on the card; attention takes the plain masked product with
a cache, as in the reference) and each decode tick is one
`model.serve_step`.  PyTorch runs eagerly: there is no compiled step, and
the cache is updated in place with the reference's ``pos`` semantics.

Before serving, the driver prints the plan's **bandwidth rounds**
(`planner.schedule_transfer_rounds`): which per-step collectives can
overlap and which contend for the same mesh axis.

The CGRA mapping analogue of this loop lives behind ``--map-trace N``:
instead of LLM requests, serve ``N`` kernel-mapping requests through the
`repro_torch.serve.MappingService` (canonical-hash cache + batched
scheduler over the portfolio engine, on the card unless ``--device
cpu``) and report hit-rate and latency percentiles:

  PYTHONPATH=src python -m repro_torch.launch.serve --map-trace 64 \
      --device cuda
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M


class WaveServer:
    """Admit `slots` requests at a time; one prefill + N decode ticks, on
    the device the model lives on."""

    def __init__(self, cfg, model, *, slots: int = 4, s_max: int = 512):
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.s_max = s_max
        self.device = model.embed.table.device

    def run_wave(self, prompts: np.ndarray, max_new: int,
                 extra_inputs: dict | None = None) -> np.ndarray:
        """prompts: (B<=slots, S) int32 (padded to equal length).
        extra_inputs: the arch's stub embeddings, ``vision_embeds``
        (slots, Tv, D) or ``audio_embeds`` (slots, S_enc, D), tensors or
        numpy arrays; the prefill takes them, and each decode step takes
        ``audio_embeds`` again, as the reference's does (the step
        ignores them: its cache holds ``cross_kv``).  The cache must
        hold the vision prefix, the prompt and the new tokens, or this
        raises `ValueError`.  Returns generated tokens (B, max_new)."""
        b, s = prompts.shape
        if b > self.slots or self.cfg.n_vision_tokens + s + max_new > \
                self.s_max:
            raise ValueError(
                f"a wave of {b} prompts of {s} tokens "
                f"({self.cfg.n_vision_tokens} vision tokens before each) "
                f"and {max_new} new ones does not fit {self.slots} slots "
                f"of {self.s_max} positions")
        toks = np.pad(prompts, ((0, self.slots - b), (0, 0)))
        cache = M.init_cache(self.cfg, self.slots, self.s_max,
                             device=self.device)
        extra = {name: torch.as_tensor(t, device=self.device)
                 for name, t in (extra_inputs or {}).items()}
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                           device=self.device), **extra}
        logits, cache = M.prefill_step(self.cfg, self.model, batch, cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        out = [nxt]
        step_extra = extra if self.cfg.family == "encdec" else {}
        for _ in range(max_new - 1):
            nxt2, _, cache = M.serve_step(
                self.cfg, self.model, {"tokens": nxt[:, None], **step_extra},
                cache)
            nxt = nxt2[:, 0]
            out.append(nxt)
        return torch.stack(out, dim=1)[:b].cpu().numpy()


def stub_embeddings(cfg, slots: int, seed: int = 0) -> dict:
    """The arch's stub frontend outputs for a wave of ``slots``: seeded
    standard normals times 0.1 (as the reference's ``make_batch`` scales
    them), rounded to bf16: ``audio_embeds`` (slots, enc_seq, d_model)
    for encdec, ``vision_embeds`` (slots, n_vision_tokens, d_model) for
    a vision arch, none otherwise."""
    if cfg.family == "encdec":
        name, n = "audio_embeds", cfg.enc_seq
    elif cfg.n_vision_tokens:
        name, n = "vision_embeds", cfg.n_vision_tokens
    else:
        return {}
    x = np.random.default_rng(seed).standard_normal(
        (slots, n, cfg.d_model), dtype=np.float32) * np.float32(0.1)
    return {name: torch.from_numpy(x).to(torch.bfloat16)}


def serving_transfer_rounds(cfg, *, batch: int, seq: int,
                            tp: int = 16) -> tuple[list[list[str]], str]:
    """Bandwidth rounds of the decode step's transfer plan.

    Builds the planner's transfer DFG for a TP-sharded decode step and
    peels it into contention-free rounds with
    `planner.schedule_transfer_rounds`.  Returns (rounds, printable
    summary)."""
    from repro_torch.core import planner

    plan = planner.plan(cfg, "decode", seq, batch,
                        planner.mesh_stub({"data": 1, "model": tp}),
                        arch=cfg.name, shape="serve")
    rounds = planner.schedule_transfer_rounds(plan)
    moving = [t for t in plan.transfers if t.bytes_per_step > 0]
    text = (f"transfer plan: {len(plan.transfers)} classes, "
            f"{len(moving)} moving bytes -> {len(rounds)} bandwidth "
            f"round(s) {rounds}")
    return rounds, text


def run_map_trace(n_requests: int = 64, *, scale: str = "8x8",
                  rows: int = 8, cols: int = 8, seed: int = 0,
                  max_workers: int | None = None,
                  art_dir: str | None = None,
                  quiet: bool = False, device=None) -> dict:
    """Serve a Zipf kernel-mapping trace through `MappingService`.

    This is the mapping-as-a-service loop: canonical-hash cache in
    front of the portfolio engine, batched admission, per-request
    metrics.  ``device`` (None means ``"cuda"``) is where the requests'
    device engines run.  Returns the service metrics dict."""
    from repro_torch.core.cgra import CGRAConfig
    from repro_torch.core.workloads import make_request_trace
    from repro_torch.serve import MappingService, MapRequest

    trace = make_request_trace(n_requests, scale=scale, seed=seed)
    cgra = CGRAConfig(rows=rows, cols=cols)
    svc = MappingService(max_workers=max_workers, art_dir=art_dir,
                         base_seed=seed, device=device)
    svc.map_batch([MapRequest(dfg=t.dfg, cgra=cgra, deadline=t.deadline,
                              tenant=t.tenant, req_id=f"r{i}")
                   for i, t in enumerate(trace)])
    metrics = svc.metrics()
    if not quiet:
        print(svc.summary())
        print(f"  sources: {metrics['sources']}")
        print(f"  cache:   {metrics['cache']}")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    # As in the reference, --smoke is on and cannot be turned off.
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--map-trace", type=int, default=0, metavar="N",
                    help="serve N kernel-mapping requests through "
                         "MappingService instead of LLM requests")
    ap.add_argument("--trace-scale", default="8x8",
                    choices=["4x4", "8x8", "16x16"])
    args = ap.parse_args(argv)

    if args.map_trace:
        from repro_torch.serve import DEFAULT_ART_DIR
        rows = cols = int(args.trace_scale.split("x")[0])
        # Persistent artifact store: a second invocation hits the disk
        # tier for every kernel this one mapped.
        return run_map_trace(args.map_trace, scale=args.trace_scale,
                             rows=rows, cols=cols,
                             art_dir=DEFAULT_ART_DIR, device=args.device)

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    _, rounds_text = serving_transfer_rounds(
        cfg, batch=args.slots, seq=args.prompt_len + args.gen)
    print(rounds_text)
    model = M.init_params(cfg, 0, device=args.device)
    server = WaveServer(cfg, model, slots=args.slots,
                        s_max=cfg.n_vision_tokens + args.prompt_len
                        + args.gen + 8)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.requests, args.prompt_len),
                           dtype=np.int32)
    extra = stub_embeddings(cfg, args.slots)
    t0 = time.time()
    outs = []
    for lo in range(0, args.requests, args.slots):
        outs.append(server.run_wave(prompts[lo:lo + args.slots], args.gen,
                                    extra))
    dt = time.time() - t0
    total = args.requests * args.gen
    print(f"served {args.requests} requests × {args.gen} tokens in "
          f"{dt:.1f}s ({total / dt:.1f} tok/s); "
          f"sample: {outs[0][0][:8].tolist()}")
    return outs


if __name__ == "__main__":
    main()
