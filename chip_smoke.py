#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA GPU and the CUDA toolkit (``nvcc``); without a GPU,
or outside a checkout of the repository, it exits non-zero and prints
no result.  It imports nothing of JAX or of the JAX package.  Phases,
each printed as one JSON line with its end as ``at_s``, the seconds since
the script started:

1. card: the GPU's name and power limit, torch and CUDA versions; then
   the port's kernels are built from ``src/repro_torch/kernels`` (one
   ``nvcc`` per source, all started together).
2. kernel vs plain version: `selection_counts` (the .b1 tensor-core
   kernel) on the card against its plain torch version, at the shapes
   the main path gives it, with random words, real engine selections,
   ragged K (1, 37, 1000) and all-ones words; then across its tiles'
   edges (W = 4, n_pad off its 256-vertex tile and odd) and through its
   plain loads (W = 5; an operand one word off 16-byte alignment).
   Counts are integers: the tolerance is zero.
3. main path: `map_dfg` at the port's defaults (``engine="device"``,
   1024 trajectories, 20000 iterations, on the GPU) on the 14 golden
   (II, routing-PE) cases of the paper's kernels, and on C4K8 at the
   8x8 and 16x16 fabric sizes.  The kernel's launch count is reset
   just before and read just after; it must be `MAIN_PATH_LAUNCHES`.
4. the engine on the card vs on the CPU: 64 iterations of 64
   trajectories from the same inits must end in bit-identical state.
5. full width: 1024 trajectories for 48 iterations on the C4K8@8x8 and
   C4K8@16x16 conflict graphs; every best must be an independent set.
   Iterations/s and peak device memory (at 16x16 beside the 5.2 ms an
   iteration before the tensor-core `selection_counts`, quoted), then 16 iterations under `torch.profiler` for
   the card's busy share of a lock-step.
6. conflict kernels vs plain versions: `conflict_matrix` (dense int8)
   and `conflict_matrix_packed` (packed words) on the card against
   their plain torch versions on the card, with tolerance zero, on the
   features of the graphs above and of the five 16x16 workload graphs
   (|V_C| up to 16656), on ragged random features (n at and beside the
   dense kernel's 32-row tiles and 512-column strips), and with every
   vertex in one op, and with op ids and slots across the int32 range
   (the packed wrapper then sorts its group ids; the dense kernel's
   tiles take its general loop), with slots, ports and PEs at the ends
   of the dense kernel's fold (every tile folded), and with one vertex
   past them (its tiles general, the others folded); the dense kernel
   must also equal its fold's plain version (`ref.conflict_matrix_folded`),
   and the packed kernel its own plain version (the group-mask
   formulation) and, unpacked, the dense kernel: two independent
   formulations.
7. conflict route: `build_conflict_graph(use_kernel="packed-cuda")`
   must give rows byte-equal to the host build (``use_kernel=False``)
   on C4K8@16x16 and the five 16x16 workload graphs, with
   ``bus_pressure`` True and False, and the dense entry point
   `conflict_matrix(use_cuda=True)` must agree with it.  Both routes'
   walls (with the garbage collector's pauses inside each), and the
   CUDA route's split into encode, host-to-device copy, kernel and
   device-to-host copy.  The launch counts are reset just
   before and read just after: both conflict kernels must have
   launched.
8. 16x16 workloads: `map_dfg` at the port's defaults on four workload
   graphs of the generator (`core.workloads`) on a 16x16 fabric; each
   (II, routing PEs) must equal the pinned `GOLDEN_16X16`.
9. times: the rates of the four tensor-core instructions that could
   carry `selection_counts` (``csrc/mma_probe.cu``: mma.sync and wgmma,
   .b1 and .s8), which chose the .b1 wgmma, and of the two TF32 forms
   (mma.sync m16n8k8, wgmma m64n256k8) that the fp32 flash and SSD
   kernels' split products could take; `selection_counts` per call
   (CUDA events, after warm-up), its bound (bytes, or the 0/1 product at
   the int8 rate, or at the measured .b1 rate where the kernel beats
   the int8 one), the CUDA cores' POPC floor, its plain version and the
   ``torch._int_mm`` yardstick; both conflict kernels at each 16x16
   workload shape, with their bounds, plain versions, device time by
   kernel (`torch.profiler`), their times before their redesigns at
   n = 16656 (quoted) and the two host (numpy) formulations; beside the
   dense kernel, a fill of its output buffer (`write_floor_ms`: the
   same bytes written in order).
10. llm-serve: zamba2-1.2b at its published widths (the port's seeded
   init, seed 0) served by `WaveServer` with 4 slots: 8 requests of
   1000 prompt tokens, 32 new tokens each.  The launch counts are reset
   just before the two waves and read just after: `ssd` 76 times (38
   Mamba2 layers per prefill), all on its bf16 route (`ssd_bf16`),
   `flash_attention` never (the cached prefill takes the plain masked
   product, as the reference's does).
   Teacher-forced prefill and decode logits against the no-cache
   forward's: in fp32 compute with an fp32 cache within the reference's
   tolerance for the family (atol = rtol = 0.15 for hybrid and ssm,
   3e-2 for dense, tests/test_models.py:100-106); in bf16, as served,
   the prefill within it where the unembedding is untied, and at each
   decode step the same argmax wherever the no-cache forward's top-2
   margin exceeds 0.3 (the rule the CPU tests hold `WaveServer` to:
   bf16 roundings part random layers by more than the tolerance).  The
   counts are reset just before each teacher-forced run and read just
   after: `ssd` 76 times on the run's route (38 in its no-cache forward,
   38 in its prefill; the fp32 run is the fp32 route's path), nothing
   else.  Prefill and decode tokens/s and peak device memory; with a
   tied unembedding, its share of the decode steps.
11. llm-forward-long: the no-cache forward at (1, 8192), which takes
   flash attention (8192^2 > 4096^2): `flash_attention` 6 times (the
   shared block's invocations), `ssd` 38 times, each on its bf16
   route (`flash_attention_bf16`, `ssd_bf16`), every logit finite.
   Wall and peak device memory (and a tied unembedding's share).
12-13. llm-serve and llm-forward-long for mamba2-2.7b (the ssm family:
   64 Mamba2 layers, the SSD scan at N = 128 with 80 heads, chunk 256):
   `ssd` 64 a prefill wave and 64 in the long forward, flash never.
14-15. the same for gemma3-4b (dense: 34 layers at D = 256, GQA 8:4,
   5 local layers with window 1024 to 1 global): flash 34 times in the
   long forward (29 with the window, 5 plain causal), never in
   serving; `ssd` never.  Each model is freed before the next.
16. llm-dense-widths: qwen1.5-4b, glm4-9b and starcoder2-7b at their
   published widths cut to 2 layers (``reduced``): a no-cache forward
   at (1, 8192), flash twice at D = 128 (GQA 20:20, 32:2, 36:4), and a
   wave of 4 prompts of 1000 tokens with 4 decode steps, which launches
   no kernel.
17. ragged-dot-vs-plain: `ragged_dot` (the MoE FFN's grouped product)
   on the card against its plain version on the card (`RAGGED_CASES`:
   empty groups, one group holding every row, M off the row tiles, K
   and N at mixtral's and deepseek's widths, K or N off a multiple of
   8, x off 16-byte alignment, rows outside the groups, which must be
   zero), bf16 x with fp32 weights (the path's types: the TMA + wgmma
   kernel rounds them on load, or the mma.sync kernel where TMA cannot
   take the rows), each also on the weights cast to bf16 first (the
   same bits on the same kernel) and on the mma.sync kernel by name;
   each call one launch on its route (`ragged_dot_wgmma`,
   `ragged_dot_mma`); tolerance 1e-4 + 2^-7 |y| (one bf16 ulp: both
   sum in fp32 and round once); the same cases but the largest in fp32
   on its fp32 route (the TF32 tensor cores, the CUDA cores for K or N
   off a multiple of 4), 1e-4 + 1e-5 |y| of the plain version's float64
   sums (`plain_acc`); one call under
   ``torch.cuda.set_sync_debug_mode("error")``: the kernel reads the
   group offsets on the card, with no host sync.
18-19. llm-serve and llm-forward-long for mixtral-8x7b (the moe family)
   at its published widths cut to 4 of 32 layers (``reduced``): served
   as above, `ragged_dot` 3 times a layer a forward (gate, up, down) on
   the fp32 expert stacks as stored: 768 over the two waves, all on the
   TMA + wgmma kernel, 108 in each teacher-forced run, on the run's
   route (the fp32 run computes the experts in fp32 too, on the
   kernel's fp32 route, every call on the TF32 tensor cores), flash
   never;
   the long forward launches flash 4 times with the window 4096 at
   (1, 8192, 32, 128), GQA 32:8, and `ragged_dot` 12 times.  Then
   llm-moe-capacity (the capacity dispatch on the same model: no
   `ragged_dot`) and ragged-dot-path (the kernel at each grouped
   product the path gave, on the fp32 stacks: prefill, decode and long,
   gate/up and down; error, the same bits on the stacks cast first, ms
   on fp32 and on bf16 weights, the earlier mma.sync kernel's ms with
   and without the cast, plain, bounds with the weights at 4 and at 2
   bytes, and ``torch._grouped_mm`` (on bf16 weights, and timed with
   the cast) and a per-expert ``torch.matmul`` loop as yardsticks off
   the path); then the fp32 route at mixtral's prefill gate/up and the
   smoke shapes (`ragged_fp32_row`).
20. the same for deepseek-v2-lite-16b uncut (27 layers, MLA, 64 routed
   experts top-6 and 2 shared; 64.9 GB of fp32 weights, every earlier
   model freed first; the peak printed): served, `ragged_dot` 81 a
   forward, and ragged-dot-path; its long forward is left out (MLA
   takes the plain masked product at any length: no kernel).
21. llm-encdec-vision: whisper-tiny uncut (4 + 4 layers, d 384, 1500
   stub frames of seeded bf16 embeddings times 0.1): a no-cache forward
   of 4 sequences of 384 tokens, also in fp32 compute for one sequence
   against the same weights on the host (the family tolerance, atol =
   rtol = 3e-2), and a `WaveServer` wave of 4 prompts of 384 tokens with
   32 new ones (424 positions); nothing launches (1500^2 and 384^2 are
   under flash's 4096^2 threshold), and no teacher-forced decode runs:
   the served cache's ``cross_kv`` is zeros, so the cached path never
   runs the encoder (a reference quirk the port keeps).  Then
   qwen2-vl-72b at its published widths cut to 4 of 80 layers
   (``reduced``): the no-cache forward over 256 stub patches and 7936
   tokens, which launches bf16 flash 4 times at (1, 8192, 64, 128), GQA
   64:8, plain causal, its inputs captured for phases 22-23; a wave of 4
   slots of 256 patches and 1000 tokens with 32 new ones, which launches
   nothing; and the cached prefill's last logits against the no-cache
   forward's in bf16 and in fp32 compute, at the dense tolerance (only
   the prefill: a decode step's M-RoPE positions jump to the absolute
   position, another reference quirk).  Walls and peak device memory
   for each run.
22. llm-kernels-vs-plain: `flash_attention` and `ssd` on the card against
   their plain versions on the card: the reference's kernel cases
   (tests/test_kernels.py) in fp32 and bf16, cases across the
   kernels' tile edges and their plain loads (`FA_CASES`, `SSD_CASES`;
   one case each in both dtypes with its first input at an offset of 2
   elements), and the inputs each path really gave (captured during
   phases 10-21: each arch's first SSD call in serving and in the long
   forward, its first flash call for each window); each case records
   the route it took (the bf16 or the fp32 kernel) and fails on the
   other.  Tolerances: flash 2e-6 (fp32) and 2e-2 (bf16), the
   reference's; SSD 1e-4 in fp32, the reference's, and in bf16 one
   bf16 ulp of y (1e-4 + 2^-7 |y|: both sides compute in fp32 and round
   y once) with the fp32 state at 1e-4 + 1e-5 |state|.
23. llm-times: both kernels at the path shapes of zamba2, mamba2,
   gemma3, mixtral and qwen2-vl (gemma3's local and global flash calls apart; CUDA events,
   after warm-up), in bf16 and then on the same inputs cast to fp32,
   each dtype on its own kernels, with the launch counts reset just
   before each dtype's run and read just after (the fp32 route's
   launches on its path).  Each row: ms, route and error (both
   checked), zamba2's routes' times before their redesigns
   (`earlier_ms`, quoted from PERF.md and not measured, so the kernels
   line leaves it out), the plain version, and the bound: flash's
   visible (query, key) pairs, which a window cuts; the SSD scan's
   products counted at the bf16 rate times the fewest bf16 passes that
   meet its tolerances (`SSD_PASSES`), on fp32 at the TF32 rate times
   the fewest split-TF32 passes that meet the fp32 ones
   (`FA_PASSES_FP32`, `SSD_PASSES_FP32`), with the CUDA cores' fp32
   rate beside it (`fp32_rate_bound_ms`).  For flash
   `F.scaled_dot_product_attention` on the same tensors (causal, or with
   the window as an explicit mask) is the library yardstick (off the
   path; the SSD scan has no single PyTorch call), with its error
   against the plain version: in bf16 it computes P V from bf16 P on
   tensor cores, and must meet the kernel's own bf16 tolerance, which
   is what lets the flash bound count all its products at the bf16
   tensor-core rate.

24. train: `repro_torch.launch.train.main` (the entry point a user
   calls) on lm100m (12 x 768, GQA 12:4, tied; uncut) for 20 steps at
   (8, 256) with a checkpoint every 5 steps and a failure injected at
   step 7: one restart from the step-5 checkpoint, 22 steps run, finite
   losses, the last below the first; then on zamba2-1.2b uncut at
   (2, 2048) for 6 steps writing no checkpoint: finite falling losses,
   `ssd_bwd` 38 times a step (228, all bf16) and `ssd` twice as often
   (each Mamba2 layer's forward and its recomputation under the
   per-block activation checkpoint), flash never.  Then mixtral-8x7b
   (1 of 32 layers) and deepseek-v2-lite-16b (3 of 27) at (1, 4096), 4
   steps each, and gemma3-4b (6 of 34: 5 local, 1 global) at (1, 8192),
   3 steps (`TRAIN_RUNS`): finite falling losses; `ragged_dot_bwd` 3
   times a MoE layer a step and `ragged_dot` twice as often (both on TMA
   + wgmma, `ragged_dot_bwd_mma` never); `flash_attention_bwd` once a
   layer a step and `flash_attention` twice; no plain version (`ref.*`)
   called on a CUDA tensor.  Each run: tokens/s, the step wall, peak
   device memory, the card's `nvidia-smi` name and power limit, its
   seconds; the last step of zamba2's, mixtral's, deepseek's and
   gemma3's runs is profiled under `torch.profiler` (untimed,
   `TRAIN_PROFILED`): its top kernels, the shares of the three backward
   kernels, the forward kernels, the GEMMs, the optimizer and the
   elementwise kernels (`TRAIN_PROFILE_SHARES`), and the backward
   kernels' share together.  The first `ssd_bwd` call of zamba2's run, and each projection's first
   `ragged_dot_bwd` call of the MoE runs, are captured for the next
   phases.
25. ssd-bwd-vs-plain: the SSD backward kernel (`ssd_bwd`) against
   autograd through the plain scan on the card (`ref.ssd_chunked_bwd`
   on fp32 copies of the inputs) at `SSD_BWD_CASES` (zamba2's captured
   training shape (2, 2048, 64, 64), N = 64, chunk 256, with no d_final
   and with one; mamba2's (2, 2048, 80, 64), N = 128; S off the chunk;
   P = 130 and N = 12; chunk 1024), each in bf16 and fp32, within
   `SSD_BWD_TOL`; two calls give the same bits.  bf16 runs
   `ssd_bwd_tc.cu` (bf16 tensor cores), fp32 `ssd_bwd.cu` (TF32 tensor
   cores, three passes a product).  At zamba2's and mamba2's shapes the
   kernel's ms, its stages' device times, the first (CUDA-core) design's
   times (`SSD_BWD_EARLIER_MS`, quoted), the plain version's and the bound
   (`ssd_bwd_bound`, with its count before the head fold beside it).
25b. ragged-dot-bwd-vs-plain: the grouped product's backward
   (`ragged_dot_bwd`: ``ragged_dot_dx`` and ``ragged_dot_dw``,
   csrc/ragged_dot_bwd.cu) against its plain version at the shapes the
   MoE runs captured and at `RAGGED_BWD_EDGES` (unaligned K and N,
   rows outside the groups, empty groups, bf16 weights, the fp32
   route), within the forward's tolerances; two calls give the same
   bits; bf16 takes the TMA + wgmma kernels wherever K and N are
   multiples of 8 (every captured shape), mma.sync elsewhere, by
   `LAUNCHES` key.  At the captured shapes: both kernels' ms and each
   alone, the earlier mma.sync kernels' (`RAGGED_BWD_EARLIER_MS`,
   quoted), the plain halves' ms, the bounds (`ragged_bwd_bound`) and
   `torch._grouped_mm` for dx and for dw on pre-cast weights.  Then the
   fp32 route (the TF32 tensor cores, checked by `LAUNCHES` key) at
   mixtral's captured gate/up shape with x and dy cast to fp32 and at
   the smoke shapes the fp32 step feeds it (`FP32_RAGGED_SMOKE`): each
   kernel's ms beside the first CUDA-core kernels' where quoted
   (`RAGGED_FP32_EARLIER_MS`), its bounds at three TF32 passes and at
   the CUDA cores' rate, and a library time (`ragged_fp32_row`).
25c. flash-bwd-vs-plain: flash attention's backward
   (`flash_attention_bwd`: ``flash_bwd_dq`` and ``flash_bwd_dkdv``,
   csrc/flash_attention_bwd.cu) at every flash path shape the serving
   phases captured, in bf16 and fp32, against the plain backward one
   KV-head group at a time (`FA_BWD_TOL`); two calls give the same
   bits, and the forward's output is the same with and without its LSE;
   each call is one launch on its dtype's route (bf16: the wgmma
   kernels; fp32: mma.sync on the TF32 tensor cores).  ms (both kernels
   and each alone), the kernels' ms before their redesign
   (`FA_BWD_EARLIER_MS`, quoted: the first mma.sync bf16 kernels and the
   first CUDA-core fp32 ones), the plain halves' ms, the bounds
   (`flash_bwd_bound`) and SDPA's backward (`flash_bwd_vs_plain`).
26. train-card-vs-cpu: one fp32 `train_step` on the card and on the
   host from the same weights, for zamba2 at published widths cut to 6
   layers (one shared-attention invocation) at (1, 512) and for the
   mixtral and deepseek smoke configs at (2, 256) (`TRAIN_CHECKS`):
   loss, grad norm and every updated parameter within `TRAIN_TOL` (see
   its comment); `ssd_bwd` launched once a Mamba2 layer and
   `ragged_dot_bwd` three times a MoE layer on the card, on their fp32
   routes, and every `ragged_dot` and `ragged_dot_bwd` call on the TF32
   tensor cores.
27. dryrun: `launch.op_analysis` counts zamba2-1.2b's uncut train step
   at (2, 2048) (forward, recompute, backward, AdamW; `ssd` and
   `ssd_bwd` on the bf16 route) and mixtral-8x7b's no-cache forward at
   (1, 8192) cut to 4 layers (flash at its 4096 window, `ragged_dot`),
   each on the card and on the meta device at the same config: the dot
   FLOPs and each kernel's calls must be equal (the kernels count by
   their stated formulas on every device), and the card's counted
   kernel calls must equal their launches.  zamba2's step as a share of
   the card's 989e12 dense bf16 FLOP/s by model FLOPs (6 N D) and by
   the traced count, over the train phase's measured step wall (median
   after the first), with the card's name and power limit; the state's
   bytes predicted by the dry run's specs on a 1 x 1 mesh must equal
   what its parameters and AdamW moments hold.  Then
   `launch.dryrun.trace_cell` on every applicable cell of the single
   mesh (34 cells of ten archs); the multi mesh and the optimized plan
   are left to the CLI and the slow tests.
28. race: `map_dfg(backend="race")` with the portfolio side on the card,
   on C5K5 bandmap (its (II, routing PEs) must be the golden pair) and
   on the forced loser of tests/test_exact_race.py (busmap, max_ii 2,
   certify off, seed 7: the exact side must win, and the cancelled
   portfolio may run at most one chunk of iterations past the cancel).
   Every "race-side" span must carry its ``ok`` (a side that raised
   lacks it: the race would have degraded around it).
29. comap: `co_map` on the card on the tier-1 cases of
   tests/test_comap.py and on `COMAP_PORTFOLIO_PAIR`; every ok merged
   binding must pass the port's validator, the 2x2 case must fail
   cleanly.
30. map-trace: `launch.serve.run_map_trace` (the ``--map-trace`` entry
   point) on the card, `SERVICE_TRACE` requests at 8x8 with
   `SERVICE_WORKERS` workers and a cold in-memory cache: no crash
   outcome, no serve-crash event, every ok result valid.  Requests/s,
   p50/p95/p99 latency, sources, hit rates, the slowest requests.  One
   request of the trace maps for minutes on the host, so the phase runs
   in a process of its own (``chip_smoke.py --map-trace``), started
   after phase 9 and read here, beside phases 10-29.  While the
   script times the card (`cuda_ms`, `device_profile`, `StepClock`, the
   training runs) that process is stopped, so that the two never share
   the card by time slices; its row gives when it started
   (`started_at_s`) and the seconds it was stopped (`stopped_s`), which
   its walls and latencies include.
31. explain: traced and recorded maps (C4K8@8x8 busmap, C5K5 bandmap)
   with their span walls by name (`obs.export.to_json`) and
   `MappingResult.explain()`'s report.
Each of phases 28-31 resets the launch counts just before it and reads
them just after (phase 30 in its own process, whose counts start at 0):
`selection_counts` must have launched.

The last lines are the kernel table (JSON), the card as ``nvidia-smi``
reports it, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# The golden (II, routing PEs) table of the paper's kernels on the
# default 4x4 CGRA, (n, m, mode) -> pair.  The JAX package pins the
# same values in tests/test_golden_results.py.
GOLDEN = {
    (1, 2, "bandmap"): (1, 0), (1, 2, "busmap"): (1, 0),
    (2, 4, "bandmap"): (1, 0), (2, 4, "busmap"): (1, 0),
    (2, 6, "bandmap"): (2, 0), (2, 6, "busmap"): (2, 2),
    (3, 6, "bandmap"): (2, 0), (3, 6, "busmap"): (2, 3),
    (4, 4, "bandmap"): (1, 0), (4, 4, "busmap"): (1, 0),
    (2, 8, "bandmap"): (2, 0), (2, 8, "busmap"): (3, 4),
    (5, 5, "bandmap"): (3, 0), (5, 5, "busmap"): (3, 5),
}

# (II, routing PEs) of the 16x16 workload graphs under `map_dfg`'s
# defaults on a 16x16 fabric; tests/test_torch_workloads.py holds this
# table to the JAX package's map_dfg.  reduce32 is left out: it does
# not map in minutes (ROADMAP, Queue 3).
GOLDEN_16X16 = {"scale_16x16_loop": (5, 0), "loop40": (5, 0),
                "stencil16t3": (2, 0), "c2k6": (1, 0)}
# The 16x16 workload graphs whose conflict graphs the kernels build.
WORKLOADS_16X16 = ("scale_16x16_loop", "loop40", "stencil16t3",
                   "reduce32", "c2k6")

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory bytes/s, and 32-bit operations/s outside the tensor
# cores (the float32 rate: the table has no int32 rate, and no 32-bit
# lane operation issues faster, so the bound below is a floor).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_BF16_S = 989e12      # bf16 tensor cores, dense
PEAK_TF32_S = 494e12      # TF32 tensor cores, dense
PEAK_INT8_S = 1979e12     # int8 tensor cores, dense
# The CUDA cores' popcount pipe: 16 POPC a clock an SM (the CUDA
# programming guide's throughput table, compute capability 9.0), over
# 132 SMs at 1.98 GHz: the floor of any CUDA-core `selection_counts`,
# which needs one POPC per (trajectory, vertex, word).
POPC_S = 16 * 132 * 1.98e9
# The least work of the conflict predicate: it is the union of two
# equivalence relations (same op; same place: the same kind, slot and
# port for TIN/TOUT, the same slot and PE for QUAD), so each 32-bit
# output word is the OR of at most two group masks with the diagonal
# cleared (csrc/conflict_matrix.cu): an OR and a mask.
OPS_PER_OUT_WORD = 2
# The service tier's phases.  The map-trace phase serves
# `run_map_trace`'s default trace (64 requests at 8x8) on a pool of 2
# workers: the scheduler's own advice for device-engine deployments
# (1-2 workers, the engine's K-way parallelism inside each map).
SERVICE_TRACE = 64
SERVICE_WORKERS = 2
# The map-trace process's limit, s: the script's own limit is 1200 s.
TRACE_CHILD_TIMEOUT_S = 1000
# Processes the script started (the map-trace phase's), killed on exit.
_CHILDREN: list = []
# Seconds the children were stopped while the card was timed, and how
# deep the timing sections are nested.
_STOPPED = dict(seconds=0.0, depth=0)
# Seconds a stopped child's queued kernels are given to drain.
DRAIN_S = 0.005
# The co-mapping cases: the tier-1 cases of tests/test_comap.py (which
# the host settles: the certificate stage or the constructive starts
# place every op) and one pair of the 8x8 serve catalog whose regions
# reach the portfolio.
COMAP_PORTFOLIO_PAIR = ("loop2x0", "reduce6a3")
# Launches of `selection_counts` in the main-path phase: all of them
# C5K5:bandmap's portfolio, the only golden case the host does not
# settle (every earlier chip run read the same count).
MAIN_PATH_LAUNCHES = 192
# A C4K8@16x16 lock-step iteration at K = 1024 before this kernel's
# tensor-core redesign, ms: quoted from PERF.md section 5, never
# measured here.
EARLIER_ITER_MS_16X16 = 5.2
# The CUDA-core selection_counts' ms at the 16x16 shape and the
# pair-predicate packed kernel's at n = 16656, quoted from PERF.md.
EARLIER_SELECTION_COUNTS_MS = 0.646
EARLIER_PACKED_MS = 0.287
# The dense pair predicate's ms at n = 16656 before its redesign (the
# first design, a block of 16 rows), quoted from PERF.md.
EARLIER_DENSE_MS = 0.398
# The LLM paths: zamba2-1.2b served (4 slots, 8 requests of 1000 prompt
# tokens, 32 new ones) and its no-cache forward at 8192 tokens; then the
# ssm and dense families at their published widths with the same traffic
# (mamba2-2.7b: the SSD scan at N = 128 and 80 heads; gemma3-4b: flash
# attention at D = 256, 5 local layers (window 1024) to 1 global); then
# the other dense configs at published widths cut to 2 layers, one
# long forward and one short wave each.
LLM_ARCH = "zamba2-1.2b"
FAMILY_ARCHS = ("mamba2-2.7b", "gemma3-4b")
DENSE_WIDTH_ARCHS = ("qwen1.5-4b", "glm4-9b", "starcoder2-7b")
DENSE_WIDTH_REDUCED = {"n_layers": 2}
DENSE_WIDTH_NEW = 5        # the prefill's token and 4 decode steps
SERVE_SLOTS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 1000, 32
LONG_SEQ = 8192
LOGIT_TOL = 0.15        # the reference's hybrid tolerance (test_models.py)
# The reference's tolerance per family (tests/test_models.py:100):
# teacher-forced logits in fp32 are held to it; bf16 decode argmaxes
# wherever the no-cache top-2 margin exceeds 2 * LOGIT_TOL.
FAMILY_TOL = {"hybrid": LOGIT_TOL, "ssm": LOGIT_TOL, "dense": 3e-2,
              "moe": 3e-2}
FA_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
SSD_ATOL = 1e-4
SSD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# The reference's kernel cases (tests/test_kernels.py:17-25, :70-75),
# then cases across the kernels' tile edges: flash's Sq and Sk off its
# 128-row query and 64-key tiles (the fp32 kernel's 64-row, 32-key tiles
# past D = 128), D 48 and 128, a window, q_offset > 0, GQA 4:1; SSD's
# single chunk, S < chunk, P = 96 (a ragged second column tile), N off
# 64 and a ragged last chunk.  D = 5 and 44, P = 20 and N = 12 are not
# multiples of 8, so their bf16 calls take the kernels' plain loads
# instead of cp.async; D = 5 and 250, P = 18 and N = 10 are not
# multiples of 4, so their fp32 calls do too, as does an input at an
# offset of 2 elements (off 16-byte alignment, `_at_offset`).  D = 192
# and 256 (three and four 64-column panels; bf16 takes the two-stage K/V
# ring there) are the widest heads of the repository's configs; D = 250
# takes the plain loads at four panels.  gemma3's shape: D = 256 with a
# window of 1024 and Sq = Sk past it; mamba2's: N = 128 at chunk 256,
# with a ragged last chunk.
FA_CASES = [(2, 128, 128, 4, 2, 64, None, 0), (1, 256, 256, 4, 4, 32, None, 0),
            (2, 128, 384, 4, 1, 64, None, 256), (1, 256, 256, 8, 2, 64, 100, 0),
            (1, 64, 64, 2, 2, 128, 16, 0), (1, 1, 512, 4, 2, 64, None, 511),
            (2, 300, 333, 8, 2, 128, None, 0), (1, 200, 260, 8, 2, 48, 70, 60),
            (1, 129, 65, 4, 1, 128, None, 0),
            (1, 777, 900, 4, 1, 64, 300, 123), (1, 150, 170, 4, 2, 5, None, 0),
            (1, 200, 260, 8, 2, 44, 70, 60),
            (2, 300, 333, 8, 2, 192, None, 0), (1, 200, 260, 4, 1, 256, 70, 60),
            (1, 150, 170, 2, 1, 250, None, 0),
            (1, 65, 33, 2, 1, 192, None, 0),
            (1, 2048, 2048, 8, 4, 256, 1024, 0)]
SSD_CASES = [(2, 64, 4, 16, 32, 16), (1, 128, 8, 32, 64, 32),
             (2, 128, 4, 64, 128, 64), (2, 1000, 4, 64, 64, 256),
             (1, 256, 4, 64, 64, 256), (2, 100, 4, 64, 64, 256),
             (1, 1000, 3, 96, 64, 256), (2, 700, 3, 40, 24, 128),
             (1, 300, 3, 20, 64, 128), (2, 300, 3, 64, 12, 128),
             (1, 200, 3, 18, 10, 64), (1, 1000, 4, 64, 128, 256),
             (2, 300, 3, 64, 128, 256)]
# Each route's time before its tensor-core redesign, ms: bf16 when it
# took the fp32 CUDA-core kernels, and fp32 on those kernels (PERF.md
# section 6).  Quoted in llm-times' rows, never measured here, so the
# kernels line leaves them out.
EARLIER_MS = {"bfloat16": {"flash_attention": 12.57, "ssd_long": 4.574,
                           "ssd_serve": 0.787},
              "float32": {"flash_attention": 12.39, "ssd_long": 4.183,
                          "ssd_serve": 0.739}}
EARLIER_FROM = ("quoted from PERF.md section 6 (NVIDIA H100 80GB HBM3, "
                "700 W), not measured in this run")
# The fewest bf16 passes of each SSD product that meet the bf16
# tolerances: the scores 1 (bf16 operands), and 2 for each product with
# an fp32 operand (the gate, the chunk states, the inter-chunk term), as
# bf16 terms.  tests/test_torch_ssd.py shows two terms each meet them
# and one term of any of the three misses them.  csrc/ssd_tc.cu takes
# three terms for the states and the inter-chunk term.
SSD_PASSES = {"scores": 1, "gate": 2, "state": 2, "inter": 2}
# On fp32 inputs every product of both kernels takes three TF32 passes
# (hi hi, hi lo, lo hi): tests/test_torch_flash_attention.py and
# tests/test_torch_ssd.py show that three meet the fp32 tolerances and
# one or two miss them, and that the .cu files take three (`kPasses`).
FA_PASSES_FP32 = 3
SSD_PASSES_FP32 = {"scores": 3, "gate": 3, "state": 3, "inter": 3}
# The route keys of the kernels with one per dtype (`LAUNCHES`).
ROUTES = ("bf16", "fp32")
ROUTE_OF = {"bfloat16": "bf16", "float32": "fp32"}
LLM_KEYS = tuple(f"{k}{r}" for k in ("ssd", "flash_attention")
                 for r in ("", "_bf16", "_fp32")) + tuple(
    f"ragged_dot{r}" for r in ("", "_wgmma", "_mma", "_fp32", "_fp32_tc",
                               "_fp32_cores"))
# ragged_dot's route keys for a compute dtype: bf16 x (the fp32 expert
# stacks rounded on load) on the TMA + wgmma kernel; fp32 on the TF32
# tensor cores (its route and its kernel's key) at every path shape.
RAGGED_ROUTE = {"bf16": ("wgmma",), "fp32": ("fp32", "fp32_tc")}
# The moe family: mixtral-8x7b at its published widths cut to 4 of its 32
# layers (46.7e9 parameters, 187 GB in fp32, do not fit one card; 4
# layers hold 6.07e9), and deepseek-v2-lite-16b uncut (16.2e9, 64.9 GB
# in fp32), each served with the traffic above; mixtral's no-cache
# forward at 8192 tokens takes flash with its 4096 window on every
# layer.  deepseek's long forward is left out: MLA takes the plain
# masked product at every length (V's width is not Q's), and its 16
# heads' 8192^2 fp32 scores would add 4.3 GB a copy to 65 GB of weights.
MOE_ARCHS = ("mixtral-8x7b", "deepseek-v2-lite-16b")
MOE_REDUCED = {"mixtral-8x7b": {"n_layers": 4}, "deepseek-v2-lite-16b": {}}
MOE_LONG = ("mixtral-8x7b",)
# The encdec and vision archs, the last two serving families: whisper-
# tiny uncut (4 + 4 layers at d 384, 39e6 parameters; 1500 stub frames)
# with 4 sequences of 384 text tokens (a wave adds 32 new ones: 424
# positions, inside Whisper's 448-token text context), and qwen2-vl-72b
# at its published widths cut to 4 of its 80 layers (6.00e9 parameters,
# 24.0 GB in fp32): a no-cache forward over its 256 stub patches and
# 7936 tokens (S = 8192: flash once a layer at (1, 8192, 64, 128), GQA
# 64:8, M-RoPE applied before it) and a wave of 4 slots of 256 patches
# and 1000 tokens with 32 new ones.
ENCDEC_ARCH, VISION_ARCH = "whisper-tiny", "qwen2-vl-72b"
VISION_REDUCED = {"n_layers": 4}
WHISPER_SLOTS, WHISPER_TEXT = 4, 384
# ragged_dot against its plain version: both sum each row's products in
# fp32 and round once to bf16, in other orders, so a result next to a
# rounding edge may land one bf16 ulp away: 1e-4 + 2^-7 |y|; on fp32
# inputs (the fp32 compute mode's route) the fp32 sums themselves,
# 1e-4 + 1e-5 |y| (the SSD scan's fp32 tolerance).
RAGGED_ATOL = 1e-4
RAGGED_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# (M, K, N, group sizes or a seed for random sizes over G groups):
# empty groups, one group holding every row, M off the 128-row tile,
# tiles that span several groups, K and N at mixtral's and deepseek's
# widths (both projections), and K or N off a multiple of 8 (the plain
# loads).
RAGGED_CASES = [(8, 64, 96, [3, 0, 5, 0]), (300, 72, 200, [0, 100, 0, 150, 50]),
                (257, 64, 96, [257]), (129, 64, 128, [0, 0, 129, 0]),
                (300, 70, 198, [0, 100, 0, 150, 40]),
                (200, 64, 100, [50, 50, 50, 50]),
                (1000, 128, 256, ("random", 64)),
                (8, 4096, 14336, [1, 1, 2, 0, 1, 1, 1, 1]),
                (8000, 4096, 14336, ("random", 8)),
                (8000, 14336, 4096, ("random", 8)),
                (24000, 2048, 1408, ("random", 64)),
                (24, 1408, 2048, ("random", 64))]

# The training phases.  train: `repro_torch.launch.train.main` on
# lm100m (12 x 768, GQA 12:4, tied; launch.train's default) with a
# checkpoint every 5 steps and a failure injected at step 7, then on
# zamba2-1.2b uncut at (2, 2048) for 6 steps writing no checkpoint
# (every 1000 steps): 38 SSD backward launches a step.  Then the moe
# family and attention past 4096^2 pairs at published widths, cut in
# depth (``--layers``) to fit one card: AdamW's update holds about 7 fp32
# copies of the parameters at its peak (zamba2's 1.170e9 peaked at 34.17
# GB, 7.3 x 4 bytes a parameter), so mixtral-8x7b takes 1 of its 32
# layers (1.713e9 parameters) and deepseek-v2-lite-16b 3 of 27 (2.174e9),
# each at (1, 4096) for 4 steps (`ragged_dot` and its backward, 3 a MoE
# layer); gemma3-4b 6 of 34 (5 local, 1 global; 1.237e9) at (1, 8192)
# for 3 steps (flash and its backward at D = 256 on every layer).
TRAIN_RUNS = {
    "lm100m": ["--steps", "20", "--batch", "8", "--seq", "256",
               "--ckpt-every", "5", "--inject-failure-at", "7"],
    "zamba2-1.2b": ["--arch", "zamba2-1.2b", "--steps", "6", "--batch",
                    "2", "--seq", "2048", "--ckpt-every", "1000"],
    "mixtral-8x7b": ["--arch", "mixtral-8x7b", "--layers", "1", "--steps",
                     "4", "--batch", "1", "--seq", "4096", "--ckpt-every",
                     "1000"],
    "deepseek-v2-lite-16b": ["--arch", "deepseek-v2-lite-16b", "--layers",
                             "3", "--steps", "4", "--batch", "1", "--seq",
                             "4096", "--ckpt-every", "1000"],
    "gemma3-4b": ["--arch", "gemma3-4b", "--layers", "6", "--steps", "3",
                  "--batch", "1", "--seq", "8192", "--ckpt-every", "1000"]}
# ragged-dot-bwd-vs-plain: the backward pair at the shapes captured from
# the MoE runs (gate/up and down of each: bf16 x and dy, the fp32 stacks),
# then at edges: K and N off 8 (the plain loads), one group holding every
# row, rows before the first group and past the last, empty groups, the
# fp32 route (on the TF32 tensor cores, and K and N off 4 on the CUDA
# cores), bf16 weights.  (M, K, N, group sizes, x's type, w's type, rows
# before the first group.)  Tolerances are the forward's (`RAGGED_ATOL`,
# `RAGGED_RTOL`, by x's type: dw of fp32 weights is a bf16 value).
RAGGED_BWD_EDGES = [(300, 70, 198, [0, 100, 0, 150, 40], "bf16", "fp32", 0),
                    (257, 64, 96, [257], "bf16", "bf16", 0),
                    (520, 128, 4104, [300, 0, 220], "bf16", "fp32", 0),
                    (600, 2048, 1408, [10] * 50 + [0] * 14, "bf16", "fp32",
                     37),
                    (1000, 256, 384, [100, 0, 300, 250, 0, 300], "fp32",
                     "fp32", 20),
                    (300, 70, 198, [0, 100, 0, 150, 40], "fp32", "fp32", 3),
                    (4096, 4096, 1024, [1000, 0, 2000, 1096], "fp32",
                     "fp32", 0)]
# ragged-dot-path and ragged-dot-bwd-vs-plain time the fp32 route (fp32 x
# and weights, the fp32 compute mode's: the CUDA cores) at
# `FP32_RAGGED_ARCH`'s captured prefill gate/up shape, x (and dy) cast
# to fp32, and at the smoke shapes train-card-vs-cpu's fp32 step feeds
# it, (arch, (batch, seq)): gate/up (batch seq top_k, d_model, moe_d_ff)
# and down (batch seq top_k, moe_d_ff, d_model), rows routed uniformly
# at random; `FP32_RAGGED_REPS` timed calls each.
FP32_RAGGED_ARCH = "mixtral-8x7b"
FP32_RAGGED_SMOKE = (("mixtral-8x7b", (2, 256)),
                     ("deepseek-v2-lite-16b", (2, 256)))
FP32_RAGGED_REPS = 3
# Calls profiled for the fp32 route's device ms (the profiler dropped
# the kernels of most three-call sessions at the smoke shapes).
FP32_RAGGED_PROFILED = 20
# flash-bwd-vs-plain: the backward pair at each flash path shape the
# serving phases captured (zamba2's (1, 8192, 32, 64); gemma3's (1, 8192,
# 8, 256) with 4 KV heads, local and global; mixtral's (1, 8192, 32,
# 128), window 4096; qwen2-vl's (1, 8192, 64, 128), GQA 64:8), each in
# bf16 and fp32, on the card's own forward output and LSE and a seeded
# dO, against the plain backward on fp32 copies one KV-head group at a
# time.  Each gradient within `FA_BWD_TOL` of its max |ref|: fp32 the
# orders of fp32 sums; bf16 the design's tolerance, which
# tests/test_torch_flash_bwd.py's emulation of its roundings (P and dS as
# single bf16 terms) holds well inside (``pytest -s -k bf16`` prints it).
# fp32 at 3e-5: each dK and dV entry is one fp32 sum over up to Sq g =
# 65536 terms at these shapes (8192 queries of 8 heads), taken in order
# by the kernel and by blocks of keys and batched products by the plain
# version (tests/test_torch_gpu.py holds 1e-5 at its smaller shapes).
FA_BWD_TOL = {"float32": 3e-5, "bfloat16": 1e-2}
# train-card-vs-cpu: one fp32 step from the same weights on the card and
# on the host: zamba2 at its published widths cut to 6 layers (one
# shared-attention invocation) at (1, 512), and the mixtral and
# deepseek smoke configs (the grouped products' fp32 routes, forward
# and backward) at (2, 256).  Loss and grad norm within 1e-4 (relative,
# + 1e-6); every updated parameter within 1e-4 max |p| + 1e-6 of the
# host's where the clipped gradient is at least 100 eps (the optimizer's
# first-step slope g / (|g| + eps) is up to 1 / eps below that:
# tests/test_torch_train.py), and within the most the step can move it,
# lr (1 + wd |p|) each way, elsewhere.  name -> (arch, smoke, reduced,
# (batch, seq)).
TRAIN_CHECKS = {"zamba2-1.2b": ("zamba2-1.2b", False, {"n_layers": 6},
                                (1, 512)),
                "mixtral-8x7b smoke": ("mixtral-8x7b", True, {}, (2, 256)),
                "deepseek-v2-lite-16b smoke": ("deepseek-v2-lite-16b", True,
                                               {}, (2, 256))}
TRAIN_TOL = 1e-4
# ssd-bwd-vs-plain: the backward kernel against autograd through the
# plain scan on the card (`ref.ssd_chunked_bwd`), on zamba2's training
# shape captured from the train phase's first backward (with no
# d_final, as the step gives it, and with a random one), mamba2's (2,
# 2048, 80, 64) at N = 128, S off the chunk (1000, 300), P = 130 and N
# = 12, and chunk 1024; each in bf16 and fp32.  (B, S, H, P, N, chunk,
# d_final): a tuple of random inputs, or "captured".
SSD_BWD_CASES = [("zamba2 train step", "captured", False),
                 ("zamba2 train step, d_final", "captured", True),
                 ("mamba2 (2, 2048, 80, 64) N=128",
                  (2, 2048, 80, 64, 128, 256), True),
                 ("S=1000 off the chunk", (1, 1000, 4, 64, 64, 256), True),
                 ("S=300 P=40 N=24", (2, 300, 3, 40, 24, 128), False),
                 ("P=130 N=12", (1, 130, 2, 130, 12, 100), True),
                 ("chunk 1024", (1, 2100, 2, 64, 64, 1024), False)]
# Tolerances, both against the plain version on fp32 copies of the same
# inputs (it rounds nothing but the result): fp32 dx, ddt, db, dc within
# 1e-5 max |ref| (the orders of fp32 sums); bf16 within half a bf16 ulp
# of each value (the kernel rounds once, to nearest) + 1e-5 max |ref|;
# d_a_log (fp32 for both) within 1e-3 max |ref|: each head's sums dt A
# rev over every step, rev being a reverse sum of dcum, itself row sums
# less column sums of the gate's terms, so its fp32 error follows terms
# far larger than the result; the plain version itself parts from a
# float64 evaluation by ~1e-4 max |ref| there, 10x the other gradients
# (tests/test_torch_ssd.py::test_plain_backward_fp32_error_against_float64).
SSD_BWD_TOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
SSD_BWD_ATOL = 1e-5
SSD_BWD_DA_TOL = 1e-3
# ssd-bwd-vs-plain's times before each route's tensor-core redesign: the
# first ssd_bwd.cu, both dtypes on the CUDA cores (PERF.md section 6, row
# 5b's "before").  Quoted in the phase's rows, never measured here, so
# the kernels line leaves them out.
SSD_BWD_EARLIER_MS = {"bfloat16": {"zamba2": 3.281, "mamba2": 8.353},
                      "float32": {"zamba2": 3.277, "mamba2": 8.373}}
# The times of the other two backward pairs before their redesign, (both
# kernels, dq or dx alone, dkdv or dw alone) by path shape: bf16, the
# first mma.sync kernels (the "before" of PERF.md section 6, row 4b and
# the ragged_dot_dx/_dw rows; now on wgmma); flash's fp32, the first
# CUDA-core kernels (row 4b's fp32 "before"; now on the TF32 tensor
# cores).  Quoted in the phases' rows, never measured here, so the
# kernels line leaves them out.
FA_BWD_EARLIER_MS = {
    "bfloat16": {("zamba2-1.2b", "flash_long"): (5.134, 1.916, 3.218),
                 ("gemma3-4b", "flash_local"): (3.172, 1.489, 1.661),
                 ("gemma3-4b", "flash_global"): (11.56, 5.251, 6.306),
                 ("mixtral-8x7b", "flash_long"): (7.695, 3.264, 4.317),
                 ("qwen2-vl-72b", "flash_long"): (20.43, 8.437, 12.19)},
    "float32": {("zamba2-1.2b", "flash_long"): (80.40, 33.31, 47.89),
                ("gemma3-4b", "flash_local"): (21.91, 10.33, 11.56),
                ("gemma3-4b", "flash_global"): (85.05, 41.44, 43.70),
                ("mixtral-8x7b", "flash_long"): (122.9, 53.79, 69.40),
                ("qwen2-vl-72b", "flash_long"): (323.5, 142.5, 180.9)}}
FA_BWD_EARLIER_FROM = {
    "bfloat16": "the first mma.sync kernels, quoted",
    "float32": "the first CUDA-core kernels, quoted"}
RAGGED_BWD_EARLIER_MS = {
    "mixtral-8x7b gate/up": (11.07, 6.666, 4.729),
    "mixtral-8x7b down": (10.53, 6.432, 4.220),
    "deepseek-v2-lite-16b gate/up": (2.184, 1.166, 1.023),
    "deepseek-v2-lite-16b down": (2.112, 1.147, 0.964)}
# The fp32 route's times on its first CUDA-core kernels (ragged_dot_f32,
# ragged_dx_f32, ragged_dw_f32; PERF.md section 6, the fp32 row's
# "before"), by ragged_fp32_row's label and part; now on the TF32 tensor
# cores.  Quoted in the phases' rows, never measured here, so the
# kernels line leaves them out.
RAGGED_FP32_EARLIER_MS = {
    ("mixtral-8x7b prefill gate/up", "fwd"): 42.86,
    ("mixtral-8x7b gate/up", "dx"): 44.19,
    ("mixtral-8x7b gate/up", "dw"): 37.62}
RAGGED_FP32_EARLIER_FROM = ("the first CUDA-core kernels, " +
                            EARLIER_FROM)
# The profiled training steps (train: the last step of each of
# `TRAIN_PROFILED`): each label's kernels by name, for their share of the
# step's device time; the backward kernels' labels first.
TRAIN_PROFILED = ("zamba2-1.2b", "mixtral-8x7b", "deepseek-v2-lite-16b",
                  "gemma3-4b")
TRAIN_BWD_LABELS = ("ssd_bwd", "ragged_dot_bwd", "flash_attention_bwd")
TRAIN_PROFILE_SHARES = {
    "ssd_bwd": ("ssd_bwd_",),
    "ragged_dot_bwd": ("ragged_dx", "ragged_dw"),
    "flash_attention_bwd": ("fa_bwd_",),
    "ragged_dot forward": ("ragged_dot_tc_kernel", "ragged_dot_kernel"),
    "flash forward": ("fa_tc_kernel",),
    "ssd forward": ("ssd_states", "ssd_scan", "ssd_out"),
    "gemm": ("gemm", "nvjet", "cutlass", "xmma"),
    "optimizer foreach": ("multi_tensor_apply",),
    "elementwise": ("elementwise_kernel", "vectorized_"),
    "reduce": ("reduce_kernel",)}


# dryrun: the op-level count (`launch.op_analysis`) of two steps the
# script runs, once on the card and once on the meta device at the same
# config and shape: zamba2-1.2b's uncut train step at (2, 2048) (`ssd`
# and `ssd_bwd`, bf16) and mixtral-8x7b's no-cache forward at (1, 8192)
# cut to 4 layers (flash at its 4096 window, `ragged_dot`).  Their dot
# FLOPs must be equal: each kernel counts by its stated formula on every
# device.  Then zamba2's step as a share of the card's dense bf16 peak
# (`launch.dryrun.PEAK_FLOPS`) by model FLOPs (6 N D) and by the traced
# count, the state's predicted bytes on a 1 x 1 mesh against what its
# tensors hold, and `launch.dryrun.trace_cell` on every applicable cell
# of the single mesh (the CLI and the slow tests take the multi mesh and
# the optimized plan).
DRYRUN_TRAIN = ("zamba2-1.2b", 2, 2048)
DRYRUN_LONG = ("mixtral-8x7b", {"n_layers": 4}, 8192)


_T_IMPORT = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T_IMPORT)
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


@contextlib.contextmanager
def card_to_itself():
    """Stop the script's running children (SIGSTOP) for the block and let
    them go on after it (SIGCONT): two processes' kernels share the card
    by time slices, which would add to every time taken meanwhile."""
    procs = [] if _STOPPED["depth"] else \
        [p for p in _CHILDREN if p.poll() is None]
    for proc in procs:
        proc.send_signal(signal.SIGSTOP)
    t0 = time.perf_counter()
    _STOPPED["depth"] += 1
    try:
        if procs:
            time.sleep(DRAIN_S)
        yield
    finally:
        _STOPPED["depth"] -= 1
        for proc in procs:
            proc.send_signal(signal.SIGCONT)
        if procs:
            _STOPPED["seconds"] += time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after a warm-up."""
    with card_to_itself():
        return _cuda_ms(fn, reps)


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_profile(fn, calls: int | None = None, top: int = 6,
                   shares: dict | None = None) -> dict:
    """Run ``fn()`` under `torch.profiler` and return the device time it
    took (ms) with the ``top`` kernels that took most of it.  Where the
    profiler records no device activity, the device time is None (not
    measured).  With ``calls`` (``fn`` makes that many calls of one
    function), the device time is a call's: each kernel's mean time times
    its launches a call, so that the event a session can drop (the first,
    in some sessions of this script) does not count as a call's worth of
    nothing.  ``shares`` (label -> substrings of kernel names) adds each
    label's device ms (``shares_ms``) and its share of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with card_to_itself(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in kernels)
    if calls:
        total = sum(ms / count * max(1, round(count / calls))
                    for _, ms, count in kernels)
    out = dict(device_ms=total if kernels else None,
               top=[dict(kernel=name[:80], ms=ms, count=count)
                    for name, ms, count in kernels[:top]])
    if shares:
        out["shares_ms"] = {label: sum(ms for name, ms, _ in kernels
                                       if any(k in name for k in keys))
                            for label, keys in shares.items()}
        out["shares"] = {label: ms / total if total else None
                         for label, ms in out["shares_ms"].items()}
    return out


def conflict_graph(dfg, cgra, mode: str):
    """The conflict graph of the first schedulable II at jitter 0 (the
    graphs the JAX package's engine bench measures)."""
    from repro_torch.core import build_conflict_graph, mii, schedule_dfg
    start = mii(dfg, cgra)
    for ii in range(start, start + 8):
        try:
            sched = schedule_dfg(dfg, cgra, mode=mode, ii=ii, max_ii=ii,
                                 jitter=0, seed=0)
        except RuntimeError:
            continue
        return sched, build_conflict_graph(sched, cgra, bus_pressure=True)
    raise RuntimeError("no schedulable II found")


def workload_dfgs() -> dict:
    """The 16x16 workload graphs, by name: the generator's "16x16"
    sweep and its |V_C| ~ 10^4 loop (`core.workloads`)."""
    from repro_torch.core import scale_16x16_loop, sweep_specs
    specs = {s.name: s for s in sweep_specs("16x16")}
    return {name: scale_16x16_loop() if name == "scale_16x16_loop"
            else specs[name].build() for name in WORKLOADS_16X16}


def random_features(n: int, seed: int, one_op: bool = False,
                    wide: bool = False, fold_edge: bool = False,
                    mixed: bool = False):
    """``int32 [n, 8]`` features with every field in a small range, so
    that many pairs share a kind, op, slot, port or PE (kinds -1 and 3
    lie outside TIN/TOUT/QUAD); ``one_op`` puts every vertex in op 5,
    where every off-diagonal pair conflicts; ``wide`` spreads the op ids
    and slots over the int32 range, so the packed wrapper sorts its group
    ids instead of taking the mixed-radix ones, and every tile of the
    dense kernel takes its general loop; ``fold_edge`` takes the slot,
    port and PE from the ends of the dense kernel's signed widths
    (`ref.M_BITS`, `PORT_BITS`, `PE_BITS`: every tile folded); ``mixed``
    gives vertex n // 2 a slot past `M_BITS`, so its row tile and strip
    take the general loop and the other tiles the folded one (as the
    reference model `ref.fold_tiles` predicts)."""
    import numpy as np
    import torch
    from repro_torch.kernels.conflict_matrix.ref import (M_BITS, PE_BITS,
                                                         PORT_BITS)
    rng = np.random.default_rng(seed)
    feat = np.stack([rng.integers(-1, 4, n), rng.integers(0, 8, n),
                     rng.integers(0, 3, n), rng.integers(-1, 3, n),
                     rng.integers(-1, 3, n), rng.integers(-1, 3, n),
                     rng.integers(-1, 2, n), rng.integers(0, 3, n)],
                    axis=1).astype(np.int32).reshape(n, 8)
    if one_op:
        feat[:, 1] = 5
    if wide:
        pick = np.array([-2**31, -7, 0, 2**31 - 1], dtype=np.int32)
        feat[:, 1] = pick[rng.integers(0, 4, n)]
        feat[:, 2] = pick[rng.integers(0, 4, n)]
    if fold_edge:
        for col, bits in ((2, M_BITS), (3, PORT_BITS), (4, PE_BITS),
                          (5, PE_BITS)):
            half = 1 << (bits - 1)
            ends = (-half, -1, 0, half - 1)
            feat[:, col] = np.array(ends, np.int32)[
                rng.integers(0, len(ends), n)]
    if mixed:
        feat[n // 2, 0], feat[n // 2, 2] = 2, 1 << (M_BITS - 1)
    return torch.from_numpy(feat)


def check_conflict_kernels(feats: dict, dev) -> dict:
    """Both conflict kernels on the card against their plain versions on
    the card, and the packed kernel against the dense one, on every
    ``label -> int32 [n, 8]`` case of ``feats``."""
    import torch
    from repro_torch.core.bitset import unpack_words
    from repro_torch.kernels.conflict_matrix import (conflict_matrix_dense,
                                                     conflict_matrix_words)
    from repro_torch.kernels.conflict_matrix.ref import (
        conflict_matrix_folded, conflict_matrix_packed_groups,
        conflict_matrix_packed_plain, conflict_matrix_plain, fold_tiles,
        radix_plan)
    max_err = {"conflict_matrix": 0, "conflict_matrix_packed": 0}
    cases = []
    for label, feat in feats.items():
        f = feat.to(dev)
        n = f.shape[0]
        dense, words = conflict_matrix_dense(f), conflict_matrix_words(f)
        torch.cuda.synchronize()
        dense_plain = conflict_matrix_plain(f)
        dense_folded = conflict_matrix_folded(f)
        tiles = fold_tiles(f)
        words_plain = conflict_matrix_packed_plain(f)
        words_groups = conflict_matrix_packed_groups(f)
        torch.cuda.synchronize()
        bits, bits_plain = unpack_words(words), unpack_words(words_plain)
        err_d = int((dense.int() - dense_plain.int()).abs().max()) \
            if n else 0
        err_p = int((bits.int() - bits_plain.int()).abs().max()) \
            if n else 0
        max_err["conflict_matrix"] = max(max_err["conflict_matrix"], err_d)
        max_err["conflict_matrix_packed"] = max(
            max_err["conflict_matrix_packed"], err_p)
        cases.append(dict(case=label, n=n, words=words.shape[1],
                          edges=int(dense.sum()), max_abs_err_dense=err_d,
                          max_abs_err_packed=err_p,
                          group_ids="radix" if n and radix_plan(f)
                          else "sorted",
                          tiles_folded=f"{int(tiles.sum())}/"
                                       f"{tiles.numel()}"))
        check(dense.shape == (n, n) and dense.dtype == torch.int8,
              f"{label}: dense output {tuple(dense.shape)} {dense.dtype}")
        check(torch.equal(dense, dense_plain),
              f"conflict_matrix != plain version: {label}")
        check(torch.equal(dense_folded, dense_plain),
              f"the fold's plain version != plain version: {label}")
        # Which loop each tile takes is the reference model's prediction
        # (ref.fold_tiles): these check that the cases are built as meant.
        if label.startswith("mixed"):
            check(0 < int(tiles.sum()) < tiles.numel(),
                  f"{label}: the model must send tiles to both loops")
        if label.startswith("fold-edge"):
            check(bool(tiles.all()),
                  f"{label}: the model must fold every tile")
        check(torch.equal(words, words_plain),
              f"conflict_matrix_packed != pair-predicate plain version: "
              f"{label}")
        check(torch.equal(words, words_groups),
              f"conflict_matrix_packed != group-mask plain version: "
              f"{label}")
        check(torch.equal(bits[:, :n], dense.bool()) and
              not bits[:, n:].any(),
              f"packed kernel, unpacked, != dense kernel: {label}")
        if label.startswith("one-op"):
            check(int(dense.sum()) == n * (n - 1),
                  f"{label}: every off-diagonal pair must conflict")
    return dict(max_abs_err=max_err, cases=cases)


class GCClock:
    """Seconds the host's cyclic garbage collector has run while this
    is entered (read through `gc.callbacks`), so that a wall timed
    around Python code shows how much of it was a collection pause."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._start

    def __enter__(self) -> "GCClock":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def conflict_route(route_graphs: dict, cgra, dev) -> list:
    """`build_conflict_graph(use_kernel="packed-cuda")` against the host
    build on each ``label -> schedule``, with ``bus_pressure`` True and
    False; the CUDA route's group part timed step by step; and the dense
    entry point against the packed one."""
    import torch
    from repro_torch.core import build_conflict_graph
    from repro_torch.core.bitset import pack_bool_rows
    from repro_torch.core.conflict import bitset_group_conflicts
    from repro_torch.kernels.conflict_matrix import (
        conflict_matrix, conflict_matrix_packed, conflict_matrix_words)
    from repro_torch.kernels.conflict_matrix.ref import encode
    rows = []
    for label, sched in route_graphs.items():
        row = dict(graph=label)
        for bp in (True, False):
            with GCClock() as gc_host:
                t0 = time.perf_counter()
                host = build_conflict_graph(sched, cgra, bus_pressure=bp)
                t1 = time.perf_counter()
            with GCClock() as gc_cuda:
                cuda = build_conflict_graph(sched, cgra, bus_pressure=bp,
                                            use_kernel="packed-cuda",
                                            device=dev)
                t2 = time.perf_counter()
            same = cuda.bits.rows.tobytes() == host.bits.rows.tobytes()
            row[f"bus_pressure={bp}"] = dict(
                v_c=host.n, host_s=t1 - t0, cuda_s=t2 - t1,
                host_gc_s=gc_host.seconds, cuda_gc_s=gc_cuda.seconds,
                byte_equal=same)
            check(same, f"{label}, bus_pressure={bp}: packed-cuda rows "
                        f"differ from the host build")
        # The CUDA route's group part, step by step, beside the host's
        # (the rest of either route's wall is the vertex list and the
        # dependency and bus-pressure edges, which both share).
        t0 = time.perf_counter()
        feat = encode(host.vertices)
        t1 = time.perf_counter()
        feat_dev = torch.from_numpy(feat).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        words = conflict_matrix_words(feat_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        words.cpu()
        t4 = time.perf_counter()
        bitset_group_conflicts(host.vertices, host.op_vertices, sched.ii)
        t5 = time.perf_counter()
        row["cuda_split_s"] = dict(encode=t1 - t0, h2d=t2 - t1,
                                   kernel=t3 - t2, d2h=t4 - t3)
        row["host_group_s"] = t5 - t4
        dense = conflict_matrix(host.vertices, use_cuda=True, device=dev)
        packed = conflict_matrix_packed(host.vertices, use_cuda=True,
                                        device=dev)
        check(pack_bool_rows(dense).tobytes() == packed.tobytes(),
              f"{label}: conflict_matrix(use_cuda=True) disagrees with "
              f"conflict_matrix_packed(use_cuda=True)")
        rows.append(row)
    return rows


def map_workloads(dfgs: dict, cgra) -> list:
    """`map_dfg` at the port's defaults on the `GOLDEN_16X16` graphs;
    each must map at II = MII with the pinned (II, routing PEs)."""
    from repro_torch.core import map_dfg
    from repro_torch.kernels import LAUNCHES
    cases = []
    for name, pair in GOLDEN_16X16.items():
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        r = map_dfg(dfgs[name], cgra)
        wall = time.perf_counter() - t0
        cases.append(dict(case=name, ok=r.ok, ii=r.ii, mii=r.mii,
                          routing_pes=r.n_routing_pes, v_c=r.cg_size[0],
                          wall_s=wall,
                          launches=LAUNCHES["selection_counts"] - before))
        check(r.ok and r.mis_size == r.n_ops, f"{name}@16x16 failed")
        check(r.ii == r.mii, f"{name}@16x16: II {r.ii} above MII {r.mii}")
        check((r.ii, r.n_routing_pes) == pair,
              f"{name}@16x16: (II, routing PEs) = "
              f"{(r.ii, r.n_routing_pes)}, pinned {pair}")
    return cases


def time_conflict_kernels(workloads: dict, dev) -> list:
    """Both conflict kernels at each workload's shape: ms (CUDA events,
    after warm-up), the bound, the plain versions (2 calls after a
    warm-up) and the two host formulations (one call each)."""
    import torch
    from repro_torch.core.bitset import pack_bool_rows
    from repro_torch.core.conflict import bitset_group_conflicts
    from repro_torch.kernels.conflict_matrix import (conflict_matrix_dense,
                                                     conflict_matrix_words)
    from repro_torch.kernels.conflict_matrix.ref import (
        conflict_matrix_packed_groups, conflict_matrix_packed_plain,
        conflict_matrix_plain, conflict_matrix_ref, encode)
    rows = []
    for name, (sched, cg) in workloads.items():
        feat = encode(cg.vertices)
        f = torch.from_numpy(feat).to(dev)
        n = cg.n
        w32 = 2 * -(-n // 64)
        t0 = time.perf_counter()
        pack_bool_rows(conflict_matrix_ref(feat))
        t1 = time.perf_counter()
        bitset_group_conflicts(cg.vertices, cg.op_vertices, sched.ii)
        t2 = time.perf_counter()
        host_ms = {"conflict_matrix_ref+pack_bool_rows": 1e3 * (t1 - t0),
                   "bitset_group_conflicts": 1e3 * (t2 - t1)}
        for kernel, fn, plain, out_bytes, reps in (
                ("conflict_matrix", conflict_matrix_dense,
                 conflict_matrix_plain, n * n, 20),
                ("conflict_matrix_packed", conflict_matrix_words,
                 conflict_matrix_packed_groups, 4 * n * w32, 50)):
            nbytes = 4 * 8 * n + out_bytes     # features in, words out
            ops = OPS_PER_OUT_WORD * -(-out_bytes // 4)
            t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
            row = dict(
                kernel=kernel, graph=f"{name}@16x16", n=n, w32=w32,
                ms=cuda_ms(lambda: fn(f), reps),
                plain_ms=cuda_ms(lambda: plain(f), 2),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, ops=ops, bytes=nbytes, host_ms=host_ms)
            # The card's own time a call, by kernel, over 10 calls (the
            # packed wrapper's ms holds its aminmax read-back, a sync, and
            # four launches).
            prof = device_profile(lambda: [fn(f) for _ in range(10)],
                                  calls=10)
            row.update(device_ms=prof["device_ms"],
                       device_kernels=prof["top"], device_calls=10)
            if kernel == "conflict_matrix":
                # The card's rate for writing the output's bytes in order
                # (one fill of the kernel's [n, pitch] buffer): the floor
                # that the stores' own pattern is held to.
                buf = torch.empty((n, -(-n // 16) * 16), dtype=torch.int8,
                                  device=dev)
                row.update(write_floor_ms=cuda_ms(lambda: buf.fill_(1),
                                                  reps),
                           earlier_ms=EARLIER_DENSE_MS
                           if n == 16656 else None)
                del buf
            else:
                row.update(pair_plain_ms=cuda_ms(
                               lambda: conflict_matrix_packed_plain(f), 2),
                           earlier_ms=EARLIER_PACKED_MS
                           if n == 16656 else None)
            rows.append(row)
    return rows


class Capture:
    """Wraps ``module.name`` (a kernel's wrapper) while entered and keeps
    a copy of the arguments of the first call for each value of
    ``key(args, kwargs)`` (one key for all calls unless given), with the
    number of calls for each: the inputs the path really gives the
    kernel.  The wrapped call still counts its own launch.  With
    ``clone=False`` the arguments are kept as they are (for inputs the
    path does not write after the call, such as the grouped products'
    operands, whose expert weights are too large to copy); with
    ``clone="host"`` they are copied to the host (for inputs kept past
    the model that gave them: a training run's)."""

    def __init__(self, module, name: str, key=None, clone=True) -> None:
        self.module, self.name = module, name
        self.key = key or (lambda args, kwargs: None)
        self.clone = clone
        self.calls: dict = {}
        self.counts: dict = {}

    @property
    def args(self):
        return next(iter(self.calls.values()))[0] if self.calls else None

    @property
    def kwargs(self):
        return next(iter(self.calls.values()))[1] if self.calls else None

    def __enter__(self) -> "Capture":
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, *args, **kwargs):
        key = self.key(args, kwargs)
        if key not in self.calls:
            self.calls[key] = (tuple(
                a if a is None or not self.clone else
                a.to("cpu") if self.clone == "host" else a.clone()
                for a in args), dict(kwargs))
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.orig(*args, **kwargs)

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.orig)


def by_window(args, kwargs):
    """A flash call's window: 0 for plain causal, as the kernel takes it."""
    return int(kwargs.get("window") or 0)


def by_projection(args, kwargs):
    """A grouped product's (rows, K, N): the gate and up projections of a
    forward share one key, the down projection has its own."""
    x, w = args[:2]
    return (x.shape[0], w.shape[1], w.shape[2])


class StepClock:
    """Wall seconds (with a device sync at the end of each call) of every
    call to ``module.name`` while entered, with the card to itself."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name = module, name
        self.seconds: list[float] = []

    def __enter__(self) -> "StepClock":
        import torch
        self.quiet = card_to_itself()
        self.quiet.__enter__()
        self.orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.orig)
        self.quiet.__exit__(*exc)


def top2_margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


class compute_dtype:
    """While entered, the port's dense layers, embedding, tied
    unembedding and MoE FFNs compute in ``dtype`` (their default is bf16,
    as in the reference)."""

    def __init__(self, dtype) -> None:
        self.dtype = dtype

    def __enter__(self) -> None:
        from repro_torch.models import layers, moe
        self.saved = (layers.dense.__kwdefaults__["compute_dtype"],
                      layers.embed.__defaults__, layers.unembed.__defaults__,
                      moe.moe_ffn.__kwdefaults__["compute_dtype"])
        layers.dense.__kwdefaults__["compute_dtype"] = self.dtype
        layers.embed.__defaults__ = (self.dtype,)
        layers.unembed.__defaults__ = (self.dtype,
                                       layers.unembed.__defaults__[1])
        for fn in (moe.moe_ffn, moe.moe_ffn_capacity):
            fn.__kwdefaults__["compute_dtype"] = self.dtype

    def __exit__(self, *exc) -> None:
        from repro_torch.models import layers, moe
        layers.dense.__kwdefaults__["compute_dtype"] = self.saved[0]
        layers.embed.__defaults__ = self.saved[1]
        layers.unembed.__defaults__ = self.saved[2]
        for fn in (moe.moe_ffn, moe.moe_ffn_capacity):
            fn.__kwdefaults__["compute_dtype"] = self.saved[3]


def ragged_calls(cfg) -> int:
    """The grouped products of one forward: three per MoE layer on the
    ragged path (gate, up, down), none on the capacity path."""
    return 3 * cfg.n_layers if cfg.family == "moe" and \
        cfg.moe_impl == "ragged" else 0


def ssd_calls(cfg) -> int:
    """The SSD scans of one forward: one per Mamba2 layer."""
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def attention_calls(cfg) -> int:
    """The flash-capable attention calls of one forward: zamba2's
    shared-block invocations, or one per GQA layer (MLA takes the plain
    masked product)."""
    from repro_torch.models import transformer as T
    if cfg.family == "hybrid":
        return T.n_hybrid_attn_invocations(cfg)
    return cfg.n_layers if cfg.family in ("dense", "moe") and \
        cfg.attn_kind == "gqa" else 0


def free_model() -> None:
    """Return a freed model's memory to the card before the next one."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def teacher_forced(cfg, model, dev, wave, forced, s_max, cache_dtype):
    """Prefill ``wave`` into a cache of ``cache_dtype``, then decode the
    ``forced`` tokens one by one; each step's logits against the
    no-cache forward's at the same position.  Per step: the max abs
    error, its ratio to the reference's criterion for the family
    (assert_allclose with atol = rtol = `FAMILY_TOL`,
    tests/test_models.py:100-106), the number of rows whose no-cache
    top-2 margin exceeds twice `LOGIT_TOL` and how many of those pick
    another argmax."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    tol = FAMILY_TOL[cfg.family]
    seq = torch.cat([wave, forced], dim=1)
    with torch.inference_mode():
        full, _, _ = T.forward(cfg, model, {"tokens": seq})
    # Only the positions compared: the last prompt token's and on.
    full = full[:, wave.shape[1] - 1:].clone()
    out = dict(max_abs_err=[], tol_ratio=[], max_abs_logit=0.0,
               clear_rows=[], argmax_flips=[])

    def compare(got, want) -> None:
        diff = (got - want).abs()
        out["max_abs_err"].append(float(diff.max()))
        out["tol_ratio"].append(float((diff / (tol + tol * want.abs())).max()))
        out["max_abs_logit"] = max(out["max_abs_logit"],
                                   float(want.abs().max()))
        clear = top2_margin(want) > 2 * LOGIT_TOL
        flips = got.argmax(-1) != want.argmax(-1)
        out["clear_rows"].append(int(clear.sum()))
        out["argmax_flips"].append(int((clear & flips).sum()))

    cache = M.init_cache(cfg, wave.shape[0], s_max, dtype=cache_dtype,
                         device=dev)
    logits, cache = M.prefill_step(cfg, model, {"tokens": wave}, cache)
    out["first_token"] = logits[:, -1].argmax(-1).cpu()
    compare(logits[:, -1], full[:, 0])
    for t in range(forced.shape[1] - 1):
        _, logits, cache = M.serve_step(
            cfg, model, {"tokens": forced[:, t:t + 1]}, cache)
        compare(logits[:, -1], full[:, t + 1])
    return out


def llm_serve(cfg, model, dev, extra: dict) -> tuple[dict, dict]:
    """`WaveServer` over two waves, with the launch counts read around
    them; then teacher-forced prefill and decode against the no-cache
    forward.  Emits the phase's line (with ``extra``) before its checks.
    Returns the row and the waves' captured kernel inputs ("ssd_serve",
    "ragged_serve")."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ragged_dot import ops as rd_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import layers
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    tol = FAMILY_TOL[cfg.family]
    n_ssd, n_rd = ssd_calls(cfg), ragged_calls(cfg)
    s_max = SERVE_PROMPT + SERVE_NEW + 8
    server = WaveServer(cfg, model, slots=SERVE_SLOTS, s_max=s_max)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT), dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Capture(ssd_ops, "ssd") as cap, \
            Capture(rd_ops, "ragged_dot", key=by_projection,
                    clone=False) as rd_cap, \
            StepClock(M, "prefill_step") as pre, \
            StepClock(M, "serve_step") as dec, \
            StepClock(layers, "unembed") as unembed:
        reset_launches()
        t0 = time.perf_counter()
        outs = [server.run_wave(prompts[lo:lo + SERVE_SLOTS], SERVE_NEW)
                for lo in range(0, SERVE_REQUESTS, SERVE_SLOTS)]
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in LLM_KEYS}
    peak = torch.cuda.max_memory_allocated()
    tokens = np.concatenate(outs)
    check(tokens.shape == (SERVE_REQUESTS, SERVE_NEW),
          f"served tokens {tokens.shape}")

    # Teacher-forced: the first wave's prompts and the tokens it got.
    wave = torch.from_numpy(prompts[:SERVE_SLOTS]).to(dev)
    forced = torch.from_numpy(tokens[:SERVE_SLOTS, :8]).to(dev)
    # Each teacher-forced run with the launch counts read around it: its
    # no-cache forwards and its prefill take `ssd` on the run's dtype.
    tf, tf_launches = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        with compute_dtype(dtype):
            reset_launches()
            tf[name] = teacher_forced(cfg, model, dev, wave, forced, s_max,
                                      dtype)
            tf_launches[name] = {k: LAUNCHES[k] for k in LLM_KEYS}
    first_token = tf["bf16"].pop("first_token")
    tf["fp32"].pop("first_token")
    # Where a wave's time goes: one more prefill and 8 decode steps under
    # the profiler, against their unprofiled walls above.
    cache = M.init_cache(cfg, SERVE_SLOTS, s_max, device=dev)

    def prefill_once():
        return M.prefill_step(cfg, model, {"tokens": wave}, cache)

    def decode_8():
        for t in range(forced.shape[1]):
            M.serve_step(cfg, model, {"tokens": forced[:, t:t + 1]}, cache)

    prof_pre = device_profile(prefill_once)
    prof_dec = device_profile(decode_8)
    n_dec = SERVE_SLOTS * (SERVE_NEW - 1)
    dec_s = [sum(dec.seconds[i * (SERVE_NEW - 1):(i + 1) * (SERVE_NEW - 1)])
             for i in range(2)]
    step_ms = 1e3 * sum(dec_s) / (2 * (SERVE_NEW - 1))
    row = dict(arch=cfg.name, slots=SERVE_SLOTS, requests=SERVE_REQUESTS,
               prompt=SERVE_PROMPT, new=SERVE_NEW, launches=launches,
               wall_s=wall, prefill_s=pre.seconds[:2], decode_s=dec_s,
               prefill_tokens_per_s=[SERVE_SLOTS * SERVE_PROMPT / t
                                     for t in pre.seconds[:2]],
               decode_tokens_per_s=[n_dec / t for t in dec_s],
               decode_step_ms_mean=step_ms, peak_mem_bytes=peak,
               teacher_forced=tf, teacher_forced_launches=tf_launches,
               prefill_profile=dict(
                   prof_pre, busy_share=None if prof_pre["device_ms"] is None
                   else prof_pre["device_ms"] / (1e3 * pre.seconds[1])),
               decode_profile_8_steps=dict(
                   prof_dec, busy_share=None if prof_dec["device_ms"] is None
                   else prof_dec["device_ms"] / (forced.shape[1] * step_ms)),
               tolerance=dict(atol=tol, rtol=tol),
               argmax_margin=2 * LOGIT_TOL,
               sample=tokens[0, :8].tolist())
    if unembed.seconds:
        # The tied unembedding's walls (each ends in a device sync): the
        # first call of each wave is its prefill's, the rest decode's.
        per_wave = [unembed.seconds[i * SERVE_NEW:(i + 1) * SERVE_NEW]
                    for i in range(2)]
        row["tied_unembed"] = dict(
            prefill_s=[w[0] for w in per_wave],
            decode_ms_mean=1e3 * sum(sum(w[1:]) for w in per_wave)
            / (2 * (SERVE_NEW - 1)),
            decode_share=sum(sum(w[1:]) for w in per_wave) / sum(dec_s))
    row["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="llm-serve", **extra, **row))
    check(((tokens >= 0) & (tokens < cfg.vocab)).all(), "token out of range")
    for name in ("ssd", "ssd_bf16"):
        check(launches[name] == 2 * n_ssd,
              f"{name} launched {launches[name]} times, expected "
              f"{2 * n_ssd} ({n_ssd} per prefill wave, bf16)")
    check(launches["flash_attention"] == 0,
          f"flash_attention launched {launches['flash_attention']} times "
          f"in serving; the cached prefill takes sdpa")
    # A wave is SERVE_NEW forwards: its prefill and SERVE_NEW - 1 steps;
    # every grouped product on the TMA + wgmma kernel.
    for name in ("ragged_dot", "ragged_dot_wgmma"):
        check(launches[name] == 2 * SERVE_NEW * n_rd,
              f"{name} launched {launches[name]} times in serving, "
              f"expected {2 * SERVE_NEW * n_rd} ({n_rd} a forward, bf16)")
    # A teacher-forced run is its no-cache forward, its prefill and one
    # step for each forced token but the last.
    tf_forwards = 2 + forced.shape[1] - 1
    for name, counts in tf_launches.items():
        want = {k: 0 for k in LLM_KEYS}
        want.update({"ssd": 2 * n_ssd, f"ssd_{name}": 2 * n_ssd,
                     "ragged_dot": tf_forwards * n_rd})
        want.update({f"ragged_dot_{r}": tf_forwards * n_rd
                     for r in RAGGED_ROUTE[name]})
        check(counts == want,
              f"the {name} teacher-forced run launched {counts}, expected "
              f"{want} ({n_ssd} ssd in its forward, {n_ssd} in its "
              f"prefill; {n_rd} ragged_dot in each of its {tf_forwards} "
              f"forwards)")
    check(torch.equal(first_token,
                      torch.from_numpy(tokens[:SERVE_SLOTS, 0]).long()),
          "a replayed prefill disagrees with the served first token")
    fp32, bf16 = tf["fp32"], tf["bf16"]
    check(max(fp32["tol_ratio"]) <= 1.0,
          f"fp32 teacher-forced logits differ from the no-cache forward by "
          f"{max(fp32['max_abs_err']):.4f} (atol = rtol = {tol})")
    # With a tied unembedding the logits reach tens (the table's rows
    # are N(0, 1)), and one bf16 ulp of the final hidden state moves a
    # logit by about 0.1: the bf16 prefill is held to the tolerance only
    # where the unembedding is untied; everywhere to the argmax rule.
    if not cfg.tie_embeddings:
        check(bf16["tol_ratio"][0] <= 1.0,
              f"bf16 prefill logits differ from the no-cache forward by "
              f"{bf16['max_abs_err'][0]:.4f} (atol = rtol = {tol})")
    check(sum(bf16["argmax_flips"]) == 0,
          f"bf16 teacher-forced decode picks another token than the "
          f"no-cache forward at {sum(bf16['argmax_flips'])} of "
          f"{sum(bf16['clear_rows'])} rows whose top-2 margin exceeds "
          f"{2 * LOGIT_TOL}")
    return row, {"ssd_serve": cap, "ragged_serve": rd_cap}


def llm_forward_long(cfg, model, dev, extra: dict):
    """The no-cache forward at (1, LONG_SEQ) with the launch counts read
    around it; flash calls are captured by window.  Emits the phase's
    line (with ``extra``) before its checks."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ragged_dot import ops as rd_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LONG_SEQ), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Capture(fa_ops, "flash_attention", key=by_window) as fa_cap, \
            Capture(ssd_ops, "ssd") as ssd_cap, \
            Capture(rd_ops, "ragged_dot", key=by_projection,
                    clone=False) as rd_cap, \
            StepClock(layers, "unembed") as unembed, torch.inference_mode():
        reset_launches()
        t0 = time.perf_counter()
        logits, _, _ = T.forward(cfg, model, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in LLM_KEYS}
    finite = bool(torch.isfinite(logits).all())
    row = dict(arch=cfg.name, seq=LONG_SEQ, launches=launches, wall_s=wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               logits_shape=list(logits.shape), finite=finite,
               flash_calls_by_window={str(w): n for w, n in
                                      fa_cap.counts.items()})
    if unembed.seconds:
        row["tied_unembed_s"] = unembed.seconds[0]
        row["tied_unembed_share"] = unembed.seconds[0] / wall
    del logits
    emit(dict(phase="llm-forward-long", **extra, **row))
    n_attn, n_ssd = attention_calls(cfg), ssd_calls(cfg)
    for name in ("flash_attention", "flash_attention_bf16"):
        check(launches[name] == n_attn,
              f"{name} launched {launches[name]} times, expected {n_attn}")
    for name in ("ragged_dot", "ragged_dot_wgmma"):
        check(launches[name] == ragged_calls(cfg),
              f"{name} launched {launches[name]} times, expected "
              f"{ragged_calls(cfg)}")
    if n_attn and cfg.family in ("dense", "moe"):
        windows = T.layer_windows(cfg) if cfg.sliding_window is not None \
            else np.zeros(cfg.n_layers, np.int32)
        want = {int(w): int((windows == w).sum()) for w in set(windows)}
        check(fa_cap.counts == want,
              f"flash calls by window {fa_cap.counts}, expected {want}")
    for name in ("ssd", "ssd_bf16"):
        check(launches[name] == n_ssd,
              f"{name} launched {launches[name]} times, expected {n_ssd}")
    check(finite, "the long forward gave a non-finite logit")
    return row, {"flash_long": fa_cap, "ssd_long": ssd_cap,
                 "ragged_long": rd_cap}


def llm_dense_widths(dev, card: str) -> tuple[list, dict]:
    """The dense configs beyond gemma3 at their published widths, cut to
    `DENSE_WIDTH_REDUCED`: a no-cache forward at (1, LONG_SEQ), which
    takes flash attention once a layer, and a `WaveServer` wave of
    `SERVE_SLOTS` prompts of `SERVE_PROMPT` tokens with
    `DENSE_WIDTH_NEW` - 1 decode steps, which takes no kernel (the
    cached prefill and the steps take sdpa).  Emits the phase's line
    before its checks; returns the rows and each config's flash
    capture."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    rows, caps = [], {}
    for arch in DENSE_WIDTH_ARCHS:
        cfg = dataclasses.replace(get_config(arch), **DENSE_WIDTH_REDUCED)
        model = M.init_params(cfg, 0, device=dev)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (1, LONG_SEQ), dtype=np.int32)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with Capture(fa_ops, "flash_attention") as cap, \
                torch.inference_mode():
            reset_launches()
            t0 = time.perf_counter()
            logits, _, _ = T.forward(cfg, model, {"tokens": toks})
            torch.cuda.synchronize()
            long_wall = time.perf_counter() - t0
            long_launches = {k: LAUNCHES[k] for k in LLM_KEYS}
        finite = bool(torch.isfinite(logits).all())
        long_peak = torch.cuda.max_memory_allocated()
        del logits
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT), dtype=np.int32)
        server = WaveServer(cfg, model, slots=SERVE_SLOTS,
                            s_max=SERVE_PROMPT + DENSE_WIDTH_NEW + 8)
        reset_launches()
        t0 = time.perf_counter()
        tokens = server.run_wave(prompts, DENSE_WIDTH_NEW)
        wave_wall = time.perf_counter() - t0
        wave_launches = {k: LAUNCHES[k] for k in LLM_KEYS}
        caps[arch] = cap
        rows.append(dict(
            arch=arch, reduced=DENSE_WIDTH_REDUCED,
            params=sum(p.numel() for p in model.parameters()),
            heads=f"{cfg.n_heads}:{cfg.n_kv_heads} D={cfg.head_dim}",
            long=dict(seq=LONG_SEQ, wall_s=long_wall,
                      launches=long_launches, peak_mem_bytes=long_peak,
                      finite=finite),
            wave=dict(prompts=list(prompts.shape), new=DENSE_WIDTH_NEW,
                      wall_s=wave_wall, launches=wave_launches,
                      tokens_in_range=bool(((tokens >= 0) &
                                            (tokens < cfg.vocab)).all()),
                      shape=list(tokens.shape))))
        del model, server
        free_model()
    emit(dict(phase="llm-dense-widths", card=card, runs=rows,
              seconds=time.perf_counter() - t_phase))
    for r in rows:
        n = DENSE_WIDTH_REDUCED["n_layers"]
        for name in ("flash_attention", "flash_attention_bf16"):
            check(r["long"]["launches"][name] == n,
                  f"{r['arch']}: {name} launched "
                  f"{r['long']['launches'][name]} times, expected {n}")
        check(r["long"]["launches"]["ssd"] == 0, f"{r['arch']}: ssd ran")
        check(r["long"]["finite"], f"{r['arch']}: a non-finite logit")
        check(all(c == 0 for c in r["wave"]["launches"].values()),
              f"{r['arch']}: the wave launched {r['wave']['launches']}; "
              f"the cached prefill and the steps take sdpa")
        check(r["wave"]["tokens_in_range"] and
              r["wave"]["shape"] == [SERVE_SLOTS, DENSE_WIDTH_NEW],
              f"{r['arch']}: the wave's tokens {r['wave']['shape']}")
    return rows, caps


# ------------------------------------------------ the moe family
def ragged_err(got, want) -> tuple[float, bool]:
    """(max |d|, within `RAGGED_ATOL` + `RAGGED_RTOL` |want| for the
    dtype)."""
    d = (got.float() - want.float()).abs()
    if d.numel() == 0:
        return 0.0, True
    rtol = RAGGED_RTOL[str(want.dtype).split(".")[1]]
    ok = bool((d <= RAGGED_ATOL + rtol * want.float().abs()).all())
    return float(d.max()), ok


def ragged_inputs(m, k, n, sizes, gen, dev, offset=False, dtype=None):
    """x (m, k) in ``dtype`` (bf16 unless given) and w (G, k, n) in fp32
    (the expert stacks as the model stores them), ~ N(0, 1) and
    N(0, 1/k), and the int32 offsets of ``sizes`` (a list, or
    ("random", G): m rows dealt to G groups at random, some of them
    empty)."""
    import numpy as np
    import torch
    if isinstance(sizes, tuple):
        groups = sizes[1]
        p = np.random.default_rng(m + k + n).dirichlet(np.ones(groups))
        p[::5] = 0.0
        sizes = np.random.default_rng(m).multinomial(m, p / p.sum())
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32, device=dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(
        dtype or torch.bfloat16)
    if offset:
        x = _at_offset(x)
    w = torch.randn((len(sizes), k, n), generator=gen, device=dev) \
        * k ** -0.5
    return x, w, offs


def ragged_route(x, w, offset=False) -> str:
    """The kernel `ragged_dot` must take: fp32 x the TF32 tensor cores
    where TMA takes the rows (K and N multiples of 4, x on 16 bytes),
    else the CUDA cores; bf16 x the TMA + wgmma kernel where TMA takes the
    rows (K a multiple of 8, N of 4 for fp32 weights or 8 for bf16, x on
    16 bytes), else mma.sync."""
    import torch
    if x.dtype == torch.float32:
        aligned = x.shape[1] % 4 == 0 and w.shape[2] % 4 == 0
        return "fp32_tc" if aligned and not offset else "fp32_cores"
    units = 4 if w.dtype == torch.float32 else 8
    aligned = x.shape[1] % 8 == 0 and w.shape[2] % units == 0
    return "wgmma" if aligned and not offset else "mma"


def ragged_vs_plain(dev) -> dict:
    """`ragged_dot` on the card against its plain version on the card, on
    `RAGGED_CASES` with bf16 x and fp32 weights (the path's types; the
    kernel rounds the weights on load), each also on the same weights
    cast to bf16 first, which must give the same bits where both calls
    take the same kernel, and on the mma.sync kernel by name; with x 2
    elements into its storage (the mma.sync kernel's plain loads); but
    for the largest, in fp32 (the fp32 compute mode's route); with
    offsets that leave rows before the first group and past the last
    (written as zeros); and one call under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on a host
    sync.  Every call must add one launch, on the route it should take
    (`ragged_route`; fp32 also to ``ragged_dot_fp32``).  fp32 results are
    held to the plain version's float64 sums (`plain_acc`)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def call(x, w, offs, route=None, offset=False):
        want_route = route or ragged_route(x, w, offset)
        before = dict(LAUNCHES)
        got = ragged_dot(x, w, offs, route=route)
        torch.cuda.synchronize()
        keys = ["ragged_dot", f"ragged_dot_{want_route}"] + (
            ["ragged_dot_fp32"] if x.dtype == torch.float32 else [])
        launched = tuple(LAUNCHES[k] - before[k] for k in keys)
        check(launched == (1,) * len(keys),
              f"ragged_dot {tuple(x.shape)} x {tuple(w.shape)} "
              f"{w.dtype}: launches {launched} on {want_route}")
        return got, want_route

    runs = [(c, False, torch.bfloat16) for c in RAGGED_CASES] + \
        [(RAGGED_CASES[1], True, torch.bfloat16)] + \
        [(c, False, torch.float32) for c in RAGGED_CASES
         if c[0] * c[1] * c[2] < 1e10]
    for (m, k, n, sizes), offset, dtype in runs:
        x, w, offs = ragged_inputs(m, k, n, sizes, gen, dev, offset, dtype)
        name = str(dtype).split(".")[1]
        got, route = call(x, w, offs, offset=offset)
        err, ok = ragged_err(got, ragged_dot_ref(x, w, offs,
                                                 acc=plain_acc(x)))
        row = dict(m=m, k=k, n=n, groups=w.shape[0], dtype=name,
                   route=route, empty_groups=int((offs.diff() == 0).sum()),
                   x_at_offset_2=offset, max_abs_err=err)
        if dtype == torch.bfloat16:
            wb = w.to(torch.bfloat16)
            got_b, route_b = call(x, wb, offs, offset=offset)
            row["bf16_weights_route"] = route_b
            row["bit_equal_bf16_weights"] = bool(torch.equal(got, got_b)) \
                if route_b == route else None
            check(row["bit_equal_bf16_weights"] is not False,
                  f"ragged_dot ({m}, {k}, {n}) on {route}: fp32 weights "
                  f"rounded on load differ from the same weights cast "
                  f"first")
            if route == "wgmma":
                got_m, _ = call(x, w, offs, route="mma")
                row["mma_max_abs_err"], ok_m = ragged_err(
                    got_m, ragged_dot_ref(x, w, offs))
                ok = ok and ok_m
        cases.append(row)
        check(ok, f"ragged_dot ({m}, {k}, {n}, {w.shape[0]} groups, {name}, "
                  f"offset {offset}, {route}): max |d| {err}")
    x, w, _ = ragged_inputs(300, 64, 96, [100, 100, 100], gen, dev)
    offs = torch.tensor([20, 120, 120, 250], dtype=torch.int32, device=dev)
    got, route = call(x, w, offs)
    err, ok = ragged_err(got, ragged_dot_ref(x, w, offs))
    outside = bool((got[:20] == 0).all() and (got[250:] == 0).all())
    cases.append(dict(m=300, k=64, n=96, offsets=offs.tolist(), route=route,
                      max_abs_err=err, rows_outside_zero=outside))
    check(ok and outside, f"ragged_dot with rows outside the groups: "
                          f"max |d| {err}, zeros {outside}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ragged_dot(x, w, offs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(cases=cases, no_host_sync=True,
                max_abs_err=max(c["max_abs_err"] for c in cases
                                if c.get("dtype") != "float32"),
                max_abs_err_fp32=max(c["max_abs_err"] for c in cases
                                     if c.get("dtype") == "float32"))


def tol_ratio(got, want, rtol: float) -> float:
    """The largest |got - want| over its tolerance, RAGGED_ATOL + rtol
    |want| (at most 1 within it)."""
    d = (got.double() - want.double()).abs()
    if d.numel() == 0:
        return 0.0
    return float((d / (RAGGED_ATOL + rtol * want.double().abs())).max())


def plain_acc(x):
    """The sums of the plain version that the card's `ragged_dot` results
    are held to: float64 for fp32 x (the exact sums rounded once: the
    plain version's own fp32 sums, taken in row order, part from them by
    more than the fp32 tolerance in dw over 2000-row groups, which
    ragged-dot-bwd-vs-plain's ``plain_fp32_tol_ratio`` shows), fp32 for
    bf16 x (the kernels' own)."""
    import torch
    return torch.float64 if x.dtype == torch.float32 else torch.float32


def ragged_bound(m, k, n, groups_used, groups, w_bytes=4) -> dict:
    """The least time of the grouped product: 2 m k n FLOP at the bf16
    tensor-core rate, against x, the weights of the groups this input
    uses at ``w_bytes`` an element, y and the offsets, each moved
    once."""
    flop = 2 * m * k * n
    nbytes = 2 * (m * k + m * n) + w_bytes * groups_used * k * n + \
        4 * (groups + 1)
    t_ops, t_bytes = flop / PEAK_BF16_S, nbytes / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flop=flop, bytes=nbytes)


def ragged_fp32_smoke(dev, gen) -> list:
    """(label, x, w, offsets, dy) of each grouped product of
    `FP32_RAGGED_SMOKE`'s smoke configs, fp32."""
    import torch
    from repro_torch.configs import get_smoke_config
    out = []
    for arch, (batch, seq) in FP32_RAGGED_SMOKE:
        cfg = get_smoke_config(arch)
        m, groups = batch * seq * cfg.top_k, cfg.n_experts
        sizes = torch.multinomial(torch.ones(groups, device=dev), m,
                                  replacement=True, generator=gen)
        sizes = sizes.bincount(minlength=groups)
        offs = torch.cat([sizes.new_zeros(1), sizes.cumsum(0)]).int()
        for label, k, n in (("gate/up", cfg.d_model, cfg.moe_d_ff),
                            ("down", cfg.moe_d_ff, cfg.d_model)):
            x = torch.randn((m, k), generator=gen, device=dev)
            w = torch.randn((groups, k, n), generator=gen,
                            device=dev) * k ** -0.5
            dy = torch.randn((m, n), generator=gen, device=dev)
            out.append((f"{arch} smoke {label}", x, w, offs, dy))
    return out


def ragged_fp32_library(part: str, x, w, offs, dy):
    """``torch._grouped_mm`` computing ``part`` ("fwd", "dx" or "dw") of
    the fp32 grouped product on the fp32 operands, a yardstick off the
    path (the card's torch takes fp32 operands)."""
    import torch
    ends = offs[1:]
    return {"fwd": lambda: torch._grouped_mm(x, w, offs=ends),
            "dx": lambda: torch._grouped_mm(dy, w.transpose(-2, -1),
                                            offs=ends),
            "dw": lambda: torch._grouped_mm(x.t(), dy, offs=ends)}[part]


def ragged_fp32_row(label: str, part: str, x, w, offs, dy) -> tuple:
    """``part`` ("fwd", "dx" or "dw") of the fp32 route at one shape: one
    call that must launch the TF32 tensor-core kernels (its ``_fp32_tc``
    key; every path shape takes them), its error against the plain
    version's float64 sums (`plain_acc`, checked) and, beside it, against
    the plain version's fp32 sums, and the kernel's and the fp32 plain
    version's largest share of the tolerance from the float64 sums
    (`tol_ratio`); ms and the kernel's own device ms
    under the profiler (at the smoke shapes the wrapper's host time
    exceeds the kernel's), the first CUDA-core kernel's ms where quoted
    (`RAGGED_FP32_EARLIER_MS`), the plain version's ms,
    bounds (2 m k n FLOP at three TF32 passes, the least the card could
    take for an fp32 result, and at the CUDA cores' fp32 rate; each
    against the bytes moved once) and the library's ms and error
    (`ragged_fp32_library`).  Returns (the row, the forward launches it
    made)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ragged_dot import ops as rd_ops
    from repro_torch.kernels.ragged_dot.ref import (ragged_dot_dw_ref,
                                                    ragged_dot_dx_ref,
                                                    ragged_dot_ref)
    m, k = x.shape
    groups, _, n = w.shape
    used = int((offs.diff() > 0).sum())
    if part == "fwd":
        key = "ragged_dot_fp32_tc"

        def kernel():
            return rd_ops.ragged_dot(x, w, offs)

        def plain(acc=torch.float32):
            return ragged_dot_ref(x, w, offs, acc=acc)
        nbytes = 4 * (m * k + m * n + used * k * n + groups + 1)
    else:
        key = "ragged_dot_bwd_fp32_tc"
        bit = 1 if part == "dx" else 2

        def kernel():
            return rd_ops._launch_bwd(x, w, offs, dy, parts=bit)[bit - 1]

        def plain(acc=torch.float32):
            return (ragged_dot_dx_ref if bit == 1 else ragged_dot_dw_ref)(
                x, w, offs, dy, acc=acc)
        nbytes = ragged_bwd_bound(part, m, k, n, used, groups, 4,
                                  4)["bytes"]
    before = LAUNCHES[key]
    got = rd_ops.ragged_dot(x, w, offs) if part == "fwd" else \
        rd_ops.ragged_dot_bwd(x, w, offs, dy)[bit - 1]
    check(LAUNCHES[key] == before + 1,
          f"ragged_dot fp32 {part} at {label}: {key} launched "
          f"{LAUNCHES[key] - before} times in one call")
    want = plain(plain_acc(x))
    d = (got - want).abs()
    err = float(d.max()) if d.numel() else 0.0
    ok = bool((d <= RAGGED_ATOL + RAGGED_RTOL["float32"] * want.abs()).all())
    check(ok, f"ragged_dot fp32 {part} at {label}: max |d| {err}")
    want32 = plain()
    d = (got - want32).abs()
    err32 = float(d.max()) if d.numel() else 0.0
    ratios = dict(tol_ratio=tol_ratio(got, want, RAGGED_RTOL["float32"]),
                  plain_fp32_tol_ratio=tol_ratio(want32, want,
                                                 RAGGED_RTOL["float32"]))
    lib = ragged_fp32_library(part, x, w, offs, dy)
    d = (lib() - want).abs()
    lib_err = float(d.max()) if d.numel() else 0.0
    del got, want, want32, d
    flop = 2 * m * k * n
    t_bytes = nbytes / PEAK_BYTES_S
    t_tf32, t_fp32 = 3 * flop / PEAK_TF32_S, flop / PEAK_OPS_S
    earlier = RAGGED_FP32_EARLIER_MS.get((label, part))
    row = dict(case=label, part=part, m=m, k=k, n=n, groups=groups,
               groups_used=used, x="float32", w="float32", route="fp32",
               kernel="fp32_tc", max_abs_err=err,
               max_abs_err_vs_fp32_plain=err32, **ratios,
               ms=cuda_ms(kernel, FP32_RAGGED_REPS),
               device_ms=device_profile(
                   lambda: [kernel() for _ in range(FP32_RAGGED_PROFILED)],
                   calls=FP32_RAGGED_PROFILED)["device_ms"],
               earlier_ms=earlier,
               earlier_ms_from=RAGGED_FP32_EARLIER_FROM if earlier else None,
               plain_ms=cuda_ms(plain, 1),
               bound_ms=1e3 * max(t_tf32, t_bytes),
               bound_by="operations" if t_tf32 >= t_bytes else "bytes",
               bound_fp32_rate_ms=1e3 * max(t_fp32, t_bytes),
               flop=flop, bytes=nbytes,
               library_ms=cuda_ms(lib, FP32_RAGGED_REPS),
               library=f"torch._grouped_mm on the fp32 operands, allow_tf32 "
                       f"{torch.backends.cuda.matmul.allow_tf32}",
               library_max_abs_err=lib_err)
    return row, (2 + FP32_RAGGED_REPS + FP32_RAGGED_PROFILED
                 if part == "fwd" else 0)


def ragged_path(arch: str, cfg, caps: dict) -> list:
    """`ragged_dot` at each grouped product the arch's path gave (the
    serving waves' prefill and decode, the long forward's; gate and up
    share a shape, down has its own), on the model's fp32 expert stacks,
    while the model is on the card: the error against the plain version
    (checked), the same call on the stacks cast to bf16 first (the same
    bits, checked), ms (CUDA events, after warm-up) on fp32 weights and
    on bf16 ones, the earlier kernel's ms (mma.sync, by name) on bf16
    weights and with the cast, the plain version's ms, two bounds
    (weights at 4 bytes, the call's own inputs, and at 2), and library
    yardsticks on the same inputs, never used by the port:
    ``torch._grouped_mm`` (it takes the offsets on the card) on the bf16
    weights and timed with the cast, and a loop of ``torch.matmul`` over
    the groups (which reads the offsets back first, inside the timed
    call).  The launch counts by route must equal the calls made here."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref
    rows, calls = [], {"wgmma": 0, "mma": 0, "fp32": 0}
    first = None
    reset_launches()
    for source, cap in caps.items():
        for (m, k, n), (args, _) in cap.calls.items():
            x, w, offs = args
            stage = source if source == "long" else \
                ("decode" if m <= SERVE_SLOTS * cfg.top_k else "prefill")
            label = f"{stage} {'gate/up' if k == cfg.d_model else 'down'}"
            if label == "prefill gate/up" and first is None:
                first = (x, w, offs)
            got = ragged_dot(x, w, offs)
            err, ok = ragged_err(got, ragged_dot_ref(x, w, offs))
            check(ok, f"ragged_dot at {arch}'s {label} ({m}, {k}, {n}): "
                      f"max |d| {err}")
            wb = w.to(torch.bfloat16)
            same = bool(torch.equal(got, ragged_dot(x, wb, offs)))
            check(same, f"ragged_dot at {arch}'s {label}: fp32 stacks "
                        f"rounded on load differ from the stacks cast first")
            del got
            reps = 20 if m >= 1000 else 50
            row = dict(arch=arch, label=label, m=m, k=k, n=n,
                       groups=w.shape[0], weights=str(w.dtype),
                       max_abs_err=err, bit_equal_bf16_weights=same,
                       calls_in_path=cap.counts[(m, k, n)],
                       ms=cuda_ms(lambda: ragged_dot(x, w, offs), reps),
                       ms_bf16_weights=cuda_ms(
                           lambda: ragged_dot(x, wb, offs), reps),
                       earlier_ms=cuda_ms(
                           lambda: ragged_dot(x, wb, offs, route="mma"),
                           reps),
                       earlier_with_cast_ms=cuda_ms(
                           lambda: ragged_dot(x, w.to(torch.bfloat16), offs,
                                              route="mma"), reps),
                       plain_ms=cuda_ms(lambda: ragged_dot_ref(x, w, offs),
                                        2))
            calls["wgmma"] += 4 + 2 * reps
            calls["mma"] += 2 + 2 * reps
            try:
                lib = torch._grouped_mm(x, wb, offs=offs[1:])
                row.update(
                    library="torch._grouped_mm",
                    library_max_abs_err=ragged_err(
                        lib, ragged_dot_ref(x, w, offs))[0],
                    library_ms=cuda_ms(
                        lambda: torch._grouped_mm(x, wb, offs=offs[1:]),
                        reps),
                    library_cast_ms=cuda_ms(
                        lambda: torch._grouped_mm(
                            x, w.to(torch.bfloat16), offs=offs[1:]), reps))
                del lib
            except (RuntimeError, TypeError) as e:
                row.update(library="torch._grouped_mm", library_ms=None,
                           library_cast_ms=None, library_error=str(e)[:200])

            def loop():
                bounds = offs.tolist()
                out = torch.empty((m, n), dtype=x.dtype, device=x.device)
                for g in range(w.shape[0]):
                    lo, hi = bounds[g], bounds[g + 1]
                    if hi > lo:
                        torch.matmul(x[lo:hi], wb[g], out=out[lo:hi])
                return out

            used = int((offs.diff() > 0).sum())
            bf16_bound = ragged_bound(m, k, n, used, w.shape[0], w_bytes=2)
            row.update(library_loop_ms=cuda_ms(loop, reps),
                       groups_used=used,
                       **ragged_bound(m, k, n, used, w.shape[0]),
                       bound_bf16_weights_ms=bf16_bound["bound_ms"],
                       bound_bf16_weights_by=bf16_bound["bound_by"])
            del wb
            rows.append(row)
    fp32_rows = []
    if arch == FP32_RAGGED_ARCH:
        gen = torch.Generator(device=first[0].device).manual_seed(30)
        x, w, offs = first
        for label, *args in [(f"{arch} prefill gate/up", x.float(), w, offs,
                              None)] + ragged_fp32_smoke(x.device, gen):
            row, made = ragged_fp32_row(label, "fwd", *args)
            fp32_rows.append(row)
            calls["fp32"] += made
    launched = {r: LAUNCHES[f"ragged_dot_{r}"] for r in calls}
    check(launched == calls and LAUNCHES["ragged_dot"] == sum(calls.values()),
          f"{arch}: ragged_dot launched {LAUNCHES['ragged_dot']} times, "
          f"{launched} by route, in {calls} calls")
    # Every fp32 call on the TF32 tensor cores.
    check(LAUNCHES["ragged_dot_fp32_tc"] == calls["fp32"],
          f"{arch}: {LAUNCHES['ragged_dot_fp32_tc']} of {calls['fp32']} "
          f"fp32 calls on the TF32 tensor cores")
    return rows, fp32_rows


def moe_capacity(cfg, model, dev) -> dict:
    """The capacity dispatch (``moe_impl="capacity"``) on the same model:
    a no-cache forward of `SERVE_SLOTS` x `SERVE_PROMPT` tokens with the
    launch counts read around it: `ragged_dot` never (the batched
    products are torch's, as the reference leaves them to XLA)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as T
    ccfg = dataclasses.replace(cfg, moe_impl="capacity")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT), dtype=np.int32)).to(dev)
    with torch.inference_mode():
        reset_launches()
        t0 = time.perf_counter()
        logits, aux, _ = T.forward(ccfg, model, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in LLM_KEYS}
    row = dict(arch=cfg.name, moe_impl="capacity",
               tokens=list(toks.shape), wall_s=wall, launches=launches,
               aux=float(aux), finite=bool(torch.isfinite(logits).all()))
    check(launches["ragged_dot"] == 0,
          f"the capacity path launched ragged_dot "
          f"{launches['ragged_dot']} times")
    check(row["finite"], "the capacity path gave a non-finite logit")
    return row


def llm_moe(dev, card: str, captured: dict) -> dict:
    """The moe family: each of `MOE_ARCHS` at its published widths (cut
    as `MOE_REDUCED` says) served by `WaveServer` (`llm_serve`), mixtral
    run long (`llm_forward_long`: flash with its window on every layer)
    and through the capacity dispatch (`moe_capacity`), then
    `ragged_dot` at every path shape (`ragged_path`) while the model is
    on the card; each model is freed before the next.  Emits each
    phase's line; the flash inputs join ``captured`` for phases 22-23."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as llm
    out = dict(serve={}, long={}, ragged=[], ragged_fp32=[], capacity=None)
    for arch in MOE_ARCHS:
        reduced = MOE_REDUCED[arch]
        cfg = dataclasses.replace(get_config(arch), **reduced)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = llm.init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        extra = dict(card=card, reduced=reduced,
                     init_s=time.perf_counter() - t0,
                     params=sum(p.numel() for p in model.parameters()),
                     allocated_after_init_bytes=torch.cuda.memory_allocated())
        out["serve"][arch], serve_caps = llm_serve(cfg, model, dev, extra)
        caps = {"serve": serve_caps["ragged_serve"]}
        del serve_caps
        if arch in MOE_LONG:
            out["long"][arch], long_caps = llm_forward_long(
                cfg, model, dev, dict(card=card, reduced=reduced))
            captured[arch] = {"flash_long": long_caps["flash_long"]}
            caps["long"] = long_caps["ragged_long"]
            del long_caps
            out["capacity"] = moe_capacity(cfg, model, dev)
            emit(dict(phase="llm-moe-capacity", card=card,
                      **out["capacity"]))
        rows, fp32_rows = ragged_path(arch, cfg, caps)
        emit(dict(phase="ragged-dot-path", card=card, arch=arch,
                  reduced=reduced, runs=rows, fp32_x=fp32_rows))
        out["ragged"] += rows
        out["ragged_fp32"] += fp32_rows
        del model, caps
        free_model()
    return out


def _run(fn, dev) -> tuple:
    """``fn()`` under inference mode with the launch counts reset just
    before and read just after: (its result, wall s, launches, peak
    device memory bytes)."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in LLM_KEYS}
    return out, wall, launches, torch.cuda.max_memory_allocated()


def _prefill_vs_forward(cfg, model, dev, batch, s_max) -> dict:
    """The cached prefill's last-position logits against the no-cache
    forward's, in bf16 and in fp32 compute (an fp32 cache for fp32):
    max |d| and its ratio to atol = rtol = the family's tolerance, with
    the launch counts read around each pair."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    tol = FAMILY_TOL[cfg.family]
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        def pair():
            full = T.forward(cfg, model, batch)[0][:, -1].clone()
            cache = M.init_cache(cfg, batch["tokens"].shape[0], s_max,
                                 dtype=dtype, device=dev)
            return full, M.prefill_step(cfg, model, batch, cache)[0][:, -1]

        with compute_dtype(dtype):
            (want, got), wall, launches, _ = _run(pair, dev)
        diff = (got - want).abs()
        out[name] = dict(max_abs_err=float(diff.max()),
                         tol_ratio=float((diff / (tol + tol * want.abs()))
                                         .max()),
                         max_abs_logit=float(want.abs().max()),
                         wall_s=wall, launches=launches)
    return out


def llm_encdec_vision(dev, card: str) -> tuple[dict, dict]:
    """The encdec and vision families at their published widths: whisper-
    tiny uncut (a no-cache forward and a wave), then qwen2-vl-72b cut as
    `VISION_REDUCED` says (the long no-cache forward, whose flash inputs
    are captured, and a wave); each model is freed after its runs.
    Emits the phase's line before its checks; returns the line and the
    flash capture."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import WaveServer, stub_embeddings
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    row = dict(card=card)

    # whisper-tiny: no kernel on its path (1500^2 and 384^2 are under
    # the flash threshold of 4096^2).
    cfg = get_config(ENCDEC_ARCH)
    model = M.init_params(cfg, 0, device=dev)
    audio = stub_embeddings(cfg, WHISPER_SLOTS, seed=1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (WHISPER_SLOTS, WHISPER_TEXT), dtype=np.int32)).to(dev)
    logits, wall, launches, peak = _run(
        lambda: T.forward(cfg, model, {"tokens": toks, **audio})[0], dev)
    fwd = dict(batch=WHISPER_SLOTS, enc_seq=cfg.enc_seq, text=WHISPER_TEXT,
               wall_s=wall, launches=launches, peak_mem_bytes=peak,
               logits_shape=list(logits.shape),
               finite=bool(torch.isfinite(logits).all()))
    # The same weights on the host, one sequence, fp32 compute on both.
    on_cpu = M.init_params(cfg, 0, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    one = {"tokens": toks[:1], "audio_embeds": audio["audio_embeds"][:1]}
    with compute_dtype(torch.float32), torch.inference_mode():
        card_logits = T.forward(cfg, model, one)[0].cpu()
        cpu_logits = T.forward(cfg, on_cpu, {
            k: v.cpu() for k, v in one.items()})[0]
    tol = FAMILY_TOL["dense"]
    diff = (card_logits - cpu_logits).abs()
    fwd["fp32_vs_cpu"] = dict(max_abs_err=float(diff.max()), tol_ratio=float(
        (diff / (tol + tol * cpu_logits.abs())).max()))
    del logits, on_cpu, card_logits, cpu_logits
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (WHISPER_SLOTS, WHISPER_TEXT), dtype=np.int32)
    server = WaveServer(cfg, model, slots=WHISPER_SLOTS,
                        s_max=WHISPER_TEXT + SERVE_NEW + 8)
    tokens, wall, launches, peak = _run(
        lambda: server.run_wave(prompts, SERVE_NEW, audio), dev)
    row[ENCDEC_ARCH] = dict(
        reduced={}, params=sum(p.numel() for p in model.parameters()),
        forward=fwd,
        wave=dict(slots=WHISPER_SLOTS, prompt=WHISPER_TEXT, new=SERVE_NEW,
                  s_max=server.s_max, wall_s=wall,
                  decode_tokens_per_s=WHISPER_SLOTS * SERVE_NEW / wall,
                  launches=launches, peak_mem_bytes=peak,
                  tokens_in_range=bool(((tokens >= 0) &
                                        (tokens < cfg.vocab)).all()),
                  shape=list(tokens.shape)),
        teacher_forced="not run: the served cache's cross_kv is zeros, "
                       "so the cached path never runs the encoder and "
                       "parts from the no-cache forward by design (a "
                       "reference quirk the port keeps)")
    del model, server
    free_model()

    # qwen2-vl-72b at 4 layers.
    cfg = dataclasses.replace(get_config(VISION_ARCH), **VISION_REDUCED)
    t0 = time.perf_counter()
    model = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tv = cfg.n_vision_tokens
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LONG_SEQ - tv), dtype=np.int32)).to(dev)
    long_batch = {"tokens": toks, **stub_embeddings(cfg, 1, seed=1)}
    with Capture(fa_ops, "flash_attention") as cap:
        logits, wall, launches, peak = _run(
            lambda: T.forward(cfg, model, long_batch)[0], dev)
    long = dict(seq=LONG_SEQ, vision=tv, text=LONG_SEQ - tv, wall_s=wall,
                launches=launches, peak_mem_bytes=peak,
                logits_shape=list(logits.shape),
                finite=bool(torch.isfinite(logits).all()),
                flash_calls=cap.counts.get(None, 0),
                flash_shapes=dict(q=list(cap.args[0].shape),
                                  k=list(cap.args[1].shape),
                                  window=cap.kwargs.get("window"),
                                  q_offset=cap.kwargs.get("q_offset", 0))
                if cap.args else None)
    del logits
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT), dtype=np.int32)
    vision = stub_embeddings(cfg, SERVE_SLOTS, seed=0)
    server = WaveServer(cfg, model, slots=SERVE_SLOTS,
                        s_max=tv + SERVE_PROMPT + SERVE_NEW + 8)
    tokens, wall, launches, peak = _run(
        lambda: server.run_wave(prompts, SERVE_NEW, vision), dev)
    wave = dict(slots=SERVE_SLOTS, vision=tv, prompt=SERVE_PROMPT,
                new=SERVE_NEW, s_max=server.s_max, wall_s=wall,
                decode_tokens_per_s=SERVE_SLOTS * SERVE_NEW / wall,
                launches=launches, peak_mem_bytes=peak,
                tokens_in_range=bool(((tokens >= 0) &
                                      (tokens < cfg.vocab)).all()),
                shape=list(tokens.shape))
    prefill_batch = {"tokens": torch.from_numpy(prompts).to(dev), **vision}
    row[VISION_ARCH] = dict(
        reduced=VISION_REDUCED, init_s=init_s,
        params=sum(p.numel() for p in model.parameters()), long=long,
        wave=wave,
        teacher_forced_prefill=_prefill_vs_forward(
            cfg, model, dev, prefill_batch, server.s_max),
        teacher_forced_decode="not run: a decode step's M-RoPE positions "
                              "jump from the prefill's grid-based ones to "
                              "the absolute position, so decode parts from "
                              "the no-cache forward by design (a reference "
                              "quirk the port keeps)",
        tolerance=dict(atol=FAMILY_TOL["dense"], rtol=FAMILY_TOL["dense"]))
    del model, server, long_batch, prefill_batch
    free_model()
    row["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="llm-encdec-vision", **row))

    w, q = row[ENCDEC_ARCH], row[VISION_ARCH]
    for label, r in (("forward", w["forward"]), ("wave", w["wave"]),
                     ("wave", q["wave"])):
        check(all(c == 0 for c in r["launches"].values()),
              f"{label} launched {r['launches']}; it takes sdpa only")
    check(w["forward"]["finite"] and w["forward"]["logits_shape"] == [
        WHISPER_SLOTS, WHISPER_TEXT, get_config(ENCDEC_ARCH).vocab],
          f"whisper's forward: {w['forward']['logits_shape']}, finite "
          f"{w['forward']['finite']}")
    check(w["forward"]["fp32_vs_cpu"]["tol_ratio"] <= 1.0,
          f"whisper on the card differs from the CPU by "
          f"{w['forward']['fp32_vs_cpu']['max_abs_err']}")
    for r, want in ((w["wave"], [WHISPER_SLOTS, SERVE_NEW]),
                    (q["wave"], [SERVE_SLOTS, SERVE_NEW])):
        check(r["tokens_in_range"] and r["shape"] == want,
              f"a wave's tokens: {r['shape']}, in range "
              f"{r['tokens_in_range']}")
    n = VISION_REDUCED["n_layers"]
    for name in ("flash_attention", "flash_attention_bf16"):
        check(q["long"]["launches"][name] == n,
              f"qwen2-vl's long forward: {name} launched "
              f"{q['long']['launches'][name]} times, expected {n}")
    check(q["long"]["flash_calls"] == n and q["long"]["flash_shapes"] == dict(
        q=[1, LONG_SEQ, 64, 128], k=[1, LONG_SEQ, 8, 128], window=None,
        q_offset=0), f"qwen2-vl's flash calls: {q['long']['flash_calls']} "
                     f"at {q['long']['flash_shapes']}")
    check(q["long"]["finite"] and q["long"]["logits_shape"] == [
        1, LONG_SEQ, cfg.vocab], f"qwen2-vl's long forward: "
                                 f"{q['long']['logits_shape']}")
    tf = q["teacher_forced_prefill"]
    for name in ("bf16", "fp32"):
        check(tf[name]["tol_ratio"] <= 1.0,
              f"qwen2-vl's {name} prefill differs from the no-cache "
              f"forward by {tf[name]['max_abs_err']}")
        check(all(c == 0 for c in tf[name]["launches"].values()),
              f"qwen2-vl's {name} prefill check launched "
              f"{tf[name]['launches']}")
    return row, {"flash_long": cap}


def _route(name: str, before: dict) -> str:
    """The kernel a call of `name`'s wrapper took, "bf16" or "fp32", by
    which route's launch count moved; exactly one must have, by one."""
    from repro_torch.kernels import LAUNCHES
    moved = {r: LAUNCHES[f"{name}_{r}"] - before[f"{name}_{r}"]
             for r in ROUTES}
    total = LAUNCHES[name] - before[name]
    check(total == 1 and sorted(moved.values()) == [0, 1],
          f"{name} launched {total} times, by route {moved}")
    return next(r for r, c in moved.items() if c == 1)


def _flash_err(q, k, v, q_offset, window) -> tuple[float, str]:
    """(max |d out|, route) of the kernel against the plain version."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    before = dict(LAUNCHES)
    got = flash_attention(q, k, v, q_offset=q_offset, window=window)
    torch.cuda.synchronize()
    route = _route("flash_attention", before)
    want = flash_attention_ref(q, k, v, q_offset=q_offset, window=window)
    check(bool(torch.isfinite(got).all()), "flash_attention gave a NaN")
    return float((got.float() - want.float()).abs().max()), route


def _ssd_err(args, chunk: int) -> tuple[float, float, bool, str]:
    """(max |dy|, max |d state|, within tolerance, route) of the kernel
    against the plain version."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked
    before = dict(LAUNCHES)
    y, fin = ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    route = _route("ssd", before)
    wy, wf = ssd_chunked(*args, chunk=chunk)
    dy = (y.float() - wy.float()).abs()
    df = (fin - wf).abs()
    rtol = SSD_RTOL[str(y.dtype).split(".")[1]]
    ok = bool((dy <= SSD_ATOL + rtol * wy.float().abs()).all()) and \
        bool((df <= SSD_ATOL + SSD_RTOL["float32"] * wf.abs()).all())
    return float(dy.max()), float(df.max()), ok, route


def _at_offset(t):
    """A contiguous copy of ``t`` that starts 2 elements into its
    storage, so its address is off 16-byte alignment."""
    import torch
    out = torch.empty(t.numel() + 2, dtype=t.dtype,
                      device=t.device)[2:].view(t.shape)
    out.copy_(t)
    return out


def llm_kernels_vs_plain(dev, captured: dict) -> dict:
    """Both kernels against their plain versions on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    fa_cases, ssd_cases = [], []
    bf16 = torch.bfloat16
    # Every case in fp32 and bf16, then the first in both with its first
    # input (q, x) at an offset of 2 elements.
    dtypes = (torch.float32, bf16)
    runs = [(c, t, False) for c in FA_CASES for t in dtypes]
    for case, dtype, offset in runs + [(FA_CASES[0], t, True)
                                       for t in dtypes]:
        b, sq, sk, hq, hkv, d, window, q_offset = case
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d)))
        if offset:
            q = _at_offset(q)
        name = str(dtype).split(".")[1]
        err, route = _flash_err(q, k, v, q_offset, window)
        fa_cases.append(dict(case=list(case), dtype=name, route=route,
                             first_input_at_offset_2=offset,
                             max_abs_err=err, tolerance=FA_TOL[name]))
        check(route == ROUTE_OF[name],
              f"flash_attention {case} {name} took the {route} route")
        check(err <= FA_TOL[name], f"flash_attention {case} {name} "
                                   f"(offset {offset}): {err} > "
                                   f"{FA_TOL[name]}")
    runs = [(c, t, False) for c in SSD_CASES for t in dtypes]
    for case, dtype, offset in runs + [(SSD_CASES[0], t, True)
                                       for t in dtypes]:
        b, s, h, p, n, chunk = case
        args = [torch.randn((b, s, h, p), generator=gen, device=dev),
                torch.nn.functional.softplus(torch.randn(
                    (b, s, h), generator=gen, device=dev)),
                torch.randn((h,), generator=gen, device=dev) * 0.3,
                torch.randn((b, s, 1, n), generator=gen, device=dev),
                torch.randn((b, s, 1, n), generator=gen, device=dev)]
        args = [a if i == 2 else a.to(dtype) for i, a in enumerate(args)]
        if offset:
            args[0] = _at_offset(args[0])
        dy, df, ok, route = _ssd_err(args, chunk)
        name = str(dtype).split(".")[1]
        ssd_cases.append(dict(case=list(case), dtype=name, route=route,
                              first_input_at_offset_2=offset,
                              max_abs_err_y=dy, max_abs_err_state=df))
        check(ok, f"ssd {case} {name} (offset {offset}): |dy| {dy}, "
                  f"|dstate| {df}")
        check(route == ROUTE_OF[name],
              f"ssd {case} {name} took the {route} route")
    path = {}
    for label, kind, args, kwargs in path_inputs(captured):
        if kind == "flash":
            q, k, v = args
            err, route = _flash_err(q, k, v, kwargs.get("q_offset", 0),
                                    kwargs.get("window"))
            path[label] = dict(shape=list(q.shape), kv_heads=k.shape[2],
                               window=kwargs.get("window"),
                               dtype=str(q.dtype), route=route,
                               max_abs_err=err)
            check(err <= FA_TOL["bfloat16"],
                  f"flash_attention at the path's inputs ({label}) exceeds "
                  f"{FA_TOL['bfloat16']}: {err}")
            check(route == "bf16",
                  f"the path's flash input ({label}) took the fp32 route")
            continue
        dy, df, ok, route = _ssd_err(args, kwargs["chunk"])
        path[label] = dict(shape=list(args[0].shape), n=args[3].shape[-1],
                           chunk=kwargs["chunk"], route=route,
                           max_abs_err_y=dy, max_abs_err_state=df)
        check(ok, f"ssd at the path's inputs ({label}): |dy| {dy}, "
                  f"|dstate| {df}")
        check(route == "bf16",
              f"the path's ssd input ({label}) took the fp32 route")
    return dict(flash_attention=fa_cases, ssd=ssd_cases, path=path)


def path_inputs(captured: dict) -> list:
    """(label, "flash" or "ssd", args, kwargs) of every kernel input the
    LLM paths gave: zamba2's under their earlier labels ("flash_attention",
    "ssd_long", "ssd_serve"), the other archs' as "<arch> <label>", flash
    inputs once for each window they took."""
    out = []
    for arch, caps in captured.items():
        for label, cap in caps.items():
            kind = "flash" if label.startswith("flash") else "ssd"
            for key, (args, kwargs) in cap.calls.items():
                name = label
                if kind == "flash" and arch == LLM_ARCH:
                    name = "flash_attention"
                elif kind == "flash" and len(cap.calls) > 1:
                    name = f"{label} window={key}"
                out.append((name if arch == LLM_ARCH else f"{arch} {name}",
                            kind, args, kwargs))
    return out


def counts_bound(k: int, n_pad: int, w: int, ms: float,
                 b1_rate: float) -> dict:
    """The least time of `selection_counts` at (K, n_pad, W): the bytes
    (both word matrices read once, the int32 counts written once) and
    the 2 K n_pad 32 W operations of the 0/1 product at the int8
    tensor-core rate; where the kernel (``ms``) beats that bound, the
    operations count at the measured .b1 wgmma rate instead.  The
    CUDA-core POPC floor (one POPC per trajectory, vertex and word) is
    returned beside it."""
    ops = 2 * k * n_pad * 32 * w
    nbytes = 4 * (n_pad * w + k * w + k * n_pad)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops, basis = ops / PEAK_INT8_S, "int8 tensor-core rate (data sheet)"
    if ms < 1e3 * max(t_ops, t_bytes):
        t_ops, basis = ops / b1_rate, "measured .b1 wgmma rate"
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_ops_rate=basis,
                int8_bound_ms=1e3 * max(ops / PEAK_INT8_S, t_bytes),
                popc_floor_ms=1e3 * k * n_pad * w / POPC_S,
                earlier_ms=EARLIER_SELECTION_COUNTS_MS
                if (k, n_pad, w) == (1024, 8448, 264) else None,
                ops=ops, bytes=nbytes)


def visible_pairs(sq: int, sk: int, q_offset: int = 0,
                  window: int | None = None) -> int:
    """The (query, key) pairs the kernel's mask lets through: query i at
    position q_offset + i sees key j < sk with 0 <= q_offset + i - j,
    and q_offset + i - j < window where window > 0 (`causal_window_mask`;
    None or 0 is plain causal)."""
    pairs = 0
    for i in range(sq):
        qp = q_offset + i
        hi = min(qp, sk - 1)
        lo = max(0, qp - window + 1) if window and window > 0 else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def flash_bound(b, sq, sk, hq, d, nbytes, fp32=False, q_offset=0,
                window=None) -> dict:
    """The least time of causal attention: 4 d FLOP for each visible
    (query, key) pair (`visible_pairs`: a window cuts them).  On bf16
    inputs at the bf16 tensor-core rate: Q K^T takes bf16 operands whose
    products are exact in fp32; P V may take P rounded to bf16, since the
    library call that does so meets the kernel's own bf16 tolerance in
    this run (`llm_times` checks).  On fp32 inputs (``fp32``) at the TF32
    tensor-core rate, each product `FA_PASSES_FP32` times (the fewest
    split-TF32 passes that meet the fp32 tolerance); the CUDA cores' fp32
    rate gives `fp32_rate_bound_ms` beside it.  The larger of that time
    and the bytes' binds."""
    pairs = visible_pairs(sq, sk, q_offset, window)
    flop = 4 * d * pairs * hq * b
    t_bytes = nbytes / PEAK_BYTES_S
    extra = {}
    if fp32:
        t_ops = FA_PASSES_FP32 * flop / PEAK_TF32_S
        extra = dict(flop_tf32_passes=FA_PASSES_FP32 * flop,
                     fp32_rate_bound_ms=1e3 * max(flop / PEAK_OPS_S,
                                                  t_bytes))
    else:
        t_ops = flop / PEAK_BF16_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                pairs=pairs, flop=flop, **extra, bytes=nbytes)


def ssd_bound(b, s, h, p, n, chunk, nbytes, fp32=False) -> dict:
    """The least time of the scan.  Per chunk of l real steps: the
    scores C B^T shared by the heads of the one group (l (l + 1) N), and
    per head the causal half of the gate product with x (l (l + 1) P),
    the inter-chunk term and the chunk state (2 l P N each).  Each product
    runs on the tensor cores as many times as the fewest split passes of
    its operands that meet the tolerances, shown by the CPU tests: on
    bf16 inputs at the bf16 rate (`SSD_PASSES`), on fp32 inputs
    (``fp32``) at the TF32 rate (`SSD_PASSES_FP32`), with the CUDA
    cores' rate, every product once, as `fp32_rate_bound_ms` beside it.
    The larger of that time and the bytes' binds."""
    flop = {name: 0 for name in SSD_PASSES}
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        flop["scores"] += b * ln * (ln + 1) * n
        flop["gate"] += b * h * ln * (ln + 1) * p
        flop["state"] += b * h * 2 * ln * p * n
        flop["inter"] += b * h * 2 * ln * p * n
    t_bytes = nbytes / PEAK_BYTES_S
    if fp32:
        passes = sum(SSD_PASSES_FP32[k] * f for k, f in flop.items())
        t_ops = passes / PEAK_TF32_S
        extra = dict(flop_tf32_passes=passes, fp32_rate_bound_ms=1e3 * max(
            sum(flop.values()) / PEAK_OPS_S, t_bytes))
    else:
        passes = sum(SSD_PASSES[k] * f for k, f in flop.items())
        t_ops = passes / PEAK_BF16_S
        extra = dict(flop_bf16_passes=passes)
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flop=sum(flop.values()), **extra, bytes=nbytes)


def time_specs(captured: dict) -> tuple[list, list]:
    """The path shapes `llm_times` times: (arch, label, args, kwargs) of
    flash (one row for each window an arch's long forward took: gemma3's
    local and global layers; then mixtral's and qwen2-vl's) and of SSD
    (the long forward's and the serving prefill's), zamba2's first,
    under their earlier labels."""
    flash, ssd_rows = [], []
    for arch in (LLM_ARCH,) + FAMILY_ARCHS + MOE_LONG + (VISION_ARCH,):
        caps = captured[arch]
        calls = caps["flash_long"].calls
        for key, (args, kwargs) in calls.items():
            label = "flash_long" if len(calls) == 1 else \
                ("flash_local" if key else "flash_global")
            flash.append((arch, label, args, kwargs))
        for label in ("ssd_long", "ssd_serve"):
            if label in caps and caps[label].calls:
                ssd_rows.append((arch, label, caps[label].args,
                                 caps[label].kwargs))
    return flash, ssd_rows


def window_mask(sq: int, sk: int, window, dev):
    """`causal_window_mask` at q_offset 0 as a (Sq, Sk) bool tensor (True
    where a key is seen), for the library call's ``attn_mask``."""
    import torch
    m = torch.ones((sq, sk), dtype=torch.bool, device=dev).tril()
    return m.triu(-(window - 1)) if window and window > 0 else m


def llm_times(captured: dict) -> list:
    """Both kernels at their path shapes (`time_specs`), on the captured
    inputs as they are (bf16) and cast to fp32, each dtype on its own
    tensor-core kernels.  Each row: ms (CUDA events, after warm-up), the
    route taken and the error against the plain version, both checked,
    the plain version's ms, the bound at the dtype's rate (and on fp32
    the CUDA cores' fp32 rate beside it), zamba2's routes' times before
    their redesigns as quoted `earlier_ms`, and the route's launches in
    the dtype's run of this phase (the counts reset just before it),
    checked to equal the kernel calls the phase makes; for flash also
    `F.scaled_dot_product_attention` on the same tensors as the library
    yardstick (causal, or with the window as an explicit mask), with its
    error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked
    flash_specs, ssd_specs = time_specs(captured)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        route_want = ROUTE_OF[name]
        reps = dict(kernel=10 if bf16 else 5, library=20 if bf16 else 10)
        first = len(rows)
        reset_launches()
        for arch, label, args, kwargs in flash_specs:
            q, k, v = (t.to(dtype) for t in args)
            window, q_offset = kwargs.get("window"), kwargs.get("q_offset", 0)
            b, sq, hq, d = q.shape
            sk, hkv = k.shape[1], k.shape[2]
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
            mask = window_mask(sq, sk, window, q.device) \
                if window else None

            def library():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, is_causal=mask is None,
                    enable_gqa=hq != hkv).transpose(1, 2)

            def kernel():
                return flash_attention(q, k, v, q_offset=q_offset,
                                       window=window)

            def plain():
                return flash_attention_ref(q, k, v, q_offset=q_offset,
                                           window=window)

            err, route = _flash_err(q, k, v, q_offset, window)
            check(route == route_want,
                  f"{name} flash_attention ({arch} {label}) took the "
                  f"{route} route")
            check(err <= FA_TOL[name], f"{name} flash_attention at "
                                       f"{tuple(q.shape)} ({arch} {label}):"
                                       f" {err} > {FA_TOL[name]}")
            lib_err = float((library().float() -
                             plain().float()).abs().max())
            if bf16:
                check(lib_err <= FA_TOL["bfloat16"],
                      f"scaled_dot_product_attention differs from the plain"
                      f" version by {lib_err} > {FA_TOL['bfloat16']} ({arch}"
                      f" {label}): the flash bound's bf16 rate for P V does "
                      f"not hold")
            earlier = EARLIER_MS[name]["flash_attention"] \
                if arch == LLM_ARCH else None
            rows.append(dict(
                kernel="flash_attention", arch=arch, label=label,
                shape=list(q.shape), kv_heads=hkv, window=window,
                dtype=name, route=route, calls=2 + reps["kernel"],
                ms=cuda_ms(kernel, reps["kernel"]),
                **(dict(earlier_ms=earlier, earlier_ms_from=EARLIER_FROM)
                   if earlier else {}),
                max_abs_err=err, tolerance=FA_TOL[name],
                plain_ms=cuda_ms(plain, 2),
                library_ms=cuda_ms(library, reps["library"]),
                library="torch.nn.functional.scaled_dot_product_attention"
                        + (" (window as attn_mask)" if mask is not None
                           else " (is_causal)"),
                library_max_abs_err=lib_err,
                **flash_bound(b, sq, sk, hq, d, nbytes, fp32=not bf16,
                              q_offset=q_offset, window=window)))
            del q, k, v, mask
        for arch, label, cap_args, kwargs in ssd_specs:
            args = list(cap_args) if bf16 else [t.float() for t in cap_args]
            chunk = kwargs["chunk"]
            bsz, s, h, p = args[0].shape
            n = args[3].shape[-1]
            nbytes = sum(t.numel() * t.element_size() for t in args) + \
                args[0].numel() * args[0].element_size() + \
                4 * bsz * h * p * n
            dy, df, ok, route = _ssd_err(args, chunk)
            check(route == route_want,
                  f"{name} ssd ({arch} {label}) took the {route} route")
            check(ok, f"{name} ssd at {tuple(args[0].shape)} ({arch} "
                      f"{label}): |dy| {dy}, |dstate| {df}")
            earlier = EARLIER_MS[name][label] if arch == LLM_ARCH else None
            rows.append(dict(
                kernel="ssd", arch=arch, label=label,
                shape=list(args[0].shape), chunk=chunk, n=n, dtype=name,
                route=route, calls=2 + 10,
                ms=cuda_ms(lambda: ssd(*args, chunk=chunk), 10),
                **(dict(earlier_ms=earlier, earlier_ms_from=EARLIER_FROM)
                   if earlier else {}),
                max_abs_err_y=dy, max_abs_err_state=df,
                plain_ms=cuda_ms(lambda: ssd_chunked(*args, chunk=chunk), 3),
                library_ms=None, library="none: no single PyTorch call",
                **ssd_bound(bsz, s, h, p, n, chunk, nbytes, fp32=not bf16)))
        # Each row's kernel calls: the error check, cuda_ms's warm-up and
        # its reps.  The route's count must be exactly their sum.
        for kernel in ("flash_attention", "ssd"):
            mine = [r for r in rows[first:] if r["kernel"] == kernel]
            want = sum(r.pop("calls") for r in mine)
            got = LAUNCHES[f"{kernel}_{route_want}"]
            check(got == want == LAUNCHES[kernel],
                  f"{name} {kernel}: {got} launches on the {route_want} "
                  f"route, {LAUNCHES[kernel]} in all, in {want} calls")
            for r in mine:
                r["route_launches_in_phase"] = got
    return rows


def time_row(rows: list, arch: str, label: str, dtype: str) -> dict:
    """The llm-times row of ``arch``'s ``label`` shape in ``dtype``."""
    return next(r for r in rows if (r["arch"], r["label"], r["dtype"]) ==
                (arch, label, dtype))


def path_shapes(rows: list, kernel: str) -> list:
    """The kernels line's entries for ``kernel``'s rows of the paths
    beyond zamba2's: each shape with both routes' numbers."""
    keys = ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "max_abs_err" if kernel == "flash_attention" else
            "max_abs_err_y", "route_launches_in_phase")
    out = []
    for r in rows:
        if r["kernel"] != kernel or r["arch"] == LLM_ARCH or \
                r["dtype"] != "bfloat16":
            continue
        r32 = time_row(rows, r["arch"], r["label"], "float32")
        out.append(dict(
            arch=r["arch"], label=r["label"], shape=r["shape"],
            **({"kv_heads": r["kv_heads"], "window": r["window"]}
               if kernel == "flash_attention" else
               {"n": r["n"], "chunk": r["chunk"]}),
            bf16={k: r[k] for k in keys},
            fp32={k: r32[k] for k in keys + ("fp32_rate_bound_ms",)}))
    return out


# ------------------------------------------------ the service tier
def llm_train(dev, card: str) -> tuple[dict, object, dict]:
    """`launch.train.main` on each of `TRAIN_RUNS` (its printed lines
    kept), with the launch counts of every kernel and the calls of the
    plain versions that reached a CUDA tensor (which must be none).
    Returns (the phase's row, the zamba2 run's first `ssd_bwd` call, a
    `Capture`, and the MoE runs' `ragged_dot_bwd` calls by arch, each a
    `Capture` kept on the host)."""
    import contextlib
    import io
    import re
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ragged_dot import ops as rd_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import train
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    runs = {}
    capture, moe_caps = None, {}
    make_step = M.make_train_step
    step_s: list[float] = []
    profile_at: list = [None]   # the step to profile (not timed), or None
    profiles: list = []

    def timed_make_step(cfg, optimizer):
        """`make_train_step`'s step, with the device-synced wall of each
        call kept in ``step_s``; the step at ``profile_at`` runs once
        under `device_profile` instead, untimed."""
        step = make_step(cfg, optimizer)

        def run(state, batch):
            if len(step_s) == profile_at[0] and not profiles:
                box = {}
                profiles.append(device_profile(
                    lambda: box.update(out=step(state, batch)), top=10,
                    shares=TRAIN_PROFILE_SHARES))
                return box["out"]
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        return run

    # The plain versions the wrappers take on the CPU: a call on a CUDA
    # tensor here would be a plain product on the path.
    plain_on_card: dict = {}

    @contextlib.contextmanager
    def watch_plain():
        saved = []
        for mod, name in ((rd_ops, "ragged_dot_ref"),
                          (rd_ops, "ragged_dot_bwd_ref"),
                          (fa_ops, "flash_attention_ref"),
                          (fa_ops, "flash_attention_bwd_ref"),
                          (ssd_ops, "ssd_chunked"),
                          (ssd_ops, "ssd_chunked_bwd")):
            orig = getattr(mod, name)
            saved.append((mod, name, orig))

            def watched(*args, _orig=orig, _name=name, **kwargs):
                if args[0].is_cuda:
                    plain_on_card[_name] = plain_on_card.get(_name, 0) + 1
                return _orig(*args, **kwargs)
            setattr(mod, name, watched)
        try:
            yield
        finally:
            for mod, name, orig in saved:
                setattr(mod, name, orig)

    for arch, argv in TRAIN_RUNS.items():
        t_run = time.perf_counter()
        ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt", arch)
        shutil.rmtree(ckpt, ignore_errors=True)
        out = io.StringIO()
        free_model()
        torch.cuda.reset_peak_memory_stats()
        cap = Capture(ssd_ops, "ssd_bwd")
        moe_cap = Capture(rd_ops, "ragged_dot_bwd", key=by_projection,
                          clone="host")
        step_s.clear()
        profiles.clear()
        # The last step is profiled: no timed step follows it.
        profile_at[0] = int(argv[argv.index("--steps") + 1]) - 1 \
            if arch in TRAIN_PROFILED else None
        plain_on_card.clear()
        reset_launches()
        t0 = time.perf_counter()
        M.make_train_step = timed_make_step
        try:
            with cap, moe_cap, watch_plain(), card_to_itself(), \
                    contextlib.redirect_stdout(out):
                history = train.main(argv + ["--ckpt", ckpt])
        finally:
            M.make_train_step = make_step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        lines = out.getvalue().splitlines()
        done = next(ln for ln in lines if ln.startswith("done:"))
        restarts = int(re.search(r"restarts=(\d+)", done).group(1))
        loop_s = float(re.search(r" in ([\d.]+)s", done).group(1))
        kept = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
        shutil.rmtree(ckpt, ignore_errors=True)
        steps = int(argv[argv.index("--steps") + 1])
        batch = int(argv[argv.index("--batch") + 1])
        seq = int(argv[argv.index("--seq") + 1])
        losses = [h["loss"] for h in history]
        # The step's own wall (after the first step, which warms up, and
        # without the profiled one), and the loop's, which adds the data,
        # the host reads of the metrics, the checkpoints and the profile.
        step_wall = float(np.median(step_s[1:] if len(step_s) > 1
                                    else step_s))
        reduced = {"n_layers": int(argv[argv.index("--layers") + 1])} \
            if "--layers" in argv else {}
        prof = profiles[0] if profiles else None
        runs[arch] = dict(
            argv=argv, card=card, reduced=reduced, wall_s=wall,
            loop_s=loop_s, steps_run=len(history), restarts=restarts,
            step_s=list(step_s), step_wall_s=step_wall,
            tokens_per_s=batch * seq / step_wall,
            loop_tokens_per_s=batch * seq * len(history) / loop_s,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            first_loss=losses[0], last_loss=losses[-1],
            losses=losses, checkpoints_kept=kept, launches=launches,
            plain_on_card=dict(plain_on_card),
            profile=prof,
            backward_kernels_share=sum(
                prof["shares"][k] or 0.0 for k in TRAIN_BWD_LABELS)
            if prof and prof["device_ms"] else None,
            lines=[ln for ln in lines if ln.startswith(("training", "step",
                                                        "done"))])
        check(all(map(np.isfinite, losses)), f"{arch}: a loss is not finite")
        check(losses[-1] < losses[0],
              f"{arch}: the last loss {losses[-1]} is not below the first "
              f"{losses[0]}")
        check(not plain_on_card, f"{arch}: plain versions ran on CUDA "
                                 f"tensors: {plain_on_card}")

        def count(name):
            return LAUNCHES.get(name, 0)
        if arch == "lm100m":
            check(restarts == 1, f"lm100m: {restarts} restarts, not 1")
            check(len(history) == steps + 2,
                  f"lm100m: {len(history)} steps run, not {steps} + the 2 "
                  f"replayed from the step-5 checkpoint")
        elif arch == LLM_ARCH:
            capture = cap
            want = 38 * steps
            check(count("ssd_bwd") == want and count("ssd_bwd_bf16") == want,
                  f"zamba2: ssd_bwd launched {count('ssd_bwd')} times "
                  f"({count('ssd_bwd_bf16')} bf16), not {want}")
            check(count("ssd") == 2 * want,
                  f"zamba2: ssd launched {count('ssd')} times, not "
                  f"{2 * want} (a forward and its recomputation a layer)")
            check(count("flash_attention") == 0,
                  "zamba2 at S = 2048 launched flash attention")
        else:
            # A forward and its recomputation under the per-block
            # checkpoint, and one backward, each layer a step.
            cfg = dataclasses.replace(get_config(arch), **reduced)
            rd, fa = ragged_calls(cfg) * steps, attention_calls(cfg) * steps
            if seq * seq <= 4096 * 4096:
                fa = 0   # the plain masked product takes the attention
            for name, want in (("ragged_dot", 2 * rd),
                               ("ragged_dot_wgmma", 2 * rd),
                               ("ragged_dot_bwd", rd),
                               ("ragged_dot_bwd_bf16", rd),
                               ("ragged_dot_bwd_wgmma", rd),
                               ("ragged_dot_bwd_mma", 0),
                               ("flash_attention", 2 * fa),
                               ("flash_attention_bf16", 2 * fa),
                               ("flash_attention_bwd", fa),
                               ("flash_attention_bwd_bf16", fa)):
                check(count(name) == want, f"{arch}: {name} launched "
                                           f"{count(name)} times, not {want}")
            check(rd + fa > 0, f"{arch}: no backward kernel on its path")
            if rd:
                moe_caps[arch] = moe_cap
        runs[arch]["seconds"] = time.perf_counter() - t_run
        free_model()
    return dict(phase="train", runs=runs,
                seconds=time.perf_counter() - t_phase), capture, moe_caps


def train_card_vs_cpu(dev) -> dict:
    """One train step in fp32 compute on the card and on the host from
    the same weights and batch, for each of `TRAIN_CHECKS`: loss, grad
    norm and every updated parameter compared (`TRAIN_TOL`); each
    backward kernel launched once a layer on its fp32 route."""
    t_phase = time.perf_counter()
    runs = {name: _card_vs_cpu(dev, name, *spec)
            for name, spec in TRAIN_CHECKS.items()}
    return dict(phase="train-card-vs-cpu", runs=runs, compute="float32",
                tolerance=TRAIN_TOL, seconds=time.perf_counter() - t_phase)


def _card_vs_cpu(dev, name: str, arch: str, smoke: bool, reduced: dict,
                 shape) -> dict:
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    t_run = time.perf_counter()
    cfg = dataclasses.replace(
        (get_smoke_config if smoke else get_config)(arch), **reduced)
    b, s = shape
    with compute_dtype(torch.float32):
        host, host_step, data, _ = train.build(cfg, batch=b, seq=s, lr=3e-4,
                                               steps=1, device="cpu")
        card, card_step, _, _ = train.build(cfg, batch=b, seq=s, lr=3e-4,
                                            steps=1, device=dev)
        with torch.no_grad():
            for p_card, p_host in zip(card[0].parameters(),
                                      host[0].parameters()):
                p_card.copy_(p_host)
        batch = data.batch(0)
        reset_launches()
        t0 = time.perf_counter()
        (card_model, card_opt, _), card_m = card_step(card, batch)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        t0 = time.perf_counter()
        (host_model, host_opt, _), host_m = host_step(host, batch)
        host_s = time.perf_counter() - t0
    opt = AdamW()
    lr = 3e-4
    metrics = {}
    for key in ("loss", "ce", "zloss", "grad_norm"):
        got, want = float(card_m[key]), float(host_m[key])
        metrics[key] = dict(card=got, host=want)
        check(abs(got - want) <= TRAIN_TOL * abs(want) + 1e-6,
              f"train-card-vs-cpu {name}: {key} {got} on the card, {want} "
              f"on the host")
    worst, ill, worst_ill = 0.0, 0, 0.0
    host_params = dict(host_model.named_parameters())
    for pname, p in card_model.named_parameters():
        got, want = p.detach().cpu(), host_params[pname].detach()
        # The clipped gradient: mu after the first step is (1 - b1) g.
        g = host_opt["mu"][pname] / (1 - opt.b1)
        well = g.abs() >= 100 * opt.eps
        ill += int((~well).sum())
        err = (got - want).abs()
        bound = TRAIN_TOL * float(want.abs().max()) + 1e-6
        if well.any():
            ratio = float(err[well].max()) / bound
            worst = max(worst, ratio)
            check(ratio <= 1.0, f"train-card-vs-cpu {name}: {pname} parts "
                                f"by {float(err[well].max())} (bound "
                                f"{bound})")
        if (~well).any():
            move = 2 * lr * (1 + opt.weight_decay * want[~well].abs())
            worst_ill = max(worst_ill, float((err[~well] / move).max()))
            check(bool((err[~well] <= move).all()),
                  f"train-card-vs-cpu {name}: {pname} moved past the first "
                  f"step's reach where its gradient is under 100 eps")
    # Each backward kernel once a layer, on its fp32 route; no flash at
    # these lengths; the grouped products, both ways, on the TF32 tensor
    # cores.
    for kernel, want in (("ssd_bwd", ssd_calls(cfg)),
                         ("ragged_dot_bwd", ragged_calls(cfg))):
        got = (launches.get(kernel, 0), launches.get(f"{kernel}_fp32", 0))
        check(got == (want, want), f"train-card-vs-cpu {name}: {kernel} "
                                   f"launched {got} (all, fp32), not {want}")
    for kernel in ("ragged_dot", "ragged_dot_bwd"):
        got = (launches.get(kernel, 0), launches.get(f"{kernel}_fp32_tc", 0))
        check(got[0] == got[1], f"train-card-vs-cpu {name}: {kernel} "
                                f"launched {got} (all, on the tensor cores)")
    check(not launches.get("flash_attention", 0),
          f"train-card-vs-cpu {name}: flash launched at S = {s}")
    del card, host, card_model, host_model, card_opt, host_opt
    free_model()
    return dict(arch=arch, smoke=smoke, reduced=reduced, shape=list(shape),
                metrics=metrics, worst_param_ratio=worst,
                entries_under_100_eps=ill,
                worst_under_100_eps_ratio=worst_ill, launches=launches,
                card_step_s=card_s, host_step_s=host_s,
                seconds=time.perf_counter() - t_run)


def ragged_bwd_bound(part: str, m, k, n, groups_used, groups,
                     x_bytes=2, w_bytes=4) -> dict:
    """The least time of one half of the grouped product's backward: 2 m
    k n FLOP at the bf16 tensor-core rate (3 TF32 passes at its rate for
    fp32 x), against its bytes moved once: dx reads dy, the used groups'
    weights and the offsets and writes dx; dw reads x, dy and the
    offsets and writes every group's dw."""
    flop = 2 * m * k * n
    if part == "dx":
        nbytes = x_bytes * (m * n + m * k) + w_bytes * groups_used * k * n
    else:
        nbytes = x_bytes * (m * k + m * n) + w_bytes * groups * k * n
    nbytes += 4 * (groups + 1)
    fp32 = x_bytes == 4
    t_ops = (3 * flop / PEAK_TF32_S) if fp32 else flop / PEAK_BF16_S
    t_bytes = nbytes / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flop=flop, bytes=nbytes)


def _grouped_mm_bwd(x, w, offs, dy) -> dict:
    """`torch._grouped_mm` for dx and for dw on the weights cast to bf16
    first (a yardstick off the path, never used by the port): (dx, dw)
    callables, or the error each raised."""
    import torch
    wb = w.to(torch.bfloat16)
    ends = offs[1:]
    # Each half as its operands lie, then on copies laid out as the
    # call may require (made outside the timed call).
    wt, xt = wb.transpose(-2, -1), x.t()
    wtc, xtc = wt.contiguous(), xt.contiguous()
    calls = dict(
        dx=(lambda: torch._grouped_mm(dy, wt, offs=ends),
            lambda: torch._grouped_mm(dy, wtc, offs=ends)),
        dw=(lambda: torch._grouped_mm(xt, dy, offs=ends),
            lambda: torch._grouped_mm(xtc, dy, offs=ends)))
    out = {}
    for part, fns in calls.items():
        out[part] = None
        for fn in fns:
            try:
                fn()
            except (RuntimeError, TypeError, ValueError) as e:
                out[part] = str(e)[:200]
                continue
            out[part] = fn
            break
    return out


def ragged_bwd_vs_plain(dev, moe_caps: dict) -> dict:
    """The grouped product's backward (`ragged_dot_bwd`: the dx and dw
    kernels) against its plain version on the card, at the shapes the
    MoE training runs gave it (captured, on the host, then back on the
    card) and at `RAGGED_BWD_EDGES`; two calls give the same bits.  At
    the captured shapes each kernel's ms (both halves, each alone), its
    plain half's ms, its bound (`ragged_bwd_bound`) and
    `torch._grouped_mm`'s ms on pre-cast weights (a yardstick off the
    path).  fp32 results are held to the plain version's float64 sums
    (`plain_acc`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ragged_dot import ops as rd_ops
    from repro_torch.kernels.ragged_dot.ref import (ragged_dot_bwd_ref,
                                                    ragged_dot_dw_ref,
                                                    ragged_dot_dx_ref)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    specs = []
    for arch, cap in moe_caps.items():
        for (m, k, n), (args, _) in cap.calls.items():
            label = "gate/up" if k == get_config(arch).d_model else "down"
            specs.append((f"{arch} {label}", [a.to(dev) for a in args]))
    for m, k, n, sizes, xt, wt, before in RAGGED_BWD_EDGES:
        x_type = torch.float32 if xt == "fp32" else torch.bfloat16
        w_type = torch.float32 if wt == "fp32" else torch.bfloat16
        offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]) + before,
                            dtype=torch.int32, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(x_type)
        w = (torch.randn((len(sizes), k, n), generator=gen, device=dev) *
             k ** -0.5).to(w_type)
        dy = torch.randn((m, n), generator=gen, device=dev).to(x_type)
        specs.append((f"edge ({m}, {k}, {n}) {xt} x {wt} w, "
                      f"{len(sizes)} groups, {before} rows before",
                      [x, w, offs, dy]))
    rows = []
    for label, (x, w, offs, dy) in specs:
        m, k = x.shape
        groups, _, n = w.shape
        before = {r: LAUNCHES[f"ragged_dot_bwd_{r}"]
                  for r in ("wgmma", "mma", "fp32", "fp32_tc", "fp32_cores")}
        got = rd_ops.ragged_dot_bwd(x, w, offs, dy)
        route = [r for r in before
                 if LAUNCHES[f"ragged_dot_bwd_{r}"] > before[r]]
        again = rd_ops.ragged_dot_bwd(x, w, offs, dy)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = ragged_dot_bwd_ref(x, w, offs, dy, acc=plain_acc(x))
        name = str(x.dtype).split(".")[1]
        rtol = RAGGED_RTOL[name]
        errs, ok = {}, same
        for part, g_, w_ in zip(("dx", "dw"), got, want):
            d = (g_.float() - w_.float()).abs()
            errs[part] = float(d.max()) if d.numel() else 0.0
            ok &= bool((d <= RAGGED_ATOL + rtol * w_.float().abs()).all())
        row = dict(case=label, m=m, k=k, n=n, groups=groups,
                   x=name, w=str(w.dtype).split(".")[1], route=route,
                   max_abs_err=errs, bit_identical=same, within=ok)
        if name == "float32":
            # Each gradient and the plain version's own fp32 sums, as
            # shares of the tolerance from its float64 sums.
            row["tol_ratio"] = {p_: tol_ratio(g_, w_, rtol) for p_, g_, w_
                                in zip(("dx", "dw"), got, want)}
            row["plain_fp32_tol_ratio"] = {
                p_: tol_ratio(g_, w_, rtol) for p_, g_, w_ in zip(
                    ("dx", "dw"), ragged_dot_bwd_ref(x, w, offs, dy), want)}
        del got, again, want
        if not label.startswith("edge"):
            used = int((offs.diff() > 0).sum())
            lib = _grouped_mm_bwd(x, w, offs, dy)
            reps = 10
            row["ms"] = cuda_ms(lambda: rd_ops.ragged_dot_bwd(x, w, offs,
                                                              dy), reps)
            earlier = RAGGED_BWD_EARLIER_MS.get(label)
            if earlier:
                row.update(earlier_ms=earlier[0],
                           earlier_ms_from=EARLIER_FROM)
            for bit, part, plain in ((1, "dx", ragged_dot_dx_ref),
                                     (2, "dw", ragged_dot_dw_ref)):
                fn = lib[part]
                row[part] = dict(
                    earlier_ms=earlier[bit] if earlier else None,
                    ms=cuda_ms(lambda: rd_ops._launch_bwd(x, w, offs, dy,
                                                          parts=bit), reps),
                    plain_ms=cuda_ms(lambda: plain(x, w, offs, dy), 2),
                    library_ms=cuda_ms(fn, reps) if callable(fn) else None,
                    library="torch._grouped_mm on the weights cast to bf16"
                            + ("" if callable(fn) else f" (raised: {fn})"),
                    **ragged_bwd_bound(part, m, k, n, used, groups,
                                       x_bytes=x.element_size(),
                                       w_bytes=w.element_size()))
            row["groups_used"] = used
            del lib
        rows.append(row)
        # bf16 takes the TMA + wgmma kernels wherever K and N are
        # multiples of 8 (every captured shape), mma.sync elsewhere; fp32
        # the TF32 tensor cores where they are multiples of 4.
        if name == "float32":
            want_route = ["fp32", "fp32_tc" if k % 4 == 0 and n % 4 == 0
                          else "fp32_cores"]
        else:
            want_route = ["wgmma" if k % 8 == 0 and n % 8 == 0 else "mma"]
        check(route == want_route, f"ragged_dot_bwd {label}: took "
                                   f"{route}, not {want_route}")
        check(same, f"ragged_dot_bwd {label}: two calls differ")
        check(ok, f"ragged_dot_bwd {label}: outside the tolerance ({errs})")
        del x, w, offs, dy
    # The fp32 route at the first projection's captured shape (mixtral's
    # gate/up), x and dy cast to fp32, and at the fp32 step's smoke shapes.
    fp32_rows = []
    label, (x, w, offs, dy) = next(
        (lb, a) for lb, a in specs if lb == f"{FP32_RAGGED_ARCH} gate/up")
    for label, *args in [(label, x.float(), w, offs, dy.float())] + \
            ragged_fp32_smoke(x.device, gen):
        for part in ("dx", "dw"):
            fp32_rows.append(ragged_fp32_row(label, part, *args)[0])
    return dict(phase="ragged-dot-bwd-vs-plain", cases=rows,
                fp32_x=fp32_rows,
                tolerance=dict(atol=RAGGED_ATOL, rtol=RAGGED_RTOL),
                seconds=time.perf_counter() - t_phase)


def flash_bwd_bound(part: str, b, sq, sk, hq, hkv, d, nbytes, fp32=False,
                    q_offset=0, window=None) -> dict:
    """The least time of the flash backward or one of its kernels: per
    visible (query, key) pair (`visible_pairs`) 2 d FLOP a product, five
    products for the whole backward (S, dP, dV, dK, dQ: 10 d), three for
    the dq kernel's own work (S, dP, dQ) and four for the dk/dv kernel's
    (S, dP, dV, dK), at the bf16 tensor-core rate, or 3 TF32 passes at
    its rate for fp32; against ``nbytes`` (each input read once, each
    output written once)."""
    products = {"bwd": 5, "dq": 3, "dkdv": 4}[part]
    pairs = visible_pairs(sq, sk, q_offset, window)
    flop = 2 * d * products * pairs * hq * b
    t_ops = (3 * flop / PEAK_TF32_S) if fp32 else flop / PEAK_BF16_S
    t_bytes = nbytes / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                pairs=pairs, flop=flop, bytes=nbytes)


def flash_bwd_vs_plain(dev, captured: dict) -> dict:
    """Flash attention's backward (`flash_attention_bwd`: the dq and dk/dv
    kernels) at every flash path shape (`time_specs`), in bf16 and fp32,
    on the card's own forward output and LSE and a seeded dO: each
    gradient against the plain backward on fp32 copies, one KV-head
    group at a time, within `FA_BWD_TOL` of its max |ref|; two calls give
    the same bits; the forward's output the same bits with and without
    the LSE.  Each row: ms (both kernels, and each alone), the plain
    halves' ms, the bounds (`flash_bwd_bound`), and SDPA's backward under
    autograd on the same tensors (windows as a boolean mask) as the
    library yardstick, off the path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_bwd_dkdv_ref, flash_bwd_dq_ref)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    rows = []
    for arch, label, args, kwargs in time_specs(captured)[0]:
        window, q_offset = kwargs.get("window"), kwargs.get("q_offset", 0)
        kw = dict(q_offset=q_offset, window=window)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            fp32 = dtype == torch.float32
            q, k, v = (t.to(dtype) for t in args)
            b, sq, hq, d = q.shape
            sk, hkv = k.shape[1], k.shape[2]
            g = hq // hkv
            out, lse = fa_ops._forward(q, k, v, q_offset, window, 512, True)
            plain_out, _ = fa_ops._forward(q, k, v, q_offset, window, 512,
                                           False)
            fwd_same = bool(torch.equal(out, plain_out))
            del plain_out
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            route = "fp32" if fp32 else "bf16"
            before = LAUNCHES[f"flash_attention_bwd_{route}"]
            got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            routed = LAUNCHES[f"flash_attention_bwd_{route}"] == before + 1
            again = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            err = {p: 0.0 for p in ("dq", "dk", "dv")}
            ref_max = dict(err)
            for h in range(hkv):
                qs = slice(h * g, (h + 1) * g)
                ks = slice(h, h + 1)
                want = flash_attention_bwd_ref(
                    q[:, :, qs].float(), k[:, :, ks].float(),
                    v[:, :, ks].float(), out[:, :, qs].float(), lse[:, qs],
                    do[:, :, qs].float(), **kw)
                for p, g_, w_ in zip(("dq", "dk", "dv"),
                                     (got[0][:, :, qs], got[1][:, :, ks],
                                      got[2][:, :, ks]), want):
                    err[p] = max(err[p], float((g_.float() - w_).abs().max()))
                    ref_max[p] = max(ref_max[p], float(w_.abs().max()))
                del want
            ok = same and fwd_same and routed and all(
                err[p] <= FA_BWD_TOL[name] * ref_max[p] for p in err)
            earlier = FA_BWD_EARLIER_MS[name].get((arch, label))
            nbytes = {
                "bwd": 5 * q.numel() * q.element_size() + 4 * k.numel() *
                k.element_size() + 4 * lse.numel(),
                "dq": 4 * q.numel() * q.element_size() + 2 * k.numel() *
                k.element_size() + 4 * lse.numel(),
                "dkdv": 3 * q.numel() * q.element_size() + 4 * k.numel() *
                k.element_size() + 4 * lse.numel()}
            reps = 3 if fp32 else 10
            _, _, _, delta = fa_ops._launch_bwd(q, k, v, out, lse, do,
                                                q_offset, window)

            def sdpa_backward():
                # Clones: the captured inputs are inference tensors, which
                # take no gradient outside inference mode.
                leaves = [t.transpose(1, 2).clone().requires_grad_()
                          for t in (q, k, v)]
                mask = window_mask(sq, sk, window, dev) if window else None
                o = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=hq != hkv)
                grad_out = do.transpose(1, 2)
                return lambda: torch.autograd.grad(o, leaves, grad_out,
                                                   retain_graph=True)
            try:
                lib = sdpa_backward()
                library_ms = cuda_ms(lib, reps)
                del lib
            except (RuntimeError, torch.OutOfMemoryError) as e:
                library_ms = None
                lib_error = str(e)[:200]
            else:
                lib_error = None
            row = dict(
                arch=arch, label=label, shape=[b, sq, hq, d], kv_heads=hkv,
                window=window, dtype=name,
                route="wgmma" if not fp32 else "tf32 mma.sync",
                earlier_ms=earlier[0] if earlier else None,
                earlier_ms_from=EARLIER_FROM + "; " + FA_BWD_EARLIER_FROM[
                    name] if earlier else None,
                forward_bit_equal_with_lse=fwd_same,
                bit_identical=same, max_abs_err=err, max_abs_ref=ref_max,
                within=ok, tolerance=FA_BWD_TOL[name],
                ms=cuda_ms(lambda: fa_ops.flash_attention_bwd(
                    q, k, v, out, lse, do, **kw), reps),
                plain_ms=cuda_ms(lambda: flash_attention_bwd_ref(
                    q, k, v, out, lse, do, **kw), 1),
                library_ms=library_ms,
                library="torch.nn.functional.scaled_dot_product_attention's"
                        " backward under autograd" + (
                            " (window as attn_mask)" if window else
                            " (is_causal)") + (
                            f" (raised: {lib_error})" if lib_error else ""),
                **flash_bwd_bound("bwd", b, sq, sk, hq, hkv, d,
                                  nbytes["bwd"], fp32, q_offset, window))
            for bit, part, plain in ((1, "dq", flash_bwd_dq_ref),
                                     (2, "dkdv", flash_bwd_dkdv_ref)):
                row[part] = dict(
                    earlier_ms=earlier[bit] if earlier else None,
                    ms=cuda_ms(lambda: fa_ops._launch_bwd(
                        q, k, v, out, lse, do, q_offset, window, parts=bit,
                        delta=delta), reps),
                    plain_ms=cuda_ms(lambda: plain(q, k, v, out, lse, do,
                                                   **kw), 1),
                    **flash_bwd_bound(part, b, sq, sk, hq, hkv, d,
                                      nbytes[part], fp32, q_offset, window))
            rows.append(row)
            check(fwd_same, f"flash forward {arch} {label} {name}: the "
                            f"output differs with the LSE written")
            check(routed, f"flash_attention_bwd {arch} {label} {name}: not "
                          f"one launch on its {route} route")
            check(same, f"flash_attention_bwd {arch} {label} {name}: two "
                        f"calls differ")
            check(ok, f"flash_attention_bwd {arch} {label} {name}: "
                      f"{err} against max |ref| {ref_max}")
            del q, k, v, out, lse, do, got, delta
            free_model()
    return dict(phase="flash-bwd-vs-plain", cases=rows,
                tolerance=FA_BWD_TOL, seconds=time.perf_counter() - t_phase)


def ssd_bwd_bound(b, s, h, p, n, chunk, nbytes, fp32=False) -> dict:
    """The least time of the backward.  Per chunk of l real steps: the
    scores C B^T and the products of the heads' summed Q with B and C
    (l (l + 1) N each, once a chunk: one group shares B and C, so dB_j =
    sum_i (sum_h Q^h_ij) C_i and dC_i likewise), and per head dy x^T and
    the gate's product with dy (l (l + 1) P each) and five (P x l)(l x
    N) products (the chunk states S and R, and the state terms of dx, dB
    and dC: 2 l P N each), each once.  ``flop_per_head_bc`` is the count
    before the head fold (Q times B and C per head, PR 25's bound) and
    ``bound_per_head_bc_ms`` its bound.  bf16 inputs at the bf16
    tensor-core rate; fp32 at the TF32 rate three times (the split-TF32
    passes the forward's fp32 tolerances need), with the CUDA cores'
    rate as `fp32_rate_bound_ms` beside it.  The larger of that time and
    the bytes' binds."""
    flop = per_head = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        pairs, states = ln * (ln + 1), 10 * ln * p * n
        flop += b * (3 * pairs * n + h * (2 * pairs * p + states))
        per_head += b * (pairs * n + h * (2 * pairs * (p + n) + states))
    t_bytes = nbytes / PEAK_BYTES_S
    rate, passes = (PEAK_TF32_S, 3) if fp32 else (PEAK_BF16_S, 1)
    t_ops, t_old = (passes * f / rate for f in (flop, per_head))
    extra = {}
    if fp32:
        extra = dict(fp32_rate_bound_ms=1e3 * max(flop / PEAK_OPS_S,
                                                   t_bytes))
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flop=flop, flop_per_head_bc=per_head,
                bound_per_head_bc_ms=1e3 * max(t_old, t_bytes),
                bytes=nbytes, **extra)


def ssd_bwd_vs_plain(dev, capture) -> dict:
    """`ssd_bwd` on the card against the plain version on the card, at
    `SSD_BWD_CASES` in both dtypes; two calls must give the same bits;
    the kernel's ms, the plain version's and the bound at each shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    check(capture is not None and capture.calls,
          "the zamba2 train run gave no ssd_bwd call to capture")
    cap_args, cap_kw = capture.args, capture.kwargs
    rows = []
    for label, spec, with_final in SSD_BWD_CASES:
        if spec == "captured":
            x, dt, a_log, b, c, dy, _ = cap_args
            chunk = cap_kw["chunk"]
        else:
            bsz, s, h, p, n, chunk = spec
            def r(*shape):
                return torch.randn(*shape, device=dev, generator=gen)
            x, dt, a_log = r(bsz, s, h, p), F.softplus(r(bsz, s, h)), \
                r(h) * 0.5
            b, c, dy = r(bsz, s, 1, n), r(bsz, s, 1, n), r(bsz, s, h, p)
        bsz, s, h, p = x.shape
        n = b.shape[3]
        d_final = torch.randn(bsz, h, p, n, device=dev, generator=gen) \
            if with_final else None
        for dtype in (torch.bfloat16, torch.float32):
            args = [t.to(dtype) for t in (x, dt)] + [a_log] + [
                t.to(dtype) for t in (b, c, dy)]
            got = ssd_ops.ssd_bwd(*args, d_final, chunk=chunk)
            again = ssd_ops.ssd_bwd(*args, d_final, chunk=chunk)
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(got, again))
            want = ssd_chunked_bwd(*(t.float() for t in args), d_final,
                                   chunk=chunk)
            name = str(dtype).split(".")[1]
            errs, ok = {}, same
            for key, g, w in zip(("dx", "ddt", "d_a_log", "db", "dc"), got,
                                 want):
                err = (g.float() - w).abs()
                errs[key] = float(err.max())
                if key == "d_a_log":
                    ok &= bool((err <= SSD_BWD_DA_TOL * w.abs().max()).all())
                else:
                    ok &= bool((err <= SSD_BWD_TOL[name] * w.abs() +
                                SSD_BWD_ATOL * w.abs().max()).all())
            row = dict(case=label, dtype=name, shape=[bsz, s, h, p], n=n,
                       chunk=chunk, d_final=with_final, max_abs_err=errs,
                       max_abs_ref={key: float(w.abs().max()) for key, w in
                                    zip(("dx", "ddt", "d_a_log", "db", "dc"),
                                        want)},
                       bit_identical=same, within=ok)
            if spec == "captured" or label.startswith("mamba2"):
                nbytes = sum(t.numel() * t.element_size() for t in args) + \
                    sum(t.numel() * t.element_size() for t in got) + (
                        d_final.numel() * 4 if with_final else 0)
                arch = "mamba2" if label.startswith("mamba2") else "zamba2"
                row.update(
                    ms=cuda_ms(lambda: ssd_ops.ssd_bwd(
                        *args, d_final, chunk=chunk), 10),
                    earlier_ms=SSD_BWD_EARLIER_MS[name][arch],
                    earlier_from="PR 25's ssd_bwd.cu (CUDA cores), quoted "
                                 "from PERF.md section 6, not measured in "
                                 "this run",
                    route="bf16 mma.sync" if dtype == torch.bfloat16 else
                    "tf32 mma.sync",
                    plain_ms=cuda_ms(lambda: ssd_chunked_bwd(
                        *args, d_final, chunk=chunk), 3),
                    library_ms=None,
                    **ssd_bwd_bound(bsz, s, h, p, n, chunk, nbytes,
                                    fp32=dtype == torch.float32))
                row["stages"] = device_profile(   # each stage's, a call
                        lambda: [ssd_ops.ssd_bwd(*args, d_final,
                                                 chunk=chunk)
                                 for _ in range(5)], calls=5, top=8)
            rows.append(row)
            check(same, f"ssd_bwd {label} {name}: two calls differ")
            check(ok, f"ssd_bwd {label} {name}: outside the tolerance "
                      f"({errs})")
            del got, again, want
    return dict(phase="ssd-bwd-vs-plain", cases=rows,
                tolerance=dict(rtol=SSD_BWD_TOL, atol_of_max=SSD_BWD_ATOL,
                               d_a_log_of_max=SSD_BWD_DA_TOL),
                seconds=time.perf_counter() - t_phase)


def dryrun_phase(dev, card: str, zamba_train: dict) -> dict:
    """The dry run's phase (see `DRYRUN_TRAIN`): emits its line, then
    checks it.  ``zamba_train`` is the train phase's zamba2 run (its
    measured step wall)."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
    from repro_torch.core import planner
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun, op_analysis, train
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    t_phase = time.perf_counter()
    meta = torch.device("meta")

    def counted(ana: dict, launches: dict) -> dict:
        return dict(dot_flops=ana["dot_flops"], hbm_bytes=ana["hbm_bytes"],
                    n_ops=ana["n_ops"], kernels=ana["kernels"],
                    launches=launches)

    # (a) zamba2's train step on the card, then on meta
    arch, b, s = DRYRUN_TRAIN
    cfg = get_config(arch)
    free_model()
    state, step, data, _ = train.build(cfg, batch=b, seq=s, lr=3e-4,
                                       steps=6, device=dev)
    batch = {k: np.ascontiguousarray(v) for k, v in data.batch(0).items()}
    model, opt_state, step_t = state
    params = dict(model.named_parameters())
    mesh = make_smoke_mesh()
    rules = sh.Rules(planner.plan(cfg, "train", s, b, mesh).rules, mesh)
    predicted = dryrun.per_device_bytes(
        dryrun.state_shardings(params, opt_state, rules), mesh.shape)
    held = sum(t.numel() * t.element_size() for t in (
        *params.values(), *opt_state["mu"].values(),
        *opt_state["nu"].values(), opt_state["count"], step_t))
    reset_launches()
    t0 = time.perf_counter()
    ana = op_analysis.analyze(step, state, batch)
    torch.cuda.synchronize()
    train_card = counted(ana, {k: LAUNCHES[k] for k in (
        "ssd", "ssd_bf16", "ssd_bwd", "ssd_bwd_bf16", "flash_attention")})
    train_card["counted_step_s"] = time.perf_counter() - t0
    del ana, state, step, model, opt_state, params, step_t
    free_model()
    model = T.build_model(cfg, device=meta).requires_grad_()
    t0 = time.perf_counter()
    ana = op_analysis.analyze(
        M.make_train_step(cfg, AdamW()),
        (model, M.opt_state_specs(dict(model.named_parameters())),
         torch.zeros((), dtype=torch.int32, device=meta)),
        {k: torch.from_numpy(v).to(meta) for k, v in batch.items()})
    train_meta = counted(ana, {})
    train_meta["trace_s"] = time.perf_counter() - t0
    del ana, model

    # (a) mixtral's long forward on the card, then on meta
    arch_l, reduced, seq = DRYRUN_LONG
    cfg_l = dataclasses.replace(get_config(arch_l), **reduced)
    model = M.init_params(cfg_l, 0, device=dev)
    toks = np.random.default_rng(1).integers(0, cfg_l.vocab, (1, seq),
                                             dtype=np.int32)
    reset_launches()
    with torch.inference_mode():
        ana = op_analysis.analyze(T.forward, cfg_l, model, {
            "tokens": torch.from_numpy(toks).to(dev)})
        torch.cuda.synchronize()
    long_card = counted(ana, {k: LAUNCHES[k] for k in (
        "flash_attention", "flash_attention_bf16", "ragged_dot",
        "ragged_dot_wgmma")})
    del ana, model
    free_model()
    with torch.inference_mode():
        ana = op_analysis.analyze(T.forward, cfg_l, T.build_model(
            cfg_l, device=meta), {"tokens": torch.from_numpy(toks).to(meta)})
    long_meta = counted(ana, {})
    del ana

    # (b) zamba2's step as a share of the card's dense bf16 peak
    wall = zamba_train["step_wall_s"]
    mf = dryrun.model_flops(cfg, "train", b * s)
    shares = dict(
        step_wall_s=wall, model_flops=mf,
        traced_dot_flops=train_card["dot_flops"],
        model_flops_share=mf / wall / dryrun.PEAK_FLOPS,
        traced_share=train_card["dot_flops"] / wall / dryrun.PEAK_FLOPS,
        peak_flops=dryrun.PEAK_FLOPS, card=card)

    # (c) every applicable cell of the single mesh
    cells = []
    for arch_c in ARCHS:
        for shape in SHAPES:
            if not applicable(arch_c, shape)[0]:
                continue
            rec = dryrun.trace_cell(arch_c, shape, multi_pod=False)
            r = rec["roofline"]
            cells.append(dict(
                arch=arch_c, shape=shape, skipped=rec["skipped"],
                trace_s=rec["lower_s"], hlo_flops_total=r["hlo_flops_total"],
                model_flops_total=r["model_flops_total"],
                useful_flops_ratio=r["useful_flops_ratio"],
                dominant=r["dominant"], compute_s=r["compute_s"],
                memory_s=r["memory_s"], collective_s=r["collective_s"],
                argument_size_in_bytes=rec["memory_analysis"][
                    "argument_size_in_bytes"],
                activations=len(rec["activations"])))
    row = dict(phase="dryrun", card=card,
               train=dict(arch=arch, batch=b, seq=s, card=train_card,
                          meta=train_meta),
               long=dict(arch=arch_l, reduced=reduced, seq=seq,
                         card=long_card, meta=long_meta),
               shares=shares,
               state_bytes=dict(mesh=mesh.shape, predicted=predicted,
                                held=held),
               cells=cells,
               seconds=time.perf_counter() - t_phase)
    emit(row)
    for label, card_c, meta_c in (("zamba2's train step", train_card,
                                   train_meta),
                                  ("mixtral's long forward", long_card,
                                   long_meta)):
        check(card_c["dot_flops"] == meta_c["dot_flops"] > 0,
              f"{label}: {card_c['dot_flops']} dot FLOPs on the card, "
              f"{meta_c['dot_flops']} on meta")
        check({k: v["calls"] for k, v in card_c["kernels"].items()} ==
              {k: v["calls"] for k, v in meta_c["kernels"].items()},
              f"{label}: kernel calls {card_c['kernels']} on the card, "
              f"{meta_c['kernels']} on meta")
    n_ssd = ssd_calls(cfg)
    tl = train_card["launches"]
    check(tl["ssd"] == tl["ssd_bf16"] == 2 * n_ssd and
          tl["ssd_bwd"] == tl["ssd_bwd_bf16"] == n_ssd and
          tl["flash_attention"] == 0,
          f"zamba2's counted step launched {tl}")
    def calls(c, name):
        return c["kernels"].get(name, {}).get("calls", 0)
    check(calls(train_card, "ssd") == tl["ssd"] and
          calls(train_card, "ssd_bwd") == tl["ssd_bwd"],
          f"zamba2: counted kernels {train_card['kernels']}, launches {tl}")
    ll = long_card["launches"]
    check(ll["flash_attention"] == ll["flash_attention_bf16"]
          == attention_calls(cfg_l) and ll["ragged_dot"]
          == ll["ragged_dot_wgmma"] == ragged_calls(cfg_l),
          f"mixtral's counted forward launched {ll}")
    check(calls(long_card, "flash_attention") == ll["flash_attention"] and
          calls(long_card, "ragged_dot") == ll["ragged_dot"],
          f"mixtral: counted kernels {long_card['kernels']}, launches {ll}")
    check(predicted == held, f"zamba2's state: {predicted} bytes predicted "
          f"on a 1 x 1 mesh, {held} held")
    check(0 < shares["model_flops_share"] < shares["traced_share"] < 1,
          f"zamba2's step shares of peak {shares}")
    check(cells and all(not c["skipped"] and c["hlo_flops_total"] > 0
                        and c["argument_size_in_bytes"] > 0
                        and c["activations"] for c in cells),
          f"a dry-run cell failed: {cells}")
    return row


def span_walls(tracer) -> dict:
    """Wall seconds and count by span name, from the ported
    `obs.export.to_json`, largest first."""
    from repro_torch.obs import to_json
    spans: dict = {}
    for span in to_json(tracer)["spans"]:
        agg = spans.setdefault(span["name"], dict(count=0, wall_s=0.0))
        agg["count"] += 1
        agg["wall_s"] += span["t1"] - span["t0"]
    return dict(sorted(spans.items(), key=lambda kv: -kv[1]["wall_s"]))


def _race_attrs(tracer) -> tuple[dict, dict]:
    """The "race" span's attributes and each "race-side" span's; a side
    without its ``ok`` attribute raised (the race degraded around it)."""
    (race,) = [s.attrs for s in tracer.finished if s.name == "race"]
    sides = {s.attrs["side"]: s.attrs for s in tracer.finished
             if s.name == "race-side"}
    check(set(sides) == {"exact", "portfolio"}, f"race sides {sides}")
    for side, attrs in sides.items():
        check("ok" in attrs, f"the race's {side} side raised")
    return race, sides


def service_race(dev) -> dict:
    """The exact-vs-portfolio race with its portfolio side on the card:
    the golden C5K5 bandmap case, then the forced-loser case of
    tests/test_exact_race.py (certification off on an infeasible II
    range: only the prover can answer, so the portfolio is cancelled)."""
    from repro_torch.core import CGRAConfig, DeviceSBTS, make_cnkm, map_dfg
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import Tracer
    chunk = DeviceSBTS.__init__.__kwdefaults__["chunk"]
    runs = []
    reset_launches()
    t_phase = time.perf_counter()
    for label, kw in (
            ("C5K5:bandmap", dict(mode="bandmap")),
            ("C5K5:busmap max_ii=2 certify=False seed=7",
             dict(mode="busmap", max_ii=2, certify=False, seed=7))):
        tr = Tracer()
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        r = map_dfg(make_cnkm(5, 5), CGRAConfig(), backend="race",
                    device=dev, tracer=tr, **kw)
        wall = time.perf_counter() - t0
        race, sides = _race_attrs(tr)
        runs.append(dict(
            case=label, ok=r.ok, ii=r.ii, routing_pes=r.n_routing_pes,
            backend=r.backend, winner=race.get("winner"),
            loser=race.get("loser"),
            cancel_latency_s=race.get("cancel_latency_s"),
            loser_iters_after_cancel=race.get("loser_iters_after_cancel"),
            sides={k: dict(ok=v["ok"], wall_s=v.get("wall_s"))
                   for k, v in sides.items()},
            span_walls=span_walls(tr),
            launches=LAUNCHES["selection_counts"] - before, wall_s=wall))
        if kw["mode"] == "bandmap":
            check(r.ok and (r.ii, r.n_routing_pes) == GOLDEN[(5, 5,
                                                             "bandmap")],
                  f"race {label}: {r.summary()}")
        else:
            check(r.backend == "race:exact" and race["winner"] == "exact"
                  and not r.ok and r.proved_infeasible,
                  f"race {label}: the exact side must win: {r.summary()}")
            check(race.get("loser_iters_after_cancel", 0) <= chunk,
                  f"race {label}: the loser ran "
                  f"{race.get('loser_iters_after_cancel')} iterations "
                  f"after the cancel, more than a chunk of {chunk}")
    launches = LAUNCHES["selection_counts"]
    check(launches > 0, "the race phase never launched selection_counts")
    return dict(phase="race", chunk_size=chunk, launches=launches,
                wall_s=time.perf_counter() - t_phase, runs=runs)


def service_comap(dev) -> dict:
    """`co_map` on the card, on the tier-1 cases of tests/test_comap.py
    and on `COMAP_PORTFOLIO_PAIR`; every merged binding that comes back
    ok must pass the port's validator."""
    from repro_torch.comap import co_map
    from repro_torch.core import (CGRAConfig, make_cnkm, make_stencil,
                                  serve_catalog)
    from repro_torch.core.validate import validate_mapping
    from repro_torch.kernels import LAUNCHES, reset_launches
    catalog = {s.name: s for s in serve_catalog("8x8")}
    cases = (
        ("C2K4+stencil(4,3)@8x8", [make_cnkm(2, 4),
                                   make_stencil(points=4, taps=3)],
         CGRAConfig(rows=8, cols=8), 8, True),
        ("C2K6x2@2x2", [make_cnkm(2, 6)] * 2, CGRAConfig(rows=2, cols=2),
         3, False),
        ("+".join(COMAP_PORTFOLIO_PAIR) + "@8x8",
         [catalog[name].build() for name in COMAP_PORTFOLIO_PAIR],
         CGRAConfig(rows=8, cols=8), 8, True))
    runs = []
    reset_launches()
    t_phase = time.perf_counter()
    for label, dfgs, cgra, max_ii, mappable in cases:
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        cm = co_map(dfgs, cgra, max_ii=max_ii, device=dev)
        wall = time.perf_counter() - t0
        valid = None
        if cm.ok:
            valid = (validate_mapping(cm.sched, cgra, cm.placement).ok
                     and len(cm.placement) == len(cm.sched.dfg.ops))
        runs.append(dict(
            case=label, ok=cm.ok, common_ii=cm.ii, rounds=cm.attempts,
            regions=[vars(r) for r in cm.regions],
            region_ii=[None if r is None else r.ii for r in cm.results],
            valid=valid, launches=LAUNCHES["selection_counts"] - before,
            wall_s=wall))
        if mappable:
            check(cm.ok and valid, f"comap {label}: {cm.summary()}")
        else:
            check(not cm.ok and cm.report is None,
                  f"comap {label} must fail cleanly: {cm.summary()}")
    launches = LAUNCHES["selection_counts"]
    check(launches > 0, "the comap phase never launched selection_counts")
    return dict(phase="comap", launches=launches,
                wall_s=time.perf_counter() - t_phase, runs=runs)


def service_trace(dev) -> dict:
    """``run_map_trace``, the ``--map-trace`` entry point, on the card
    with a cold in-memory cache.  The service it builds is captured (its
    ``map_batch`` wrapped for the call) so that every outcome can be
    held to the checks: no crash outcome, no serve-crash event, every ok
    result valid."""
    from repro_torch.core.validate import validate_mapping
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import run_map_trace
    from repro_torch.serve import service as service_mod
    served = []
    map_batch = service_mod.MappingService.map_batch

    def capture(self, requests):
        outcomes = map_batch(self, requests)
        served.append((self, requests, outcomes))
        return outcomes

    service_mod.MappingService.map_batch = capture
    try:
        reset_launches()
        t0 = time.perf_counter()
        metrics = run_map_trace(SERVICE_TRACE, scale="8x8", device=dev,
                                max_workers=SERVICE_WORKERS, quiet=True)
        wall = time.perf_counter() - t0
        launches = LAUNCHES["selection_counts"]
    finally:
        service_mod.MappingService.map_batch = map_batch
    ((svc, requests, outcomes),) = served
    crashes = [o.req_id for o in outcomes if o.source == "crash"]
    crash_events = [e for e in svc.flight.dump()
                    if e["kind"] == "serve-crash"]
    invalid = [o.req_id for req, o in zip(requests, outcomes)
               if o.ok and not validate_mapping(
                   o.result.sched, req.cgra, o.result.placement).ok]
    failed = [dict(req_id=o.req_id, source=o.source, ii=o.result.ii,
                   backend=o.result.backend) for o in outcomes if not o.ok]
    # Where the trace's time goes: its slowest computed requests.
    slowest = sorted((o for o in outcomes if o.source == "computed"),
                     key=lambda o: -o.wall_s)[:3]
    row = dict(
        phase="map-trace", requests=metrics["requests"],
        ok=metrics["ok"], failed=failed, wall_s=wall,
        requests_per_s=metrics["throughput_rps"],
        p50_ms=metrics["p50_ms"], p95_ms=metrics["p95_ms"],
        p99_ms=metrics["p99_ms"], sources=metrics["sources"],
        hit_rate=metrics["hit_rate"],
        cache={k: v for k, v in metrics["cache"].items()
               if k in ("hits", "misses", "puts", "hit_rate")},
        launches=launches, max_workers=SERVICE_WORKERS,
        slowest=[dict(req_id=o.req_id, n_ops=o.result.n_ops,
                      ii=o.result.ii, mii=o.result.mii,
                      attempts=o.result.attempts, wall_s=o.wall_s,
                      map_wall_s=o.result.wall_s) for o in slowest],
        summary=svc.summary())
    check(not crashes and not crash_events,
          f"map-trace: crashed requests {crashes}, events {crash_events}")
    check(not invalid, f"map-trace: invalid ok results {invalid}")
    check(launches > 0, "the map-trace phase never launched "
                        "selection_counts")
    return row


def start_trace_child():
    """Start the map-trace phase in a process of its own, its standard
    output to a temporary file; `_CHILDREN` holds it until it is read."""
    import tempfile
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--map-trace"], stdout=out, cwd=ROOT)
    _CHILDREN.append(proc)
    return proc, out, time.perf_counter() - _T_IMPORT


def read_trace_child(child) -> dict:
    """Wait for the map-trace process and return its row."""
    proc, out, started = child
    rc = proc.wait(timeout=TRACE_CHILD_TIMEOUT_S)
    _CHILDREN.remove(proc)
    out.seek(0)
    lines = out.read().strip().splitlines()
    out.close()
    check(rc == 0 and lines, f"the map-trace process exited with {rc}")
    return dict(json.loads(lines[-1]), started_at_s=started,
                stopped_s=_STOPPED["seconds"])


def trace_main() -> int:
    """``chip_smoke.py --map-trace``: phase 30 alone, its row printed as
    the last line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(service_trace(torch.device("cuda"))), flush=True)
    return 0


def stop_children() -> None:
    """Kill every process the script started and has not read."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    _CHILDREN.clear()


def service_explain(dev) -> dict:
    """Traced and recorded maps on the card: C4K8@8x8 busmap (the host
    settles it) and C5K5 bandmap (the golden case the portfolio
    settles).  For each, the host spans' walls by name, read from the
    ported `obs.export.to_json`, and `MappingResult.explain()`."""
    from repro_torch.core import CGRAConfig, make_cnkm, map_dfg
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import FlightRecorder, Tracer
    runs = []
    reset_launches()
    for label, dfg, cgra, mode in (
            ("C4K8@8x8:busmap", make_cnkm(4, 8), CGRAConfig(rows=8, cols=8),
             "busmap"),
            ("C5K5@4x4:bandmap", make_cnkm(5, 5), CGRAConfig(), "bandmap")):
        tr, rec = Tracer(), FlightRecorder()
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        r = map_dfg(dfg, cgra, mode=mode, device=dev, tracer=tr,
                    record=rec)
        wall = time.perf_counter() - t0
        spans = span_walls(tr)
        rep = r.explain(tracer=tr, flight=rec.dump())
        runs.append(dict(
            case=label, ok=r.ok, ii=r.ii, routing_pes=r.n_routing_pes,
            wall_s=wall, launches=LAUNCHES["selection_counts"] - before,
            span_walls=spans, explain=rep.render().splitlines()))
        check(r.ok and rep.ok and rep.ii == r.ii,
              f"explain {label}: {r.summary()}")
        check(set(spans) >= {"map-dfg", "schedule", "conflict-build"},
              f"explain {label}: spans {sorted(spans)}")
    launches = LAUNCHES["selection_counts"]
    check(launches > 0, "the explain phase never launched "
                        "selection_counts")
    return dict(phase="explain", launches=launches, runs=runs)


def tf32_sass(libs: dict) -> dict | None:
    """The TF32 tensor-core instructions (``HGMMA.*.F32.TF32``,
    ``HMMA.*.F32.TF32``) in the SASS of each library with fp32 kernels on
    them, by ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = {}
    for name in ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd",
                 "ragged_dot", "ragged_dot_bwd"):
        text = subprocess.run([tool, "-sass", libs[name]],
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts = {}
        for op in re.findall(r"\b(H[G]?MMA\.\S*F32\.TF32)\b", text):
            counts[op] = counts.get(op, 0) + 1
        out[name] = counts
    return out


def fp32_ragged(rows: list, part: str, checks: dict) -> dict:
    """The kernel table's fp32-route entry of `ragged_dot` (``part``
    "fwd") or one half of its backward ("dx", "dw"): its row at
    `FP32_RAGGED_ARCH`'s captured gate/up shape, the smoke shapes' rows
    beside, and its launches on the TF32 tensor cores in
    train-card-vs-cpu's fp32 steps."""
    mine = [r for r in rows if r["part"] == part]
    key = "ragged_dot_fp32_tc" if part == "fwd" else \
        "ragged_dot_bwd_fp32_tc"
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fp32_rate_ms", "library_ms", "library", "max_abs_err")
    return dict({k: mine[0][k] for k in keys},
                kernel={"fwd": "ragged_tf32_kernel<false>",
                        "dx": "ragged_tf32_kernel<true>",
                        "dw": "ragged_dw_tf32_kernel"}[part] +
                " (3xTF32, wgmma.m64n128k8)",
                source="src/repro_torch/kernels/ragged_dot/csrc/" + (
                    "ragged_dot.cu" if part == "fwd" else
                    "ragged_dot_bwd.cu"),
                source_kernel="src/repro_torch/kernels/ragged_dot/csrc/"
                              "ragged_tf32.cuh",
                shape=[mine[0][k] for k in ("m", "k", "n", "groups")],
                launches_card_vs_cpu={name: c["launches"].get(key, 0)
                                      for name, c in checks["runs"].items()},
                path_shapes=[{k: r[k] for k in ("case", "m", "k", "n",
                                                "groups") + keys}
                             for r in mine])


def backward_row(name: str, rd_bwd: dict, fa_bwd: dict, train_runs: dict,
                 checks: dict) -> dict:
    """The kernel table's row of one backward kernel: its time, bound,
    plain and library times at the main path's shape (mixtral's gate/up
    backward for the grouped product's, gemma3's global layer in bf16
    for flash's; each path shape and the fp32 route beside), its launches
    in the training run that took it, and its largest error."""
    flash = name.startswith("flash")
    part = name.rsplit("_", 1)[1]
    extra = {}
    if flash:
        rows = fa_bwd["cases"]
        main = next(r for r in rows if r["arch"] == "gemma3-4b" and
                    r["label"] == "flash_global" and r["dtype"] == "bfloat16")
        run = train_runs["gemma3-4b"]
        launches = run["launches"].get("flash_attention_bwd", 0)
        err = max(r["max_abs_err"][p] for r in rows
                  for p in (("dq",) if part == "dq" else ("dk", "dv")))
        source = "flash_attention/csrc/flash_attention_bwd.cu"
        replaces = ("src/repro/kernels/flash_attention/kernel.py:89 "
                    "(flash_attention_pallas has no custom_vjp: the "
                    "reference's jax.grad differentiates ref.py:19 "
                    "flash_attention_ref)")
        shape = (f"{tuple(main['shape'])} Hkv {main['kv_heads']} bf16 "
                 f"causal (gemma3-4b's global layer)")
        f32 = next(r for r in rows if r["arch"] == main["arch"] and
                   r["label"] == main["label"] and r["dtype"] == "float32")
        extra = dict(fp32=dict(
            {k: f32[part][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
            route=f32["route"], library_ms=f32["library_ms"],
            max_abs_err=max(f32["max_abs_err"][p] for p in (
                ("dq",) if part == "dq" else ("dk", "dv")))))
    else:
        rows = [r for r in rd_bwd["cases"] if "ms" in r]
        main = next(r for r in rows
                    if r["case"] == "mixtral-8x7b gate/up")
        run = train_runs["mixtral-8x7b"]
        launches = run["launches"].get("ragged_dot_bwd", 0)
        err = max(r["max_abs_err"][part] for r in rd_bwd["cases"])
        source = "ragged_dot/csrc/ragged_dot_bwd.cu"
        replaces = ("src/repro/models/moe.py:67 (jax.grad through "
                    "jax.lax.ragged_dot in moe_ffn: XLA's transpose, no "
                    "pl.pallas_call)")
        shape = (f"({main['m']}, {main['k']}, {main['n']}; {main['groups']} "
                 f"groups) bf16 x, fp32 w (mixtral-8x7b gate/up)")
        extra = dict(fp32=fp32_ragged(rd_bwd["fp32_x"], part,
                                      dict(runs=checks)))
    mine = main[part]
    return dict(
        name=name, route="cuda", source="src/repro_torch/kernels/" + source,
        replaces=replaces, launches=launches,
        launches_from=f"train, {run['argv'][1]} {run['reduced']}, "
                      f"{run['steps_run']} steps",
        launches_card_vs_cpu={k: c["launches"].get(
            "flash_attention_bwd" if flash else "ragged_dot_bwd", 0)
            for k, c in checks.items()},
        max_abs_err=err, ms=mine["ms"], ms_both_kernels=main["ms"],
        kernels=main["route"],
        plain_ms=mine["plain_ms"], bound_ms=mine["bound_ms"],
        bound_by=mine["bound_by"],
        library_ms=main["library_ms"] if flash else mine["library_ms"],
        library=main["library"] + " (dq, dk and dv in one call)" if flash
        else mine["library"],
        shape=shape,
        path_shapes=[dict(case=r.get("case") or f"{r['arch']} {r['label']}",
                          dtype=r.get("dtype") or r["x"], kernels=r["route"],
                          ms=r[part]["ms"], bound_ms=r[part]["bound_ms"],
                          plain_ms=r[part]["plain_ms"],
                          library_ms=r["library_ms"] if flash else
                          r[part]["library_ms"])
                     for r in rows], **extra)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core import (CGRAConfig, DeviceSBTS,
                                  build_conflict_graph, make_cnkm, map_dfg)
    from repro_torch.core.bitset import pack_bool, pack_words
    from repro_torch.core.conflict import constructive_init
    from repro_torch.kernels.conflict_matrix.ref import encode
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.sbts_step import selection_counts
    from repro_torch.kernels.sbts_step.probe import mma_rates
    from repro_torch.kernels.sbts_step.ref import selection_counts_plain

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    emit(dict(phase="card", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))
    t0 = time.perf_counter()
    libs = _build.build_all()
    sass = tf32_sass(libs)
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries=sorted(libs),
              ptxas={name: [ln.strip() for ln in
                            _build.build_log(name).splitlines()
                            if "entry function" in ln
                            or "registers" in ln or "spill" in ln]
                     for name in sorted(libs)},
              sass_tf32=sass))
    for name in ("ragged_dot", "ragged_dot_bwd"):
        check(sass is None or any(k.startswith("HGMMA") for k in sass[name]),
              f"{name}: no TF32 wgmma in its SASS ({sass and sass[name]})")

    # ---- the main path's graphs
    graphs = {}
    for name, (n, m, mode, side) in {
            "C5K5@4x4:bandmap": (5, 5, "bandmap", 4),
            "C4K8@8x8:busmap": (4, 8, "busmap", 8),
            "C4K8@16x16:bandmap": (4, 8, "bandmap", 16)}.items():
        cgra = CGRAConfig(rows=side, cols=side)
        sched, cg = conflict_graph(make_cnkm(n, m), cgra, mode)
        graphs[name] = (sched, cg, cgra)
    cgra16 = CGRAConfig(rows=16, cols=16)
    workloads = {name: conflict_graph(dfg, cgra16, "bandmap")
                 for name, dfg in workload_dfgs().items()}

    # ---- 2. the kernel against its plain version
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = 0
    checked = []

    def compare(label: str, rows32, sel32) -> None:
        nonlocal max_err
        got = selection_counts(rows32, sel32)
        torch.cuda.synchronize()
        want = selection_counts_plain(rows32, sel32)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        max_err = max(max_err, err)
        checked.append(dict(case=label, k=sel32.shape[0],
                            n_pad=rows32.shape[0], w=rows32.shape[1],
                            max_abs_err=err))
        check(torch.equal(got, want), f"kernel != plain version: {label}")

    for name, (sched, cg, cgra) in graphs.items():
        eng = DeviceSBTS(cg.bits, k=1, device=dev)
        n_pad = eng._n_pad
        rows32 = cg.bits.rows_i32(n_pad, dev)
        w = rows32.shape[1]
        for k in (32, 1024):
            sel = torch.randint(-2**31, 2**31 - 1, (k, w),
                                dtype=torch.int32, device=dev,
                                generator=gen)
            compare(f"{name} random K={k}", rows32, sel)
            eng = DeviceSBTS(cg.bits, k=k, seed=3, device=dev)
            eng.run(8)
            compare(f"{name} engine K={k}", rows32,
                    pack_words(eng.state[0]))
        for k in (1, 37, 1000):
            sel = torch.randint(-2**31, 2**31 - 1, (k, w),
                                dtype=torch.int32, device=dev,
                                generator=gen)
            compare(f"{name} ragged K={k}", rows32, sel)
        ones_rows = torch.full_like(rows32, -1)
        ones_sel = torch.full((45, w), -1, dtype=torch.int32, device=dev)
        compare(f"{name} all-ones", ones_rows, ones_sel)
        check(bool((selection_counts(ones_rows, ones_sel) == 32 * w).all()),
              "all-ones words must count 32 per word")

    # The tensor-core kernel's edges beyond the graphs' shapes: W = 4
    # (one panel, mostly zero), n_pad off its 256-vertex tile (odd ones
    # store one int32 at a time), K off its 128-trajectory tile, and its
    # plain loads (W % 4 != 0; an operand one word off 16-byte alignment).
    def words(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def at_offset(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=dev)[1:].view(t.shape)
        out.copy_(t)
        return out

    for k, w, n in ((1, 4, 200), (1000, 4, 200), (32, 68, 2177),
                    (1000, 264, 8549), (1024, 264, 8320), (37, 5, 300)):
        compare(f"K={k} W={w} n_pad={n}", words((n, w)), words((k, w)))
    compare("rows one word off 16-byte alignment",
            at_offset(words((300, 8))), words((70, 8)))
    compare("sel one word off 16-byte alignment",
            words((300, 8)), at_offset(words((70, 8))))
    emit(dict(phase="kernel-vs-plain", tolerance=0, max_abs_err=max_err,
              cases=checked))

    # ---- 3. the main path
    reset_launches()
    cases = []
    for (n, m, mode), pair in GOLDEN.items():
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        r = map_dfg(make_cnkm(n, m), CGRAConfig(), mode=mode)
        wall = time.perf_counter() - t0
        label = f"C{n}K{m}:{mode}"
        cases.append(dict(case=label, ok=r.ok, ii=r.ii,
                          routing_pes=r.n_routing_pes,
                          v_c=r.cg_size[0], wall_s=wall,
                          launches=LAUNCHES["selection_counts"] - before))
        check(r.ok, f"{label} failed: {r.summary()}")
        check((r.ii, r.n_routing_pes) == pair,
              f"{label}: (II, routing PEs) = "
              f"{(r.ii, r.n_routing_pes)}, golden {pair}")
        check(r.mis_size == r.n_ops, f"{label}: MIS does not cover ops")
    for n, m, mode, side in ((4, 8, "busmap", 8), (4, 8, "bandmap", 16)):
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        r = map_dfg(make_cnkm(n, m), CGRAConfig(rows=side, cols=side),
                    mode=mode)
        wall = time.perf_counter() - t0
        label = f"C{n}K{m}@{side}x{side}:{mode}"
        cases.append(dict(case=label, ok=r.ok, ii=r.ii, mii=r.mii,
                          routing_pes=r.n_routing_pes,
                          v_c=r.cg_size[0], wall_s=wall,
                          launches=LAUNCHES["selection_counts"] - before))
        check(r.ok and r.mis_size == r.n_ops, f"{label} failed")
        check(r.ii == r.mii, f"{label}: II {r.ii} above MII {r.mii}")
    main_launches = LAUNCHES["selection_counts"]
    emit(dict(phase="main-path", launches=main_launches, cases=cases))
    check(main_launches == MAIN_PATH_LAUNCHES,
          f"the main path launched selection_counts {main_launches} "
          f"times, not {MAIN_PATH_LAUNCHES}")

    # ---- 4. the engine on the card vs on the CPU
    sched, cg, cgra = graphs["C4K8@8x8:busmap"]
    inits = [constructive_init(cg, sched, cgra, seed=i)
             if i % 3 != 2 else None for i in range(16)]
    states = {}
    t_dev = {}
    for where in ("cuda", "cpu"):
        eng = DeviceSBTS(cg.bits, inits, k=64, seed=7, device=where)
        t0 = time.perf_counter()
        eng.run(64)
        t_dev[where] = time.perf_counter() - t0
        states[where] = [t.cpu() for t in eng.state]
    same = all(torch.equal(a, b)
               for a, b in zip(states["cuda"], states["cpu"]))
    emit(dict(phase="cuda-vs-cpu", k=64, iters=64, bit_identical=same,
              wall_s=t_dev))
    check(same, "engine state on the card differs from the CPU's")

    # ---- 5. full width
    widths = []
    for name in ("C4K8@8x8:busmap", "C4K8@16x16:bandmap"):
        sched, cg, cgra = graphs[name]
        n_ops = len(sched.dfg.ops)
        eng = DeviceSBTS(cg.bits, k=1024, seed=0, device=dev)
        eng.run(2)                         # warm-up
        eng = DeviceSBTS(cg.bits, k=1024, seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = LAUNCHES["selection_counts"]
        t0 = time.perf_counter()
        best = eng.run(48, target=n_ops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        independent = all(not cg.bits.any_conflict(pack_bool(row))
                          for row in best)
        iters = eng.it
        launches = LAUNCHES["selection_counts"] - before
        coverage = f"{int(eng.best_size.max())}/{n_ops}"
        # Device time of 16 more iterations, against the unprofiled wall
        # per iteration above: the card's busy share of a lock-step.
        prof = device_profile(lambda: eng.run(16))
        dev_ms = None if prof["device_ms"] is None \
            else prof["device_ms"] / 16
        widths.append(dict(
            graph=name, v_c=cg.n, k=1024, iters=iters,
            coverage=coverage, iters_per_s=iters / wall, wall_s=wall,
            wall_ms_per_iter=1e3 * wall / iters,
            device_ms_per_iter=dev_ms,
            device_busy_share=None if dev_ms is None
            else dev_ms / (1e3 * wall / iters),
            top_kernels_per_16_iters=prof["top"],
            launches_per_iter=launches / max(1, iters),
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            independent=independent,
            **(dict(earlier_wall_ms_per_iter=EARLIER_ITER_MS_16X16,
                    earlier_iters_per_s=1e3 / EARLIER_ITER_MS_16X16,
                    earlier_from="quoted from PERF.md section 5 (before "
                                 "the tensor-core selection_counts), not "
                                 "measured in this run")
               if name == "C4K8@16x16:bandmap" else {})))
        check(independent, f"{name}: a best is not an independent set")
    emit(dict(phase="full-width", card=card, runs=widths))

    # ---- 6. the conflict kernels against their plain versions
    feats = {f"{name}": torch.from_numpy(encode(cg.vertices))
             for name, (_, cg, _) in graphs.items()}
    feats.update({f"{name}@16x16": torch.from_numpy(encode(cg.vertices))
                  for name, (_, cg) in workloads.items()})
    # One below, at and one above one and two of the dense kernel's
    # row tiles and column strips.
    from repro_torch.kernels.conflict_matrix.ref import STRIP, TILE_ROWS
    edges = [e + d for e in (TILE_ROWS, 2 * TILE_ROWS, STRIP, 2 * STRIP)
             for d in (-1, 0, 1)]
    for n in sorted({0, 1, 100, 1000, 8 * STRIP + 1, *edges}):
        feats[f"random n={n}"] = random_features(n, seed=n)
    for n in (100, 777, 1025):
        feats[f"one-op n={n}"] = random_features(n, seed=n, one_op=True)
    for n in (33, 777, 4097):
        feats[f"wide n={n}"] = random_features(n, seed=n, wide=True)
    for n in (65, 2049):
        feats[f"fold-edge n={n}"] = random_features(n, seed=n,
                                                    fold_edge=True)
    for n in (1100, 3000):
        feats[f"mixed n={n}"] = random_features(n, seed=n, mixed=True)
    vs_plain = check_conflict_kernels(feats, dev)
    emit(dict(phase="conflict-kernels-vs-plain", tolerance=0, **vs_plain))

    # ---- 7. the conflict route: "packed-cuda" against the host build
    route_graphs = {"C4K8@16x16:bandmap": graphs["C4K8@16x16:bandmap"][0]}
    route_graphs.update({f"{name}@16x16": sched
                         for name, (sched, _) in workloads.items()})
    reset_launches()
    route = conflict_route(route_graphs, cgra16, dev)
    route_launches = {name: LAUNCHES[name] for name in
                      ("conflict_matrix", "conflict_matrix_packed")}
    # The slow host oracle ("packed": dense numpy + pack) on one graph.
    sched, cg, _ = graphs["C4K8@16x16:bandmap"]
    t0 = time.perf_counter()
    oracle = build_conflict_graph(sched, cgra16, bus_pressure=True,
                                  use_kernel="packed")
    t_oracle = time.perf_counter() - t0
    check(oracle.bits.rows.tobytes() == cg.bits.rows.tobytes(),
          "host 'packed' oracle differs from the host build")
    emit(dict(phase="conflict-route", launches=route_launches, runs=route,
              oracle=dict(graph="C4K8@16x16:bandmap", packed_s=t_oracle)))
    for name, count in route_launches.items():
        check(count > 0, f"the conflict route never launched {name}")

    # ---- 8. the 16x16 workloads through map_dfg
    reset_launches()
    emit(dict(phase="workloads-16x16",
              cases=map_workloads(workload_dfgs(), cgra16)))

    # ---- 9. times
    # The rates of the tensor-core instructions that could carry
    # selection_counts: what chose the .b1 wgmma, and its bound's rate.
    rates = mma_rates()
    b1_rate = rates["wgmma m64n256k256 .b1 .and.popc"]
    times = []
    for name, (sched, cg, cgra) in graphs.items():
        eng = DeviceSBTS(cg.bits, k=1024, seed=5, device=dev)
        eng.run(8)
        n_pad = eng._n_pad
        rows32 = cg.bits.rows_i32(n_pad, dev)
        adj8 = torch.zeros((n_pad, n_pad), dtype=torch.int8, device=dev)
        adj8[:cg.n, :cg.n] = torch.from_numpy(
            cg.bits.to_dense().astype("int8")).to(dev)
        for k in (32, 1024):
            sel_bits = eng.state[0][:k].contiguous()
            sel32 = pack_words(sel_bits)
            w = rows32.shape[1]
            sel8 = sel_bits.to(torch.int8)
            lib = torch._int_mm(sel8, adj8)       # adjacency is symmetric
            check(torch.equal(lib, selection_counts(rows32, sel32)),
                  f"{name}: torch._int_mm yardstick disagrees")
            reps = 200 if k == 1024 else 500
            ms = cuda_ms(lambda: selection_counts(rows32, sel32), reps)
            # The card's own time a call (ms above also holds the
            # wrapper's host time, which leads at the small shapes).
            prof = device_profile(
                lambda: [selection_counts(rows32, sel32) for _ in range(20)],
                calls=20)
            times.append(dict(
                graph=name, k=k, n_pad=n_pad, w=w, ms=ms,
                device_ms=prof["device_ms"],
                plain_ms=cuda_ms(
                    lambda: selection_counts_plain(rows32, sel32), 5),
                library_ms=cuda_ms(lambda: torch._int_mm(sel8, adj8),
                                   reps),
                **counts_bound(k, n_pad, w, ms, b1_rate),
                launches_per_iter=3))
    conflict_times = time_conflict_kernels(workloads, dev)
    emit(dict(phase="times", card=card, mma_ops_per_s=rates,
              mma_probe="src/repro_torch/kernels/sbts_step/csrc/"
                        "mma_probe.cu: 2 blocks an SM, each instruction "
                        "on operands that stay put; 2 m n k operations "
                        "an instruction (k in bits for .b1)",
              runs=times, conflict_runs=conflict_times))
    # Phase 30 from here on, in a process of its own: phases 2-9 time the
    # mapper's host-bound lock-steps, which a second process slows.
    trace_child = start_trace_child()

    # ---- 10-16. the LLM paths: zamba2-1.2b, mamba2-2.7b and gemma3-4b
    # at their published widths, each served and run long, then freed;
    # the other dense configs at 2 layers
    from repro_torch.configs import get_config
    from repro_torch.models import model as llm
    captured, serve_rows, long_rows = {}, {}, {}
    for arch in (LLM_ARCH,) + FAMILY_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        model = llm.init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        serve_rows[arch], serve_caps = llm_serve(
            cfg, model, dev, dict(card=card, init_s=init_s, params=sum(
                p.numel() for p in model.parameters())))
        long_rows[arch], long_caps = llm_forward_long(
            cfg, model, dev, dict(card=card))
        captured[arch] = {"flash_long": long_caps["flash_long"],
                          "ssd_long": long_caps["ssd_long"],
                          "ssd_serve": serve_caps["ssd_serve"]}
        del model, serve_caps, long_caps
        free_model()
    dense_rows, dense_caps = llm_dense_widths(dev, card)
    captured.update({arch: {"flash_long": cap}
                     for arch, cap in dense_caps.items()})

    # ---- 17-20. the moe family: ragged_dot against its plain version,
    # then mixtral-8x7b (4 layers) and deepseek-v2-lite-16b (uncut)
    rd_vs = ragged_vs_plain(dev)
    emit(dict(phase="ragged-dot-vs-plain",
              tolerance=dict(atol=RAGGED_ATOL, rtol=RAGGED_RTOL), **rd_vs))
    moe = llm_moe(dev, card, captured)
    serve_rows.update(moe["serve"])
    long_rows.update(moe["long"])

    # ---- 21. the encdec and vision families: whisper-tiny uncut, then
    # qwen2-vl-72b at 4 layers
    encdec_vision, captured[VISION_ARCH] = llm_encdec_vision(dev, card)

    # ---- 22-23. the kernels against their plain versions and their
    # times, at every path's captured inputs
    llm_vs = llm_kernels_vs_plain(dev, captured)
    emit(dict(phase="llm-kernels-vs-plain",
              tolerances=dict(flash_attention=FA_TOL,
                              ssd=dict(atol=SSD_ATOL, rtol=SSD_RTOL)),
              **llm_vs))
    llm_rows = llm_times(captured)
    emit(dict(phase="llm-times", card=card, runs=llm_rows))
    fa_row, fa32_row = (time_row(llm_rows, LLM_ARCH, "flash_long", dtype)
                        for dtype in ("bfloat16", "float32"))
    ssd_row, ssd32_row = (time_row(llm_rows, LLM_ARCH, "ssd_long", dtype)
                          for dtype in ("bfloat16", "float32"))
    path_err = {kind: max(v[key] for v in llm_vs["path"].values()
                          if key in v)
                for kind, key in (("flash", "max_abs_err"),
                                  ("ssd", "max_abs_err_y"))}
    ssd_err = max(max(c["max_abs_err_y"] for c in llm_vs["ssd"]),
                  path_err["ssd"])
    fa_err = max(max(c["max_abs_err"] for c in llm_vs["flash_attention"]),
                 path_err["flash"])

    # ---- 24-26. training: launch.train.main on lm100m (a failure and a
    # restart), zamba2-1.2b uncut, mixtral, deepseek and gemma3 cut in
    # depth; the three backward kernels against their plain versions; one
    # fp32 step on the card against the host
    train_row, bwd_capture, moe_caps = llm_train(dev, card)
    emit(train_row)
    bwd_row = ssd_bwd_vs_plain(dev, bwd_capture)
    emit(bwd_row)
    del bwd_capture
    free_model()
    rd_bwd_row = ragged_bwd_vs_plain(dev, moe_caps)
    emit(rd_bwd_row)
    del moe_caps
    free_model()
    fa_bwd_row = flash_bwd_vs_plain(dev, captured)
    emit(fa_bwd_row)
    check_row = train_card_vs_cpu(dev)
    emit(check_row)

    # ---- 27. the dry run: op-level counts on the card and on meta, the
    # train step's share of peak, the single mesh's cells
    dry_row = dryrun_phase(dev, card, train_row["runs"][LLM_ARCH])
    zamba_train = train_row["runs"][LLM_ARCH]
    bwd_main = next(r for r in bwd_row["cases"]
                    if r["case"] == SSD_BWD_CASES[0][0]
                    and r["dtype"] == "bfloat16")
    bwd32 = next(r for r in bwd_row["cases"]
                 if r["case"] == SSD_BWD_CASES[0][0]
                 and r["dtype"] == "float32")

    # ---- 28-31. the service tier: race, co-mapping, the serve tier
    # behind --map-trace, and traced maps with their explain reports
    service = {}
    for run in (service_race, service_comap,
                lambda _dev: read_trace_child(trace_child), service_explain):
        row = run(dev)
        service[row["phase"]] = row["launches"]
        emit(dict(row, card=card))

    # ---- the kernel table: the full-width shape of the main path, with
    # each LLM path's launches and the new paths' shapes
    flash_launches = {arch: dict(
        forward_long=long_rows[arch]["launches"]["flash_attention_bf16"],
        forward_long_by_window=long_rows[arch]["flash_calls_by_window"],
        serve=serve_rows[arch]["launches"]["flash_attention"])
        for arch in serve_rows if arch in long_rows}
    flash_launches.update({r["arch"]: dict(
        forward_long=r["long"]["launches"]["flash_attention_bf16"],
        wave=r["wave"]["launches"]["flash_attention"], reduced=r["reduced"])
        for r in dense_rows})
    vision_row = encdec_vision[VISION_ARCH]
    flash_launches[VISION_ARCH] = dict(
        forward_long=vision_row["long"]["launches"]["flash_attention_bf16"],
        wave=vision_row["wave"]["launches"]["flash_attention"],
        reduced=vision_row["reduced"])
    flash_launches[ENCDEC_ARCH] = {
        run: encdec_vision[ENCDEC_ARCH][run]["launches"]["flash_attention"]
        for run in ("forward", "wave")}
    ssd_launches = {arch: dict(
        forward_long=long_rows[arch]["launches"]["ssd_bf16"],
        serve=serve_rows[arch]["launches"]["ssd_bf16"],
        serve_fp32_check=serve_rows[arch]["teacher_forced_launches"][
            "fp32"]["ssd_fp32"])
        for arch in serve_rows if ssd_calls(get_config(arch))}
    row = next(t for t in times
               if t["graph"] == "C4K8@16x16:bandmap" and t["k"] == 1024)
    rd_row = next(r for r in moe["ragged"] if r["arch"] == MOE_ARCHS[0]
                  and r["label"] == "prefill gate/up")
    rd_keys = ("ms", "ms_bf16_weights", "earlier_ms", "earlier_with_cast_ms",
               "bound_ms", "bound_by", "bound_bf16_weights_ms", "plain_ms",
               "library_ms", "library_cast_ms", "library_loop_ms",
               "max_abs_err", "bit_equal_bf16_weights", "groups_used",
               "calls_in_path")
    rd_launches = {arch: dict(
        serve=r["launches"]["ragged_dot"],
        serve_wgmma=r["launches"]["ragged_dot_wgmma"],
        teacher_forced=r["teacher_forced_launches"]["bf16"]["ragged_dot"],
        forward_long=moe["long"][arch]["launches"]["ragged_dot"]
        if arch in moe["long"] else None)
        for arch, r in moe["serve"].items()}
    rd_launches[MOE_ARCHS[0]]["capacity_forward"] = \
        moe["capacity"]["launches"]["ragged_dot"]
    emit({"kernels": [dict(
        name="selection_counts", route="cuda",
        source="src/repro_torch/kernels/sbts_step/csrc/"
               "selection_counts.cu",
        replaces="src/repro/kernels/sbts_step/kernel.py:42",
        launches=main_launches, launches_service=service,
        max_abs_err=max_err, ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        bound_ops_rate=row["bound_ops_rate"],
        shape=f"K={row['k']} n_pad={row['n_pad']} W={row['w']}")] + [
        dict(name=kernel, route="cuda",
             source="src/repro_torch/kernels/conflict_matrix/csrc/"
                    "conflict_matrix.cu",
             replaces=replaces, launches=route_launches[kernel],
             max_abs_err=vs_plain["max_abs_err"][kernel], ms=t["ms"],
             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             bound_by=t["bound_by"], library_ms=None,
             device_ms=t["device_ms"], shape=f"n={t['n']} ({t['graph']})")
        for kernel, replaces in (
            ("conflict_matrix",
             "src/repro/kernels/conflict_matrix/kernel.py:148"),
            ("conflict_matrix_packed",
             "src/repro/kernels/conflict_matrix/kernel.py:116"))
        for t in conflict_times
        if t["kernel"] == kernel and t["graph"] == "reduce32@16x16"] + [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_tc.cu",
             source_fp32="src/repro_torch/kernels/flash_attention/csrc/"
                         "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:89",
             launches=long_rows[LLM_ARCH]["launches"][
                 "flash_attention_bf16"],
             launches_by_arch=flash_launches,
             max_abs_err=fa_err, ms=fa_row["ms"],
             plain_ms=fa_row["plain_ms"], bound_ms=fa_row["bound_ms"],
             bound_by=fa_row["bound_by"], library_ms=fa_row["library_ms"],
             shape=f"{tuple(fa_row['shape'])} bf16 causal "
                   f"(llm-forward-long)",
             fp32=dict({key: fa32_row[key] for key in (
                 "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                 "fp32_rate_bound_ms", "library_ms")},
                 launches=fa32_row["route_launches_in_phase"],
                 launches_from="llm-times"),
             path_shapes=path_shapes(llm_rows, "flash_attention")),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_tc.cu",
             source_fp32="src/repro_torch/kernels/ssd/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:80",
             launches=long_rows[LLM_ARCH]["launches"]["ssd_bf16"],
             launches_serving=serve_rows[LLM_ARCH]["launches"]["ssd_bf16"],
             launches_by_arch=ssd_launches,
             max_abs_err=ssd_err, ms=ssd_row["ms"],
             plain_ms=ssd_row["plain_ms"], bound_ms=ssd_row["bound_ms"],
             bound_by=ssd_row["bound_by"], library_ms=None,
             shape=f"{tuple(ssd_row['shape'])} N={ssd_row['n']} "
                   f"chunk={ssd_row['chunk']} bf16 (llm-forward-long)",
             fp32=dict({key: ssd32_row[key] for key in (
                 "ms", "max_abs_err_y", "plain_ms", "bound_ms", "bound_by",
                 "fp32_rate_bound_ms", "library_ms")},
                 launches=ssd32_row["route_launches_in_phase"],
                 launches_from="llm-times (both path shapes)",
                 launches_serving=serve_rows[LLM_ARCH][
                     "teacher_forced_launches"]["fp32"]["ssd_fp32"]),
             path_shapes=path_shapes(llm_rows, "ssd")),
        dict(name="ragged_dot", route="cuda",
             source="src/repro_torch/kernels/ragged_dot/csrc/ragged_dot.cu",
             replaces="src/repro/models/moe.py:67 (jax.lax.ragged_dot in "
                      "moe_ffn, an XLA operation: no pl.pallas_call)",
             launches=rd_launches[MOE_ARCHS[0]]["serve"],
             launches_from=f"llm-serve, {MOE_ARCHS[0]}",
             launches_by_arch=rd_launches,
             max_abs_err=max([rd_vs["max_abs_err"]] +
                             [r["max_abs_err"] for r in moe["ragged"]]),
             ms=rd_row["ms"], plain_ms=rd_row["plain_ms"],
             earlier_ms=rd_row["earlier_ms"],
             earlier_with_cast_ms=rd_row["earlier_with_cast_ms"],
             bound_ms=rd_row["bound_ms"], bound_by=rd_row["bound_by"],
             bound_bf16_weights_ms=rd_row["bound_bf16_weights_ms"],
             library_ms=rd_row["library_ms"],
             library="torch._grouped_mm on the weights cast to bf16",
             library_cast_ms=rd_row["library_cast_ms"],
             library_loop_ms=rd_row["library_loop_ms"],
             shape=f"({rd_row['m']}, {rd_row['k']}) bf16 x "
                   f"({rd_row['groups']}, {rd_row['k']}, {rd_row['n']}) "
                   f"fp32 ({MOE_ARCHS[0]} "
                   f"prefill gate/up)",
             fp32=fp32_ragged(moe["ragged_fp32"], "fwd", check_row),
             path_shapes=[dict({k: r[k] for k in rd_keys}, arch=r["arch"],
                               label=r["label"],
                               shape=[r["m"], r["k"], r["n"], r["groups"]])
                          for r in moe["ragged"]]),
        dict(name="ssd_bwd", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_bwd_tc.cu",
             source_fp32="src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:80 (ssd_pallas has "
                      "no custom_vjp: the reference's jax.grad "
                      "differentiates ref.py:35 ssd_chunked)",
             launches=zamba_train["launches"]["ssd_bwd"],
             launches_from=f"train, {LLM_ARCH} uncut, "
                           f"{zamba_train['steps_run']} steps",
             launches_card_vs_cpu=check_row["runs"][LLM_ARCH]["launches"][
                 "ssd_bwd"],
             max_abs_err=max(bwd_main["max_abs_err"].values()),
             ms=bwd_main["ms"], plain_ms=bwd_main["plain_ms"],
             bound_ms=bwd_main["bound_ms"], bound_by=bwd_main["bound_by"],
             bound_per_head_bc_ms=bwd_main["bound_per_head_bc_ms"],
             library_ms=None,
             shape=f"{tuple(bwd_main['shape'])} N={bwd_main['n']} "
                   f"chunk={bwd_main['chunk']} bf16 ({LLM_ARCH} train "
                   f"step)",
             fp32=dict({key: bwd32[key] for key in (
                 "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                 "bound_per_head_bc_ms", "fp32_rate_bound_ms", "route")}, launches_card_vs_cpu=check_row["runs"][
                     LLM_ARCH]["launches"].get("ssd_bwd_fp32", 0)),
             path_shapes=[{k: r[k] for k in (
                 "case", "dtype", "shape", "n", "chunk", "ms", "plain_ms",
                 "bound_ms", "bound_by", "max_abs_err")}
                 for r in bwd_row["cases"] if "ms" in r])] + [
        backward_row(part, rd_bwd_row, fa_bwd_row, train_row["runs"],
                     check_row["runs"])
        for part in ("ragged_dot_dx", "ragged_dot_dw", "flash_bwd_dq",
                     "flash_bwd_dkdv")],
        "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    # A run stopped by SIGTERM still stops the processes it started.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        sys.exit(trace_main() if sys.argv[1:] == ["--map-trace"]
                 else main())
    finally:
        stop_children()
