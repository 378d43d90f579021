#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA GPU and the CUDA toolkit (``nvcc``); without a GPU,
or outside a checkout of the repository, it exits non-zero and prints
no result.  It imports nothing of JAX or of the JAX package.  Phases,
each printed as one JSON line:

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
   hybrid tolerance (atol = rtol = 0.15, tests/test_models.py:100-106);
   in bf16, as served, the prefill within it, and at each decode step
   the same argmax wherever the no-cache forward's top-2 margin exceeds
   twice it (the rule the CPU tests hold `WaveServer` to: 38 random
   layers part bf16 roundings by more than 0.15).  The counts are reset
   just before each teacher-forced run and read just after: `ssd` 76
   times on the run's route (38 in its no-cache forward, 38 in its
   prefill; the fp32 run is the fp32 route's path), nothing else.
   Prefill and decode tokens/s and peak device memory.
11. llm-forward-long: the no-cache forward at (1, 8192), which takes
   flash attention (8192^2 > 4096^2): `flash_attention` 6 times (the
   shared block's invocations), `ssd` 38 times, each on its bf16
   route (`flash_attention_bf16`, `ssd_bf16`), every logit finite.
   Wall and peak device memory.
12. llm-kernels-vs-plain: `flash_attention` and `ssd` on the card against
   their plain versions on the card: the reference's kernel cases
   (tests/test_kernels.py) in fp32 and bf16, cases across the
   kernels' tile edges and their plain loads (`FA_CASES`, `SSD_CASES`;
   one case each in both dtypes with its first input at an offset of 2
   elements), and the inputs one layer really got on the path (captured
   during phases 10 and 11); each case records the route it took (the
   bf16 or the fp32 kernel) and fails on the other.  Tolerances: flash
   2e-6 (fp32) and 2e-2 (bf16), the reference's; SSD 1e-4 in fp32, the
   reference's, and in bf16 one bf16 ulp of y (1e-4 + 2^-7 |y|: both
   sides compute in fp32 and round y once) with the fp32 state at
   1e-4 + 1e-5 |state|.
13. llm-times: both kernels at their path shapes (CUDA events, after
   warm-up), in bf16 and then on the same inputs cast to fp32, each
   dtype on its own kernels, with the launch counts reset just before
   each dtype's run and read just after (the fp32 route's launches on
   its path).  Each row: ms, route and error (both checked), each
   route's time before its redesign (`earlier_ms`, quoted from PERF.md
   and not measured, so the kernels line leaves it out), the plain
   version, and the bound: the SSD scan's products counted at the bf16
   rate times the fewest bf16 passes that meet its tolerances
   (`SSD_PASSES`), on fp32 at the TF32 rate times the fewest split-TF32
   passes that meet the fp32 ones (`FA_PASSES_FP32`, `SSD_PASSES_FP32`),
   with the CUDA cores' fp32 rate beside it (`fp32_rate_bound_ms`).  For
   flash `F.scaled_dot_product_attention(is_causal=True)` on the same
   tensors is the library yardstick (off the path; the SSD scan has no
   single PyTorch call), with its error against the plain version: in
   bf16 it computes P V from bf16 P on tensor cores, and must meet the
   kernel's own bf16 tolerance, which is what lets the flash bound
   count all its products at the bf16 tensor-core rate.

14. race: `map_dfg(backend="race")` with the portfolio side on the card,
   on C5K5 bandmap (its (II, routing PEs) must be the golden pair) and
   on the forced loser of tests/test_exact_race.py (busmap, max_ii 2,
   certify off, seed 7: the exact side must win, and the cancelled
   portfolio may run at most one chunk of iterations past the cancel).
   Every "race-side" span must carry its ``ok`` (a side that raised
   lacks it: the race would have degraded around it).
15. comap: `co_map` on the card on the tier-1 cases of
   tests/test_comap.py and on `COMAP_PORTFOLIO_PAIR`; every ok merged
   binding must pass the port's validator, the 2x2 case must fail
   cleanly.
16. map-trace: `launch.serve.run_map_trace` (the ``--map-trace`` entry
   point) on the card, `SERVICE_TRACE` requests at 8x8 with
   `SERVICE_WORKERS` workers and a cold in-memory cache: no crash
   outcome, no serve-crash event, every ok result valid.  Requests/s,
   p50/p95/p99 latency, sources, hit rates, the slowest requests.
17. explain: traced and recorded maps (C4K8@8x8 busmap, C5K5 bandmap)
   with their span walls by name (`obs.export.to_json`) and
   `MappingResult.explain()`'s report.
Each of phases 14-17 resets the launch counts just before it and reads
them just after: `selection_counts` must have launched.

The last lines are the kernel table (JSON), the card as ``nvidia-smi``
reports it, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
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
# The LLM path: zamba2-1.2b served (4 slots, 8 requests of 1000 prompt
# tokens, 32 new ones) and its no-cache forward at 8192 tokens.
LLM_ARCH = "zamba2-1.2b"
SERVE_SLOTS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 1000, 32
LONG_SEQ = 8192
LOGIT_TOL = 0.15        # the reference's hybrid tolerance (test_models.py)
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
# takes the plain loads at four panels.
FA_CASES = [(2, 128, 128, 4, 2, 64, None, 0), (1, 256, 256, 4, 4, 32, None, 0),
            (2, 128, 384, 4, 1, 64, None, 256), (1, 256, 256, 8, 2, 64, 100, 0),
            (1, 64, 64, 2, 2, 128, 16, 0), (1, 1, 512, 4, 2, 64, None, 511),
            (2, 300, 333, 8, 2, 128, None, 0), (1, 200, 260, 8, 2, 48, 70, 60),
            (1, 129, 65, 4, 1, 128, None, 0),
            (1, 777, 900, 4, 1, 64, 300, 123), (1, 150, 170, 4, 2, 5, None, 0),
            (1, 200, 260, 8, 2, 44, 70, 60),
            (2, 300, 333, 8, 2, 192, None, 0), (1, 200, 260, 4, 1, 256, 70, 60),
            (1, 150, 170, 2, 1, 250, None, 0),
            (1, 65, 33, 2, 1, 192, None, 0)]
SSD_CASES = [(2, 64, 4, 16, 32, 16), (1, 128, 8, 32, 64, 32),
             (2, 128, 4, 64, 128, 64), (2, 1000, 4, 64, 64, 256),
             (1, 256, 4, 64, 64, 256), (2, 100, 4, 64, 64, 256),
             (1, 1000, 3, 96, 64, 256), (2, 700, 3, 40, 24, 128),
             (1, 300, 3, 20, 64, 128), (2, 300, 3, 64, 12, 128),
             (1, 200, 3, 18, 10, 64)]
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
                 for r in ("", "_bf16", "_fp32"))

def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after a warm-up."""
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


def device_profile(fn, calls: int | None = None) -> dict:
    """Run ``fn()`` under `torch.profiler` and return the device time it
    took (ms) with the kernels that took most of it.  Where the profiler
    records no device activity, the device time is None (not measured).
    With ``calls`` (``fn`` makes that many calls of one function), the
    device time is a call's: each kernel's mean time times its launches
    a call, so that the event a session can drop (the first, in some
    sessions of this script) does not count as a call's worth of nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
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
    return dict(device_ms=total if kernels else None,
                top=[dict(kernel=name[:80], ms=ms, count=count)
                     for name, ms, count in kernels[:6]])


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
    a copy of the first call's arguments: the inputs the path really
    gives the kernel.  The wrapped call still counts its own launch."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name = module, name
        self.args = self.kwargs = None

    def __enter__(self) -> "Capture":
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, *args, **kwargs):
        if self.args is None:
            self.args = tuple(a.clone() for a in args)
            self.kwargs = dict(kwargs)
        return self.orig(*args, **kwargs)

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.orig)


class StepClock:
    """Wall seconds (with a device sync at the end of each call) of every
    call to ``module.name`` while entered."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name = module, name
        self.seconds: list[float] = []

    def __enter__(self) -> "StepClock":
        import torch
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


def top2_margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


class compute_dtype:
    """While entered, the port's dense layers and embedding compute in
    ``dtype`` (their default is bf16, as in the reference)."""

    def __init__(self, dtype) -> None:
        self.dtype = dtype

    def __enter__(self) -> None:
        from repro_torch.models import layers
        self.saved = (layers.dense.__kwdefaults__["compute_dtype"],
                      layers.embed.__defaults__)
        layers.dense.__kwdefaults__["compute_dtype"] = self.dtype
        layers.embed.__defaults__ = (self.dtype,)

    def __exit__(self, *exc) -> None:
        from repro_torch.models import layers
        layers.dense.__kwdefaults__["compute_dtype"] = self.saved[0]
        layers.embed.__defaults__ = self.saved[1]


def teacher_forced(cfg, model, dev, wave, forced, s_max, cache_dtype):
    """Prefill ``wave`` into a cache of ``cache_dtype``, then decode the
    ``forced`` tokens one by one; each step's logits against the
    no-cache forward's at the same position.  Per step: the max abs
    error, its ratio to the reference's criterion (assert_allclose
    with atol = rtol = 0.15, tests/test_models.py:100-106), the number
    of rows whose no-cache top-2 margin exceeds twice the tolerance and
    how many of those pick another argmax."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    seq = torch.cat([wave, forced], dim=1)
    with torch.inference_mode():
        full, _, _ = T.forward(cfg, model, {"tokens": seq})
    out = dict(max_abs_err=[], tol_ratio=[], max_abs_logit=0.0,
               clear_rows=[], argmax_flips=[])

    def compare(got, want) -> None:
        diff = (got - want).abs()
        out["max_abs_err"].append(float(diff.max()))
        out["tol_ratio"].append(float(
            (diff / (LOGIT_TOL + LOGIT_TOL * want.abs())).max()))
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
    compare(logits[:, -1], full[:, wave.shape[1] - 1])
    for t in range(forced.shape[1] - 1):
        _, logits, cache = M.serve_step(
            cfg, model, {"tokens": forced[:, t:t + 1]}, cache)
        compare(logits[:, -1], full[:, wave.shape[1] + t])
    return out


def llm_serve(cfg, model, dev, extra: dict) -> tuple[dict, Capture]:
    """Phase 10: `WaveServer` over two waves, with the launch counts read
    around them; then teacher-forced prefill and decode against the
    no-cache forward.  Emits the phase's line (with ``extra``) before
    its checks."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.serve import WaveServer
    from repro_torch.models import model as M

    s_max = SERVE_PROMPT + SERVE_NEW + 8
    server = WaveServer(cfg, model, slots=SERVE_SLOTS, s_max=s_max)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT), dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Capture(ssd_ops, "ssd") as cap, \
            StepClock(M, "prefill_step") as pre, \
            StepClock(M, "serve_step") as dec:
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
    # no-cache forward and its prefill take `ssd` on the run's dtype.
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
               tolerance=dict(atol=LOGIT_TOL, rtol=LOGIT_TOL),
               sample=tokens[0, :8].tolist())
    emit(dict(phase="llm-serve", **extra, **row))
    check(((tokens >= 0) & (tokens < cfg.vocab)).all(), "token out of range")
    for name in ("ssd", "ssd_bf16"):
        check(launches[name] == 2 * cfg.n_layers,
              f"{name} launched {launches[name]} times, expected "
              f"{2 * cfg.n_layers} (38 per prefill wave, bf16)")
    check(launches["flash_attention"] == 0,
          f"flash_attention launched {launches['flash_attention']} times "
          f"in serving; the cached prefill takes sdpa")
    for name, counts in tf_launches.items():
        want = {k: 0 for k in LLM_KEYS}
        want.update({"ssd": 2 * cfg.n_layers,
                     f"ssd_{name}": 2 * cfg.n_layers})
        check(counts == want,
              f"the {name} teacher-forced run launched {counts}, expected "
              f"{want} (38 ssd in its forward, 38 in its prefill)")
    check(torch.equal(first_token,
                      torch.from_numpy(tokens[:SERVE_SLOTS, 0]).long()),
          "a replayed prefill disagrees with the served first token")
    fp32, bf16 = tf["fp32"], tf["bf16"]
    check(max(fp32["tol_ratio"]) <= 1.0,
          f"fp32 teacher-forced logits differ from the no-cache forward by "
          f"{max(fp32['max_abs_err']):.4f} (atol = rtol = {LOGIT_TOL})")
    check(bf16["tol_ratio"][0] <= 1.0,
          f"bf16 prefill logits differ from the no-cache forward by "
          f"{bf16['max_abs_err'][0]:.4f} (atol = rtol = {LOGIT_TOL})")
    check(sum(bf16["argmax_flips"]) == 0,
          f"bf16 teacher-forced decode picks another token than the "
          f"no-cache forward at {sum(bf16['argmax_flips'])} of "
          f"{sum(bf16['clear_rows'])} rows whose top-2 margin exceeds "
          f"{2 * LOGIT_TOL}")
    return row, cap


def llm_forward_long(cfg, model, dev, extra: dict):
    """Phase 11: the no-cache forward at (1, LONG_SEQ) with the launch
    counts read around it.  Emits the phase's line (with ``extra``)
    before its checks."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LONG_SEQ), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Capture(fa_ops, "flash_attention") as fa_cap, \
            Capture(ssd_ops, "ssd") as ssd_cap, torch.inference_mode():
        reset_launches()
        t0 = time.perf_counter()
        logits, _, _ = T.forward(cfg, model, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in LLM_KEYS}
    finite = bool(torch.isfinite(logits).all())
    row = dict(arch=cfg.name, seq=LONG_SEQ, launches=launches, wall_s=wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               logits_shape=list(logits.shape), finite=finite)
    del logits
    emit(dict(phase="llm-forward-long", **extra, **row))
    n_inv = T.n_hybrid_attn_invocations(cfg)
    for name in ("flash_attention", "flash_attention_bf16"):
        check(launches[name] == n_inv,
              f"{name} launched {launches[name]} times, expected {n_inv}")
    for name in ("ssd", "ssd_bf16"):
        check(launches[name] == cfg.n_layers,
              f"{name} launched {launches[name]} times, expected "
              f"{cfg.n_layers}")
    check(finite, "the long forward gave a non-finite logit")
    return row, fa_cap, ssd_cap


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
    """Phase 12: both kernels against their plain versions on the card."""
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
    q, k, v = captured["flash_long"].args
    kw = captured["flash_long"].kwargs
    err, route = _flash_err(q, k, v, kw.get("q_offset", 0), kw.get("window"))
    path["flash_attention"] = dict(shape=list(q.shape), dtype=str(q.dtype),
                                   route=route, max_abs_err=err)
    check(err <= FA_TOL["bfloat16"],
          "flash_attention at the path's inputs exceeds 2e-2")
    check(route == "bf16", "the path's flash input took the fp32 route")
    for label in ("ssd_long", "ssd_serve"):
        cap = captured[label]
        dy, df, ok, route = _ssd_err(cap.args, cap.kwargs["chunk"])
        path[label] = dict(shape=list(cap.args[0].shape),
                           chunk=cap.kwargs["chunk"], route=route,
                           max_abs_err_y=dy, max_abs_err_state=df)
        check(ok, f"ssd at the path's inputs ({label}): |dy| {dy}, "
                  f"|dstate| {df}")
        check(route == "bf16",
              f"the path's ssd input ({label}) took the fp32 route")
    return dict(flash_attention=fa_cases, ssd=ssd_cases, path=path)


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


def flash_bound(b, sq, sk, hq, d, nbytes, fp32=False) -> dict:
    """The least time of causal attention: 4 d FLOP for each visible
    (query, key) pair.  On bf16 inputs at the bf16 tensor-core rate: Q K^T
    takes bf16 operands whose products are exact in fp32; P V may take P
    rounded to bf16, since the library call that does so meets the
    kernel's own bf16 tolerance in this run (`llm_times` checks).  On fp32
    inputs (``fp32``) at the TF32 tensor-core rate, each product
    `FA_PASSES_FP32` times (the fewest split-TF32 passes that meet the
    fp32 tolerance); the CUDA cores' fp32 rate gives `fp32_rate_bound_ms`
    beside it.  The larger of that time and the bytes' binds."""
    pairs = sum(min(i + 1 + (sk - sq), sk) for i in range(sq))
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
                flop=flop, **extra, bytes=nbytes)


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


def llm_times(captured: dict) -> list:
    """Phase 13: both kernels at their path shapes, on the captured
    inputs as they are (bf16) and cast to fp32, each dtype on its own
    tensor-core kernels.  Each row: ms (CUDA events, after warm-up), the
    route taken and the error against the plain version, both checked,
    the plain version's ms, the bound at the dtype's rate (and on fp32
    the CUDA cores' fp32 rate beside it), the route's time before its
    redesign as quoted `earlier_ms`, and the route's launches in the
    dtype's run of this phase (the counts reset just before it), checked
    to equal the kernel calls the phase makes; for
    flash also `F.scaled_dot_product_attention(is_causal=True)` on the
    same tensors as the library yardstick, with its error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        bf16 = dtype == torch.bfloat16
        route_want = ROUTE_OF[name]
        reps = dict(kernel=10 if bf16 else 5, library=20 if bf16 else 10)
        first = len(rows)
        reset_launches()
        q, k, v = (t.to(dtype) for t in captured["flash_long"].args)
        b, sq, hq, d = q.shape
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True).transpose(1, 2)

        err, route = _flash_err(q, k, v, 0, None)
        check(route == route_want,
              f"{name} flash_attention took the {route} route")
        check(err <= FA_TOL[name], f"{name} flash_attention at "
                                   f"{tuple(q.shape)}: {err} > "
                                   f"{FA_TOL[name]}")
        lib_err = float((library().float() -
                         flash_attention_ref(q, k, v).float()).abs().max())
        if bf16:
            check(lib_err <= FA_TOL["bfloat16"],
                  f"scaled_dot_product_attention differs from the plain "
                  f"version by {lib_err} > {FA_TOL['bfloat16']}: the flash "
                  f"bound's bf16 rate for P V does not hold")
        rows.append(dict(
            kernel="flash_attention", shape=list(q.shape), dtype=name,
            route=route, calls=2 + reps["kernel"],
            ms=cuda_ms(lambda: flash_attention(q, k, v), reps["kernel"]),
            earlier_ms=EARLIER_MS[name]["flash_attention"],
            earlier_ms_from=EARLIER_FROM, max_abs_err=err,
            tolerance=FA_TOL[name],
            plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v), 2),
            library_ms=cuda_ms(library, reps["library"]),
            library="torch.nn.functional.scaled_dot_product_attention",
            library_max_abs_err=lib_err,
            **flash_bound(b, sq, k.shape[1], hq, d, nbytes, fp32=not bf16)))
        del q, k, v
        for label in ("ssd_long", "ssd_serve"):
            args = list(captured[label].args) if bf16 else \
                [t.float() for t in captured[label].args]
            chunk = captured[label].kwargs["chunk"]
            bsz, s, h, p = args[0].shape
            n = args[3].shape[-1]
            nbytes = sum(t.numel() * t.element_size() for t in args) + \
                args[0].numel() * args[0].element_size() + \
                4 * bsz * h * p * n
            dy, df, ok, route = _ssd_err(args, chunk)
            check(route == route_want,
                  f"{name} ssd ({label}) took the {route} route")
            check(ok, f"{name} ssd at {tuple(args[0].shape)} ({label}): "
                      f"|dy| {dy}, |dstate| {df}")
            rows.append(dict(
                kernel="ssd", label=label, shape=list(args[0].shape),
                chunk=chunk, n=n, dtype=name, route=route, calls=2 + 10,
                ms=cuda_ms(lambda: ssd(*args, chunk=chunk), 10),
                earlier_ms=EARLIER_MS[name][label],
                earlier_ms_from=EARLIER_FROM,
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


# ------------------------------------------------ the service tier
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
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries=sorted(libs),
              ptxas={name: [ln.strip() for ln in
                            _build.build_log(name).splitlines()
                            if "entry function" in ln
                            or "registers" in ln or "spill" in ln]
                     for name in sorted(libs)}))

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

    # ---- 10-13. the LLM path: zamba2-1.2b at its published widths
    from repro_torch.configs import get_config
    from repro_torch.models import model as llm
    cfg = get_config(LLM_ARCH)
    t0 = time.perf_counter()
    model = llm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve_row, ssd_serve = llm_serve(
        cfg, model, dev, dict(card=card, init_s=init_s, params=sum(
            p.numel() for p in model.parameters())))
    long_row, fa_long, ssd_long = llm_forward_long(cfg, model, dev,
                                                   dict(card=card))
    captured = {"flash_long": fa_long, "ssd_long": ssd_long,
                "ssd_serve": ssd_serve}
    del model
    llm_vs = llm_kernels_vs_plain(dev, captured)
    emit(dict(phase="llm-kernels-vs-plain",
              tolerances=dict(flash_attention=FA_TOL,
                              ssd=dict(atol=SSD_ATOL, rtol=SSD_RTOL)),
              **llm_vs))
    llm_rows = llm_times(captured)
    emit(dict(phase="llm-times", card=card, runs=llm_rows))
    fa_row, fa32_row = (next(
        r for r in llm_rows if r["kernel"] == "flash_attention"
        and r["dtype"] == dtype) for dtype in ("bfloat16", "float32"))
    ssd_row, ssd32_row = (next(
        r for r in llm_rows if r.get("label") == "ssd_long"
        and r["dtype"] == dtype) for dtype in ("bfloat16", "float32"))
    ssd_err = max(max(c["max_abs_err_y"] for c in llm_vs["ssd"]),
                  max(llm_vs["path"][k]["max_abs_err_y"]
                      for k in ("ssd_long", "ssd_serve")))
    fa_err = max(max(c["max_abs_err"] for c in llm_vs["flash_attention"]),
                 llm_vs["path"]["flash_attention"]["max_abs_err"])

    # ---- 14-17. the service tier: race, co-mapping, the serve tier
    # behind --map-trace, and traced maps with their explain reports
    service = {}
    for run in (service_race, service_comap, service_trace,
                service_explain):
        row = run(dev)
        service[row["phase"]] = row["launches"]
        emit(dict(row, card=card))

    # ---- the kernel table: the full-width shape of the main path
    row = next(t for t in times
               if t["graph"] == "C4K8@16x16:bandmap" and t["k"] == 1024)
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
             launches=long_row["launches"]["flash_attention_bf16"],
             max_abs_err=fa_err, ms=fa_row["ms"],
             plain_ms=fa_row["plain_ms"], bound_ms=fa_row["bound_ms"],
             bound_by=fa_row["bound_by"], library_ms=fa_row["library_ms"],
             shape=f"{tuple(fa_row['shape'])} bf16 causal "
                   f"(llm-forward-long)",
             fp32=dict({key: fa32_row[key] for key in (
                 "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                 "fp32_rate_bound_ms", "library_ms")},
                 launches=fa32_row["route_launches_in_phase"],
                 launches_from="llm-times")),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_tc.cu",
             source_fp32="src/repro_torch/kernels/ssd/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:80",
             launches=long_row["launches"]["ssd_bf16"],
             launches_serving=serve_row["launches"]["ssd_bf16"],
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
                 launches_serving=serve_row["teacher_forced_launches"][
                     "fp32"]["ssd_fp32"]))],
        "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
