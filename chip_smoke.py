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
2. kernel vs plain version: `selection_counts` on the card against its
   plain torch version, at the shapes the main path gives it, with
   random words, real engine selections, ragged K and all-ones words.
   Counts are integers: the tolerance is zero.
3. main path: `map_dfg` at the port's defaults (``engine="device"``,
   1024 trajectories, 20000 iterations, on the GPU) on the 14 golden
   (II, routing-PE) cases of the paper's kernels, and on C4K8 at the
   8x8 and 16x16 fabric sizes.  The kernel's launch count is reset
   just before and read just after; it must have launched.
4. the engine on the card vs on the CPU: 64 iterations of 64
   trajectories from the same inits must end in bit-identical state.
5. full width: 1024 trajectories for 48 iterations on the C4K8@8x8 and
   C4K8@16x16 conflict graphs; every best must be an independent set.
   Iterations/s and peak device memory, then 16 iterations under
   `torch.profiler` for the card's busy share of a lock-step.
6. times: the kernel per call (CUDA events, after warm-up), its bound,
   its plain version and the ``torch._int_mm`` yardstick.

The last lines are the kernel table (JSON), the card as ``nvidia-smi``
reports it, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory bytes/s, and 32-bit operations/s outside the tensor
# cores (the float32 rate: the table has no int32 rate, and no 32-bit
# lane operation issues faster, so the bound below is a floor).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
OPS_PER_WORD = 3          # AND + POPC + ADD per (k, v, word)


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


def device_profile(fn) -> dict:
    """Run ``fn()`` under `torch.profiler` and return the device time it
    took (ms) with the kernels that took most of it.  Where the profiler
    records no device activity, the device time is None (not measured)."""
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

    from repro_torch.core import CGRAConfig, DeviceSBTS, make_cnkm, map_dfg
    from repro_torch.core.bitset import pack_bool, pack_words
    from repro_torch.core.conflict import constructive_init
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.sbts_step import selection_counts
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
              ptxas=[ln.strip() for ln in
                     _build.build_log("sbts_step").splitlines()
                     if "registers" in ln or "spill" in ln]))

    # ---- the main path's graphs
    graphs = {}
    for name, (n, m, mode, side) in {
            "C5K5@4x4:bandmap": (5, 5, "bandmap", 4),
            "C4K8@8x8:busmap": (4, 8, "busmap", 8),
            "C4K8@16x16:bandmap": (4, 8, "bandmap", 16)}.items():
        cgra = CGRAConfig(rows=side, cols=side)
        sched, cg = conflict_graph(make_cnkm(n, m), cgra, mode)
        graphs[name] = (sched, cg, cgra)

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
        for k in (1, 37):
            sel = torch.randint(-2**31, 2**31 - 1, (k, w),
                                dtype=torch.int32, device=dev,
                                generator=gen)
            compare(f"{name} ragged K={k}", rows32, sel)
        ones_rows = torch.full_like(rows32, -1)
        ones_sel = torch.full((45, w), -1, dtype=torch.int32, device=dev)
        compare(f"{name} all-ones", ones_rows, ones_sel)
        check(bool((selection_counts(ones_rows, ones_sel) == 32 * w).all()),
              "all-ones words must count 32 per word")
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
    check(main_launches > 0,
          "the main path never launched selection_counts")

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
            independent=independent))
        check(independent, f"{name}: a best is not an independent set")
    emit(dict(phase="full-width", card=card, runs=widths))

    # ---- 6. times
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
            ops = OPS_PER_WORD * k * n_pad * w
            nbytes = 4 * (n_pad * w + k * w + k * n_pad)
            t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
            sel8 = sel_bits.to(torch.int8)
            lib = torch._int_mm(sel8, adj8)       # adjacency is symmetric
            check(torch.equal(lib, selection_counts(rows32, sel32)),
                  f"{name}: torch._int_mm yardstick disagrees")
            reps = 50 if k == 1024 else 200
            times.append(dict(
                graph=name, k=k, n_pad=n_pad, w=w,
                ms=cuda_ms(lambda: selection_counts(rows32, sel32), reps),
                plain_ms=cuda_ms(
                    lambda: selection_counts_plain(rows32, sel32), 5),
                library_ms=cuda_ms(lambda: torch._int_mm(sel8, adj8),
                                   reps),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes, launches_per_iter=3))
    emit(dict(phase="times", card=card, runs=times))

    # ---- the kernel table: the full-width shape of the main path
    row = next(t for t in times
               if t["graph"] == "C4K8@16x16:bandmap" and t["k"] == 1024)
    emit({"kernels": [dict(
        name="selection_counts", route="cuda",
        source="src/repro_torch/kernels/sbts_step/csrc/"
               "selection_counts.cu",
        replaces="src/repro/kernels/sbts_step/kernel.py:42",
        launches=main_launches, max_abs_err=max_err, ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=f"K={row['k']} n_pad={row['n_pad']} W={row['w']}")],
        "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
