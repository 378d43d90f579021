"""The readings that a cell's correctness limits are set from, on the
card, in one process: for each seed the program's gaps from the float32
reference over the checked steps (`kinds/train.py`), and on the seeds
given for them the control's (the reference in float8 in the program's
place) and each planted fault's (`FAULTS`).  One JSON line a reading,
also written to ``--out``.

    python3 portbench/calibrate.py --workload starcoder2-train-8k \\
        --seeds 11,12,13 --control-seeds 11,12,13 --fault-seeds 11,12,13 \\
        --out chiprun_out/calibrate.jsonl
"""

import argparse
import json
import os
import sys
import time

import run

#: The faults read on the fault seeds: half of each batch left out of
#: the loss; a backward kernel's gradient of one input scaled.  (A step
#: that returns its state unchanged reads 1 by `change_gap` and needs no
#: run.)
FAULTS = ("half_batch", "bwd_scaled")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not run.prepare():
        return 2
    import torch

    from portbench.bench import spec
    from portbench.reference import compare
    cell = spec.cell(run.ROOT, args.workload)
    kind = spec.load(run.ROOT, "kinds", cell.traffic["kind"])
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    wanted = {}
    with open(args.out, "a") as out:
        def emit(**row):
            line = json.dumps(dict(row, workload=args.workload))
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        def worst(got, want, top=4):
            """The leaves of the largest gradient and change gaps, each
            with its gap and its reference norm."""
            out = {}
            for key in ("grad_norms", "change_norms"):
                gaps = compare.leaf_gaps(got[key], want[key], want[key])
                out[key] = [(k, gaps[k], want[key][k]) for k in sorted(
                    gaps, key=gaps.get, reverse=True)[:top]]
            return out

        def ref(seed):
            if seed not in wanted:
                wanted[seed] = kind.reference(cell, seed, "cuda")
            return wanted[seed]

        runs = [("program", None, seeds(args.seeds))] + [
            (fault, fault, seeds(args.fault_seeds)) for fault in FAULTS]
        for what, fault, chosen in runs:
            for seed in chosen:
                t = time.perf_counter()
                program = kind.Program(cell, seed, "cuda", fault)
                got = program.checked_steps()
                program.close()
                del program
                emit(what=what, seed=seed, gaps=compare.gaps(got, ref(seed)),
                     worst=worst(got, ref(seed)), losses=got["losses"],
                     ref_losses=ref(seed)["losses"],
                     seconds=time.perf_counter() - t)
        for seed in seeds(args.control_seeds):
            t = time.perf_counter()
            got = kind.reference(cell, seed, "cuda", precision="float8")
            emit(what="control", seed=seed, gaps=compare.gaps(got, ref(seed)),
                 worst=worst(got, ref(seed)), losses=got["losses"],
                 seconds=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
