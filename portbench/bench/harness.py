"""One run of one cell: the card's look, the kind's runner, the metrics
the run reports, and its result line.

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read from the traced steps'
record by ``portbench/metrics/<name>.py``, with ``busy_s``, ``window_s``
and the ``breakdown`` of the traced steps.  A reader that finds nothing
returns None and the metric is left out of the line; on the card, a
run that leaves out a metric the cell lists fails (`unread`) instead.  The
numbers the correctness check compares go last on standard error and
last in the line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from . import spec, trace

#: Top-level module names that no run may hold once its window has
#: closed: JAX and the JAX package (compared whole: ``repro_torch`` is
#: not ``repro``).
BANNED = ("jax", "jaxlib", "flax", "repro")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card() -> dict:
    """The card's name and power limit (`nvidia-smi`), for the record."""
    import torch
    info = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.splitlines()
        info["power_limit_w"] = float(out[0].split(",")[1])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return info


def banned(modules) -> list[str]:
    """The `BANNED` top-level names among the module names given."""
    return sorted({k.split(".")[0] for k in list(modules)} & set(BANNED))


def result(root: str, cell, out: dict, traced: bool, device: dict) -> dict:
    """The result line of a run's output ``out`` (the runner's)."""
    metrics = {}
    if traced:
        record = out["record"]
        for m in cell.per_layer:
            value = spec.load(root, "metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=trace.busy_seconds(record),
                      window_s=trace.window_seconds(record))
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(device, memory_peak_bytes=out["memory_peak_bytes"])}
    if traced:
        line["breakdown"] = {
            "device_ops": trace.top_device_ops(record, record["steps"]),
            "idle_gaps": trace.idle_gaps(record)}
    line["checks"] = out["checks"]
    return line


def unread(cell, line: dict) -> list[str]:
    """The per-layer metrics the cell lists that a traced line lacks: a
    kernel or a launch counter renamed, or a path no longer taken."""
    return [m["name"] for m in cell.per_layer
            if m["name"] not in line["metrics"]]


def run_cell(root: str, args, *, device: str, info: dict, t0: float):
    """The cell's run on ``device`` past the card's look; its line."""
    cell = spec.cell(root, args.workload)
    runner = spec.load(root, "kinds", cell.traffic["kind"])
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     device=device, t0=t0)
    return result(root, cell, out, bool(args.trace),
                  dict(info, count=cell.chips))


def main(root: str, argv, *, t0: float) -> int:
    args = parse(argv)
    cell = spec.cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    info = dict(card(), platform="gpu")
    print(f"portbench: card {info['kind']}, power.limit "
          f"{info['power_limit_w']} W", file=sys.stderr)
    line = run_cell(root, args, device="cuda", info=info, t0=t0)
    missing = unread(cell, line) if args.trace else []
    if missing:
        print(f"portbench: no reading for {missing}", file=sys.stderr)
        return 5
    found = banned(sys.modules)
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    for name, m in line["metrics"].items():
        print(f"portbench: {name} {m['value']!r} {m['unit']}",
              file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
