"""A checkout of the benchmark with two cells at the port's smoke widths,
for the CPU tests: a copy of ``BENCHMARK.json`` and ``portbench/`` under
a temporary root, with a configuration, a traffic mix, limits and a
workload added for the starcoder2 and the mamba2 smoke configurations,
as a later change adds them (new files and new entries only)."""

from __future__ import annotations

import json
import os
import shutil

import repro_torch.configs as registry

#: Readings on the CPU, seeds 1-8, the program's largest against the
#: least of the float8 control's and of the faults': starcoder2 smoke
#: loss 0.00038 (half batch 0.0030), grad_gap_median 0.0012 (control
#: 0.0049), grad_gap_matrices 0.0049 (control 0.015, bwd_scaled 0.40),
#: change_gap 0.11 (an unchanged state 1.0); mamba2 smoke loss 0.00037
#: (control 0.0011), grad_gap_median 0.0012 (control 0.0046),
#: grad_gap_matrices 0.0077 (control 0.018, bwd_scaled 0.22), change_gap
#: 0.014 (half batch 0.042).
LIMITS_STARCODER2 = {"loss_gap": 0.0015, "grad_gap_median": 0.0025,
                     "grad_gap_matrices": 0.01, "change_gap": 0.3}
LIMITS_MAMBA2 = {"loss_gap": 6e-4, "grad_gap_median": 0.0025,
                 "grad_gap_matrices": 0.012, "change_gap": 0.03}

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

#: name -> (registered arch, options, batch, sequence length, limits).
#: The starcoder2 smoke cell takes the published options its cell takes
#: (a window, here 24 of 64 positions; the tied unembedding; RoPE's
#: theta).  The limits sit between the program's largest gaps and the
#: least of the float8 control's and the faults' at these widths on the
#: CPU (readings above).
CELLS = {
    "starcoder2-smoke": ("starcoder2-7b",
                         {"sliding_window": 24, "tie_embeddings": True,
                          "rope_theta": 1e6}, 1, 64,
                         LIMITS_STARCODER2),
    "mamba2-smoke": ("mamba2-2.7b", {}, 2, 32, LIMITS_MAMBA2),
}


def smoke_config(arch: str, name: str, options: dict | None = None) -> dict:
    import dataclasses

    from portbench.kinds.train import PROGRAM_FIELDS
    options = options or {}
    cfg = dataclasses.replace(registry.get_smoke_config(arch), **options)
    out = {k: getattr(cfg, k) for k in PROGRAM_FIELDS}
    out.update(name=name, registry=arch, conv_width=4,
               norm_eps=1e-5 if cfg.norm == "layernorm" else 1e-6,
               act_bytes=2, cut={}, options=options, reduced=[])
    return out


def make_root(tmp: str) -> str:
    """A checkout at ``tmp`` with the smoke cells ``<name>-cell``."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    here = os.path.join(root, "portbench")
    with open(os.path.join(here, "traffic", "train-2x2048.json")) as f:
        traffic = json.load(f)
    for name, (arch, options, batch, seq, limits) in CELLS.items():
        _write(os.path.join(here, "configs", name + ".json"),
               smoke_config(arch, name, options))
        _write(os.path.join(here, "traffic", name + ".json"),
               dict(traffic, batch=batch, seq_len=seq))
        _write(os.path.join(here, "checks", name + "-cell.json"),
               {"limits": limits})
        bench["configs"].append({"name": name, "source": "smoke",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "smoke"})
        bench["workloads"].append({"name": name + "-cell", "config": name,
                                   "traffic": name, "chips": 1,
                                   "why": "smoke"})
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def use_smoke_widths(monkeypatch) -> None:
    """Point the port's registry at its smoke configurations."""
    monkeypatch.setattr(registry, "get_config", registry.get_smoke_config)
