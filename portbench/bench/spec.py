"""A cell's files, found by the names in `BENCHMARK.json`:

- the configuration: the ``file`` its ``configs`` entry names;
- the traffic mix: ``portbench/traffic/<traffic>.json``;
- the limits of its correctness check: ``portbench/checks/<workload>.json``;
- the runner of the traffic's ``kind``: ``portbench/kinds/<kind>.py``;
- the reader of each per-layer metric: ``portbench/metrics/<metric>.py``.

A new configuration, traffic mix, kind, metric or cell is new files and
new entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = "portbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple      # the metric entries this cell reports
    per_layer: tuple


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: a metric with ``workloads``
    in the cells it lists; a per-layer metric without them wherever the
    end-to-end metric it moves is reported; an end-to-end metric without
    them everywhere."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(root: str, workload: str) -> Cell:
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = tuple(m for m in bench["end_to_end"] if reports(m, workload, ()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if reports(m, workload, names))
    here = os.path.join(root, BENCH_DIR)
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config=read_json(os.path.join(root, conf["file"])),
                traffic=read_json(os.path.join(here, "traffic",
                                               w["traffic"] + ".json")),
                limits=read_json(os.path.join(here, "checks",
                                              workload + ".json")),
                end_to_end=e2e, per_layer=per_layer)


def load(root: str, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` of the checkout at
    ``root``, loaded by its path (names may hold dots and dashes)."""
    path = os.path.join(root, BENCH_DIR, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    key = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module
