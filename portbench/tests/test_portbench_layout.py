"""BENCHMARK.json against the benchmark's contract, the harness finding
new cells, metrics and kinds by name in files added to a copy, and no
module of the benchmark importing JAX or the JAX package."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from portbench.bench import harness, spec
from portbench.tests import smoke

REPO = smoke.REPO
BENCH = os.path.join(REPO, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/")
        cfg = spec.read_json(os.path.join(REPO, c["file"]))
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(k in cfg.get("cut", {}) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and TEXT.match(w["why"])
        assert w["chips"] == 1
        cell = spec.cell(REPO, w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert os.path.isfile(os.path.join(
            BENCH, "kinds", cell.traffic["kind"] + ".py"))
        assert set(cell.limits["limits"]) <= {
            "loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
            "grad_gap_matrices", "change_gap"}
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])


def _digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name_with_no_file_edited(tmp_path):
    """A configuration, traffic mix, limits, kind and metric added to a
    copy as new files (with new entries in BENCHMARK.json) are found by
    their names; every file the copy had before is as it was."""
    root = smoke.make_root(str(tmp_path))
    before = _digests(os.path.join(root, "portbench"))
    with open(os.path.join(root, "portbench", "kinds", "echo.py"), "w") as f:
        f.write("def run(cell, seed, seconds, traced, **kw):\n"
                "    return {'seed': seed}\n")
    with open(os.path.join(root, "portbench", "metrics", "answer.py"),
              "w") as f:
        f.write("def read(record):\n    return 42.0\n")
    with open(os.path.join(root, "portbench", "traffic", "echo-mix.json"),
              "w") as f:
        json.dump({"kind": "echo"}, f)
    with open(os.path.join(root, "portbench", "checks", "echo-cell.json"),
              "w") as f:
        json.dump({"limits": {}}, f)
    bench = spec.read_json(os.path.join(root, "BENCHMARK.json"))
    bench["workloads"].append({"name": "echo-cell", "config": "mamba2-smoke",
                               "traffic": "echo-mix", "chips": 1,
                               "why": "new"})
    bench["per_layer"].append({"name": "answer", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["echo-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.cell(root, "echo-cell")
    assert cell.config["name"] == "mamba2-smoke"
    assert "answer" in [m["name"] for m in cell.per_layer]
    assert spec.load(root, "kinds", cell.traffic["kind"]).run(
        cell, 7, 1, False) == {"seed": 7}
    assert spec.load(root, "metrics", "answer").read({}) == 42.0
    assert "answer" not in [m["name"] for m in
                            spec.cell(root, "mamba2-smoke-cell").per_layer]
    after = _digests(os.path.join(root, "portbench"))
    assert {k: after[k] for k in before} == before


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def _sources(folder: str):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.BANNED), path
    for path in _sources(os.path.join(BENCH, "reference")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops, path


def test_a_run_loads_no_jax_module(tmp_path):
    """Every module a run imports, the port's with them, in a fresh
    process: no top-level jax, jaxlib, flax or repro (whole names)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {BENCH!r})\n"
        "import run\n"
        "assert run.prepare()\n"
        "from portbench.bench import harness, spec\n"
        "import repro_torch.launch.train, repro_torch.models.model\n"
        "import repro_torch.kernels, torch.profiler\n"
        "root = run.ROOT\n"
        "for w in spec.read_json(root + '/BENCHMARK.json')['workloads']:\n"
        "    cell = spec.cell(root, w['name'])\n"
        "    spec.load(root, 'kinds', cell.traffic['kind'])\n"
        "    for m in cell.per_layer:\n"
        "        spec.load(root, 'metrics', m['name'])\n"
        "print(harness.banned(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("module", ["jax", "repro", "jaxlib.xla", "flax"])
def test_banned_names_compare_whole(module):
    names = ["torch", "repro_torch", "repro_torch.models", "jax_like",
             "reprox", module]
    assert harness.banned(names) == [module.split(".")[0]]


def test_a_checkout_without_the_port_exits_without_a_result(tmp_path):
    """With only BENCHMARK.json and portbench/, run.py prints no result
    and exits with another code than 0."""
    import shutil
    shutil.copytree(BENCH, str(tmp_path / "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "portbench" / "run.py"),
         "--workload", "starcoder2-train-8k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
