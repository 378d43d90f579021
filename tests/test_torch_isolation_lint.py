"""The port stands alone: `src/repro_torch/` and `chip_smoke.py` import
neither JAX nor anything of the JAX package `repro`, and the repo's AST
linter holds the port to the same invariants as the reference."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import subprocess
import sys

import pytest

from repro.analysis.astlint import _KNOB_NAMES, _SERIAL_PINS, lint_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files() -> list[str]:
    out = []
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out.extend(os.path.join(root, n) for n in names
                   if n.endswith(".py"))
    return sorted(out)


FILES = _port_files() + [os.path.join(ROOT, "chip_smoke.py")]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, ROOT) for p in FILES])
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch, repro_torch.core.bandmap\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=[os.path.relpath(p, PORT)
                              for p in _port_files()])
def test_astlint_rules_hold_on_the_port(path):
    """Linted under the reference's own path (``repro_torch/`` read as
    ``repro/``), every path-scoped rule of the linter applies to the
    port's mirror module, with no edit to the linter."""
    rel = os.path.relpath(path, os.path.join(ROOT, "src"))
    rel = rel.replace(os.sep, "/").replace("repro_torch/", "repro/", 1)
    with open(path, encoding="utf-8") as fh:
        findings = lint_source(fh.read(), "src/" + rel)
    assert findings == [], [f.summary() for f in findings]


def test_legacy_knobs_mirror_the_linter():
    from repro_torch.core.options import LEGACY_KNOBS
    assert frozenset(LEGACY_KNOBS) == _KNOB_NAMES


def test_mapping_result_matches_the_serial_pin():
    from repro_torch.core.bandmap import MappingResult
    names = [f.name for f in dataclasses.fields(MappingResult)]
    fp = hashlib.sha256(",".join(names).encode()).hexdigest()[:16]
    assert MappingResult.SERIAL_VERSION == 3
    assert _SERIAL_PINS[MappingResult.SERIAL_VERSION] == fp
