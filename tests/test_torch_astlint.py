"""The port's own AST linter (`repro_torch.analysis.astlint`), a copy of
the reference's with its path scopes naming ``repro_torch/`` modules:
on the reference linter's own fixtures, with ``src/repro/`` paths
renamed ``src/repro_torch/``, it gives the findings the reference's gives
on the original paths, and it finds the port's tree clean."""

from __future__ import annotations

import os

import pytest

from repro.analysis import astlint as ref_lint
from repro_torch.analysis import astlint as lint
from test_analysis_astlint import CLEAN, VIOLATIONS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXTURES = [(name, src, rel) for name, _, src, rel in VIOLATIONS] + CLEAN


def _port_path(rel: str) -> str:
    return rel.replace("src/repro/", "src/repro_torch/", 1)


def _summary(findings) -> list[tuple]:
    return [(f.line, f.rule, f.message.replace("repro_torch/", "repro/"))
            for f in findings]


@pytest.mark.parametrize("name,src,rel", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_port_linter_gives_the_reference_findings(name, src, rel):
    want = ref_lint.lint_source(src, rel)
    got = lint.lint_source(src, _port_path(rel))
    assert _summary(got) == _summary(want)
    assert all(f.path == _port_path(rel) for f in got)


@pytest.mark.parametrize("name,src,rel", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_reference_paths_are_out_of_the_port_linters_scopes(name, src,
                                                             rel):
    """A path-scoped rule of the copy names ``repro_torch/`` modules: a
    snippet under the reference's own path is held only to the rules
    that apply everywhere, as it would be outside the engine modules."""
    outside = rel.replace("src/repro/", "src/other/", 1)
    assert _summary(lint.lint_source(src, rel)) == _summary(
        ref_lint.lint_source(src, outside))


def test_rules_and_pins_mirror_the_reference():
    from repro_torch.core.options import LEGACY_KNOBS
    assert lint.RULE_NAMES == ref_lint.RULE_NAMES
    assert lint._KNOB_NAMES == ref_lint._KNOB_NAMES == frozenset(
        LEGACY_KNOBS)
    assert lint._SERIAL_PINS == ref_lint._SERIAL_PINS
    for name in ("_OK_ALLOWED", "_CANCEL_MODULES", "_CANONICAL_MODULES",
                 "_TRACER_MODULES", "_OPTIONS_MODULES"):
        assert getattr(lint, name) == tuple(
            p.replace("repro/", "repro_torch/", 1)
            for p in getattr(ref_lint, name))
    assert lint._RESULT_MODULE == "repro_torch/core/bandmap.py"


def test_the_port_lints_clean(capsys):
    """``python -m repro_torch.analysis.astlint src/repro_torch`` exits
    0."""
    findings, n_files = lint.lint_paths([os.path.join(ROOT, "src",
                                                      "repro_torch")])
    assert n_files > 80
    assert findings == [], [f.summary() for f in findings]
    assert lint.main([os.path.join(ROOT, "src", "repro_torch")]) == 0
    assert "clean" in capsys.readouterr().out


def test_main_exit_codes(tmp_path, capsys):
    rogue = tmp_path / "repro_torch" / "serve" / "rogue.py"
    rogue.parent.mkdir(parents=True)
    rogue.write_text("def f():\n    return MappingResult(ok=True)\n")
    assert lint.main([str(tmp_path)]) == 1
    assert "mapping-result-ok" in capsys.readouterr().out
    allowed = tmp_path / "repro_torch" / "core" / "bandmap.py"
    allowed.parent.mkdir(parents=True)
    allowed.write_text("def f(report):\n    if report.ok:\n"
                       "        return MappingResult(ok=True)\n")
    rogue.unlink()
    assert lint.main([str(tmp_path)]) == 0
