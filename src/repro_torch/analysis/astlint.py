"""Repo-invariant AST linter over ``src/repro_torch/``: the port's copy
of the reference's ``repro/analysis/astlint.py``, its rules unchanged and
its path scopes naming the port's modules.

The engine's soundness regimes — validator-as-single-authority,
certificate-backed negative caching, cooperative cancellation, pinned
serialization, deterministic canonical paths — were written down in
docstrings and enforced only by tests.  This pass turns each into a
named, CI-gated rule over the parsed source (no imports, no execution),
so a violation fails the ``lint`` job the moment it is committed.

Rules (stable identifiers; each has a seeded-violation fixture in
tests/test_analysis_astlint.py, which tests/test_torch_astlint.py runs
through this copy under the port's paths):

``mapping-result-ok``
    `MappingResult(ok=True, ...)` (or ``dataclasses.replace(...,
    ok=True)``) may only be constructed in the validator-replayed
    engine paths: ``core/bandmap.py`` and ``exact/backend.py``, where
    every ``ok=True`` sits behind a ``report.ok`` check.  Anywhere
    else it would mint an unvalidated positive.

``cancel-poll``
    In the engine modules (``core/mis.py``, ``core/certify.py``,
    ``core/bandmap.py``, ``exact/backend.py``, ``exact/race.py``):
    a function taking a ``cancel`` parameter must reference it in its
    body (a dropped token makes the race's loser unkillable), and any
    ``while True:`` loop must reference ``cancel``/``is_set`` inside
    its body (unbounded loops must poll their CancelToken).

``serial-version-pin``
    `MappingResult`'s dataclass field list is fingerprinted; the
    (SERIAL_VERSION, fingerprint) pair must match the pinned table
    below.  Changing the field set without bumping the version would
    let the serve cache unpickle stale on-disk blobs into the new
    layout (`MappingResult.to_bytes` guards the version only).

``lock-guarded-state``
    A class declaring ``_lock_guarded = ("attr", ...)`` promises those
    ``self`` attributes are shared mutable state: outside ``__init__``
    they may only be assigned/augmented/mutated-in-place inside a
    ``with self.<...lock...>`` block.

``no-wallclock-canonical``
    Canonical-path modules (``serve/canon.py``, ``core/schedule.py``)
    must stay deterministic functions of their inputs: no
    ``time.time``/``perf_counter``-style wall-clock reads and no
    global-RNG calls (``random.*``, ``np.random.<fn>`` other than the
    seeded ``default_rng``).

``tracer-default-none``
    In the engine modules threaded with tracing (``core/mis.py``,
    ``core/certify.py``, ``core/bandmap.py``, ``core/conflict.py``,
    ``exact/backend.py``, ``exact/race.py``, ``comap/comap.py``):
    every function accepting a ``tracer`` parameter must default it to
    ``None`` (the NullTracer contract — untraced runs stay
    bit-identical and allocation-free), and no condition (``if`` /
    ``while`` / ternary / ``assert``) may reference ``tracer`` except
    the exact identity checks ``tracer is None`` / ``tracer is not
    None`` — the engine must never branch on trace *content*.

``recorder-default-none``
    The flight-recorder twin of ``tracer-default-none``, over the same
    engine modules: every function accepting a ``record`` parameter
    (`repro_torch.obs.FlightRecorder`) must default it to ``None`` and only
    reference it in conditions through the identity None-checks — a
    ``record=None`` run stays bit-identical (NullFlightRecorder
    contract), and the engine never branches on recorded events.

``options-single-source``
    In the engine modules behind the `MapOptions` facade
    (``core/bandmap.py``, ``exact/backend.py``, ``exact/race.py``,
    ``serve/scheduler.py``, ``comap/comap.py``): a mapping knob may
    only be read from a `MapOptions` instance, never pulled out of a
    loose dict — no ``d["mis_iters"]`` subscripts and no
    ``d.get/.pop/.setdefault("seed")`` calls whose key is a
    `core.options.LEGACY_KNOBS` name.  Membership tests (``"seed" in
    d``) stay legal (that is how the seed-pinning precedence is
    detected), and `MapOptions.from_kwargs`/`coerce` are the one
    adapter allowed to consume such dicts — they live in
    ``core/options.py``, outside the rule's scope.

Run ``python -m repro_torch.analysis.astlint [paths...]`` (default
``src/repro_torch``);
exit code 1 iff any finding.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import sys

# --------------------------------------------------------------- config
_OK_ALLOWED = ("repro_torch/core/bandmap.py",
               "repro_torch/exact/backend.py")
_CANCEL_MODULES = ("repro_torch/core/mis.py", "repro_torch/core/certify.py",
                   "repro_torch/core/bandmap.py",
                   "repro_torch/exact/backend.py",
                   "repro_torch/exact/race.py")
_CANONICAL_MODULES = ("repro_torch/serve/canon.py",
                      "repro_torch/core/schedule.py")
_TRACER_MODULES = ("repro_torch/core/mis.py", "repro_torch/core/certify.py",
                   "repro_torch/core/bandmap.py",
                   "repro_torch/core/conflict.py",
                   "repro_torch/exact/backend.py",
                   "repro_torch/exact/race.py",
                   "repro_torch/comap/comap.py")
_RESULT_MODULE = "repro_torch/core/bandmap.py"
_OPTIONS_MODULES = ("repro_torch/core/bandmap.py",
                    "repro_torch/exact/backend.py",
                    "repro_torch/exact/race.py",
                    "repro_torch/serve/scheduler.py",
                    "repro_torch/comap/comap.py")
# Mirror of core.options.LEGACY_KNOBS keys (astlint parses source, it
# never imports the linted package); tests/test_torch_astlint.py
# asserts the two sets stay equal.
_KNOB_NAMES = frozenset({
    "mode", "seed", "backend", "bus_pressure", "max_ii", "min_ii",
    "use_grf", "max_bus_fanout", "certify", "certify_budget",
    "n_exact_placements", "static_prepass", "hall",
    "exact_node_budget", "mis_restarts", "mis_iters", "engine",
    "device_seeds", "group_move", "row_cache_limit",
})
# SERIAL_VERSION -> sha256(",".join(field names))[:16].  Adding,
# removing or reordering MappingResult fields requires bumping the
# version in bandmap.py AND adding the new pair here — that is the
# point: the diff becomes impossible to make silently.
_SERIAL_PINS = {2: "be396c8aa0fcae06", 3: "9b6f3df493a0e85e"}

_WALLCLOCK_CALLS = {("time", "time"), ("time", "perf_counter"),
                    ("time", "monotonic"), ("time", "time_ns"),
                    ("time", "process_time"), ("datetime", "now"),
                    ("datetime", "utcnow")}
_GLOBAL_RNG_FUNCS = {"random", "randint", "randrange", "shuffle",
                     "choice", "sample", "uniform", "seed", "gauss",
                     "random_sample", "rand", "randn", "permutation",
                     "integers"}
_MUTATING_METHODS = {"append", "extend", "add", "update", "pop",
                     "popitem", "clear", "remove", "insert",
                     "setdefault", "discard", "__setitem__"}


@dataclasses.dataclass(frozen=True)
class AstFinding:
    path: str
    line: int
    rule: str
    message: str

    def summary(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node: ast.AST) -> list[str]:
    """`a.b.c` -> ["a", "b", "c"]; empty when not a plain name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _callee_name(call: ast.Call) -> str:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return ""


def _has_kw_true(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


# ----------------------------------------------------------------- rules
def _rule_mapping_result_ok(tree, rel, out):
    if rel.endswith(_OK_ALLOWED):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _callee_name(node)
        flagged = (name == "MappingResult"
                   and (_has_kw_true(node, "ok")
                        or (node.args
                            and isinstance(node.args[0], ast.Constant)
                            and node.args[0].value is True)))
        flagged = flagged or (name == "replace"
                              and _has_kw_true(node, "ok"))
        if flagged:
            out.append(AstFinding(
                rel, node.lineno, "mapping-result-ok",
                "MappingResult(ok=True) constructed outside the "
                "validator-replayed engine paths "
                f"({', '.join(_OK_ALLOWED)})"))


def _rule_cancel_poll(tree, rel, out):
    if not rel.endswith(_CANCEL_MODULES):
        return

    def references_cancel(body) -> bool:
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Name) and n.id == "cancel":
                    return True
                if isinstance(n, ast.Attribute) and \
                        n.attr in ("is_set", "cancel", "_cancel"):
                    return True
        return False

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            names = [a.arg for a in args.args + args.kwonlyargs]
            if "cancel" in names and not references_cancel(node.body):
                out.append(AstFinding(
                    rel, node.lineno, "cancel-poll",
                    f"function {node.name!r} takes a cancel token but "
                    f"never references it — the race's loser becomes "
                    f"unkillable through this path"))
        if isinstance(node, ast.While) and \
                isinstance(node.test, ast.Constant) and \
                node.test.value is True and \
                not references_cancel(node.body):
            out.append(AstFinding(
                rel, node.lineno, "cancel-poll",
                "unbounded `while True` loop in an engine module does "
                "not poll its CancelToken"))


def _rule_serial_version_pin(tree, rel, out):
    if not rel.endswith(_RESULT_MODULE):
        return
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name == "MappingResult"):
            continue
        fields = [s.target.id for s in node.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]
        version = None
        for s in node.body:
            if isinstance(s, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SERIAL_VERSION"
                    for t in s.targets):
                version = s.value.value \
                    if isinstance(s.value, ast.Constant) else None
        fp = hashlib.sha256(",".join(fields).encode()).hexdigest()[:16]
        if version not in _SERIAL_PINS:
            out.append(AstFinding(
                rel, node.lineno, "serial-version-pin",
                f"MappingResult.SERIAL_VERSION {version!r} has no "
                f"pinned field fingerprint in analysis/astlint.py"))
        elif _SERIAL_PINS[version] != fp:
            out.append(AstFinding(
                rel, node.lineno, "serial-version-pin",
                f"MappingResult field set changed (fingerprint {fp}, "
                f"pinned {_SERIAL_PINS[version]} for version "
                f"{version}): bump SERIAL_VERSION and re-pin"))


def _rule_lock_guarded_state(tree, rel, out):
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded: set[str] = set()
        for s in cls.body:
            if isinstance(s, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_lock_guarded"
                    for t in s.targets) and \
                    isinstance(s.value, (ast.Tuple, ast.List)):
                guarded = {e.value for e in s.value.elts
                           if isinstance(e, ast.Constant)}
        if not guarded:
            continue

        def self_attr(node) -> str | None:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                return node.attr
            return None

        def guarded_target(node) -> str | None:
            # self.attr, self.attr[...] — peel subscripts.
            while isinstance(node, ast.Subscript):
                node = node.value
            a = self_attr(node)
            return a if a in guarded else None

        class Visitor(ast.NodeVisitor):
            """Tracks `with self.*lock*` nesting; flags guarded-attr
            mutations at depth 0.  Nested function defs are skipped
            (their call sites are checked where they run)."""

            def __init__(self, fn_name: str) -> None:
                self.depth = 0
                self.fn_name = fn_name

            def visit_With(self, node: ast.With) -> None:
                locked = any(
                    "lock" in (self_attr(item.context_expr) or "")
                    for item in node.items)
                self.depth += locked
                self.generic_visit(node)
                self.depth -= locked

            def visit_FunctionDef(self, node) -> None:
                pass

            visit_AsyncFunctionDef = visit_FunctionDef
            visit_Lambda = visit_FunctionDef

            def _flag(self, line: int, attr: str) -> None:
                if self.depth == 0:
                    out.append(AstFinding(
                        rel, line, "lock-guarded-state",
                        f"self.{attr} (declared in _lock_guarded) "
                        f"mutated outside `with self.*lock*` in "
                        f"{self.fn_name!r}"))

            def visit_Assign(self, node: ast.Assign) -> None:
                for t in node.targets:
                    a = guarded_target(t)
                    if a:
                        self._flag(node.lineno, a)
                self.generic_visit(node)

            def visit_AugAssign(self, node: ast.AugAssign) -> None:
                a = guarded_target(node.target)
                if a:
                    self._flag(node.lineno, a)
                self.generic_visit(node)

            def visit_Call(self, node: ast.Call) -> None:
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in _MUTATING_METHODS:
                    a = guarded_target(f.value)
                    if a:
                        self._flag(node.lineno, a)
                self.generic_visit(node)

        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name != "__init__":
                v = Visitor(fn.name)
                for stmt in fn.body:
                    v.visit(stmt)


def _rule_no_wallclock_canonical(tree, rel, out):
    if not rel.endswith(_CANONICAL_MODULES):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        parts = _dotted(node.func)
        if len(parts) < 2:
            continue
        head, fn = parts[0], parts[-1]
        if head == "_time":          # the repo's habitual alias
            head = "time"
        if (head, fn) in _WALLCLOCK_CALLS:
            out.append(AstFinding(
                rel, node.lineno, "no-wallclock-canonical",
                f"wall-clock call {'.'.join(parts)} in a "
                f"canonical-path module"))
            continue
        if head == "random" and fn in _GLOBAL_RNG_FUNCS:
            out.append(AstFinding(
                rel, node.lineno, "no-wallclock-canonical",
                f"global-RNG call {'.'.join(parts)} in a "
                f"canonical-path module"))
            continue
        if len(parts) >= 3 and parts[-2] == "random" and \
                fn != "default_rng":
            out.append(AstFinding(
                rel, node.lineno, "no-wallclock-canonical",
                f"global numpy RNG call {'.'.join(parts)} in a "
                f"canonical-path module (seed a default_rng instead)"))


def _check_handle_default_none(tree, rel, out, *, param: str,
                               rule: str, null_name: str,
                               noun: str) -> None:
    """Shared body of the ``tracer-default-none`` /
    ``recorder-default-none`` twins: the ``param`` parameter must
    default to None, and conditions may only reference it through the
    exact identity checks ``param is None`` / ``param is not None``."""

    def is_identity_none_check(test: ast.AST) -> bool:
        return (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == param
                and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Is, ast.IsNot))
                and len(test.comparators) == 1
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None)

    def mentions_param(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Name) and n.id == param
                   for n in ast.walk(node))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            pos = args.args + args.posonlyargs
            n_required = len(pos) - len(args.defaults)
            pairs = list(zip(pos[n_required:], args.defaults)) + [
                (a, d) for a, d in zip(args.kwonlyargs,
                                       args.kw_defaults)]
            for a in pos[:n_required]:
                if a.arg == param:
                    out.append(AstFinding(
                        rel, node.lineno, rule,
                        f"function {node.name!r} takes `{param}` "
                        f"without a default — engine entry points "
                        f"must default it to None ({null_name} "
                        f"contract)"))
            for a, d in pairs:
                if a.arg == param and not (
                        isinstance(d, ast.Constant)
                        and d.value is None):
                    out.append(AstFinding(
                        rel, node.lineno, rule,
                        f"function {node.name!r} defaults `{param}` to "
                        f"something other than None — un{noun}d runs "
                        f"must stay bit-identical"))
        tests: list[ast.AST] = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp,
                             ast.Assert)):
            tests.append(node.test)
        for test in tests:
            if mentions_param(test) and \
                    not is_identity_none_check(test):
                out.append(AstFinding(
                    rel, node.lineno, rule,
                    f"condition references `{param}` beyond the "
                    f"identity None-check — the engine must not "
                    f"branch on {noun} content"))


def _rule_tracer_default_none(tree, rel, out):
    if not rel.endswith(_TRACER_MODULES):
        return
    _check_handle_default_none(tree, rel, out, param="tracer",
                               rule="tracer-default-none",
                               null_name="NullTracer", noun="trace")


def _rule_recorder_default_none(tree, rel, out):
    if not rel.endswith(_TRACER_MODULES):
        return
    _check_handle_default_none(tree, rel, out, param="record",
                               rule="recorder-default-none",
                               null_name="NullFlightRecorder",
                               noun="record")


def _rule_options_single_source(tree, rel, out):
    if not rel.endswith(_OPTIONS_MODULES):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.slice, ast.Constant) and \
                node.slice.value in _KNOB_NAMES:
            out.append(AstFinding(
                rel, node.lineno, "options-single-source",
                f"mapping knob {node.slice.value!r} read from a dict "
                f"subscript — engine modules read knobs from a "
                f"MapOptions instance only"))
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "pop", "setdefault") and \
                node.args and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value in _KNOB_NAMES:
            out.append(AstFinding(
                rel, node.lineno, "options-single-source",
                f"mapping knob {node.args[0].value!r} read via "
                f".{node.func.attr}() — engine modules read knobs "
                f"from a MapOptions instance only"))


_RULES = (_rule_mapping_result_ok, _rule_cancel_poll,
          _rule_serial_version_pin, _rule_lock_guarded_state,
          _rule_no_wallclock_canonical, _rule_tracer_default_none,
          _rule_recorder_default_none, _rule_options_single_source)

RULE_NAMES = ("mapping-result-ok", "cancel-poll", "serial-version-pin",
              "lock-guarded-state", "no-wallclock-canonical",
              "tracer-default-none", "recorder-default-none",
              "options-single-source")


# ------------------------------------------------------------------ api
def lint_source(src: str, rel_path: str) -> list[AstFinding]:
    """Lint one module's source.  ``rel_path`` must be a posix-style
    path whose suffix identifies the module
    (".../repro_torch/core/mis.py");
    fixture tests feed synthetic paths to aim rules at snippets."""
    try:
        tree = ast.parse(src)
    except SyntaxError as exc:
        return [AstFinding(rel_path, exc.lineno or 0, "syntax-error",
                           str(exc.msg))]
    out: list[AstFinding] = []
    for rule in _RULES:
        rule(tree, rel_path, out)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_paths(paths: list[str]) -> tuple[list[AstFinding], int]:
    """Lint every ``*.py`` under ``paths``; returns (findings, n_files)."""
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = [d for d in dirs
                       if not d.startswith(".")
                       and d != "__pycache__"]
            files.extend(os.path.join(root, n) for n in names
                         if n.endswith(".py"))
    findings: list[AstFinding] = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(),
                                        f.replace(os.sep, "/")))
    return findings, len(files)


def main(argv: list[str] | None = None) -> int:
    paths = (argv if argv is not None else sys.argv[1:]) or [
        "src/repro_torch"]
    findings, n_files = lint_paths(paths)
    for f in findings:
        print(f.summary())
    status = "clean" if not findings else f"{len(findings)} finding(s)"
    print(f"astlint: {n_files} files, {len(RULE_NAMES)} rules, {status}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
