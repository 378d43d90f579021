"""The dry run's pieces against the reference's, at full width and on the
``meta`` device (nothing is allocated):

- the port's parameter specs (stacked per layer through `convert`'s
  names), AdamW state specs, `input_specs` and `cache_specs` equal the
  reference's shapes and types, leaf for leaf, for every (arch × shape)
  cell `applicable` admits; a Python-int cache position stands for the
  reference's int32 array of the same shape;
- on both meshes and under both plans, every parameter, state, cache and
  batch leaf gets the reference's spec from the planner's rules (a
  per-layer parameter: the stacked spec without its first entry);
- `active_params` and `model_flops` equal the reference's;
- the four model-path kernel wrappers' meta branches give the plain
  versions' shapes and types, forward and backward, and each kernel's
  FLOP formula equals torch's FlopCounterMode count of its plain
  version;
- the CLI traces two cells on the CPU without touching ``torch.cuda``.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` for 512 host
devices when imported, so its functions are reached in one subprocess
(`ref_dryrun`).  The op-level FLOP count is held to the reference's HLO
count in ``tests/test_torch_op_analysis.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import input_specs as ref_input_specs  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.launch import sharding as ref_sh  # noqa: E402
from repro.launch.mesh import PRODUCTION_MESH_AXES as REF_AXES  # noqa: E402
from repro.launch.mesh import mesh_stub as ref_mesh_stub  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, applicable,  # noqa: E402
                                 get_config, input_specs)
from repro_torch.core import planner  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.kernels.ragged_dot import ops as rd_ops  # noqa: E402
from repro_torch.kernels.ragged_dot.ref import ragged_dot_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import (PRODUCTION_MESH_AXES,  # noqa: E402
                                     make_production_mesh, mesh_stub)
from repro_torch.models import model as M  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(arch, shape) for arch in ARCHS for shape in SHAPES
         if applicable(arch, shape)[0]]
MESHES = ("single", "multi")
PLANS = ("baseline", "optimized")


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _ref_leaves(tree) -> dict:
    """Path string -> (shape, dtype) of a reference ShapeDtypeStruct
    tree."""
    return {ref_sh.path_str(kp): (tuple(leaf.shape), _dtype(leaf.dtype))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {p: (shape, _dtype(dt))
            for p, shape, dt in sh.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def ref_param_specs(arch: str):
    return RM.param_specs(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_param_specs(arch: str) -> dict:
    return M.param_specs(get_config(arch))


@functools.lru_cache(maxsize=None)
def ref_opt_specs(arch: str):
    return jax.eval_shape(RefAdamW().init, ref_param_specs(arch))


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference dry run's `active_params`, `model_flops` and its
    cache and batch axes of every cell, from one subprocess (importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices)."""
    code = """
import json
from repro.launch import dryrun as D
import jax
from repro.configs import ARCHS, SHAPES, applicable, get_config, input_specs
out = {"active_params": {}, "model_flops": {}, "axes": {}}
for arch in ARCHS:
    cfg = get_config(arch)
    out["active_params"][arch] = D.active_params(cfg)
    out["model_flops"][arch] = {
        k: [D.model_flops(cfg, k, t) for t in (1, 4096, 8388608)]
        for k in ("train", "prefill", "decode")}
    for shape, cell in SHAPES.items():
        if not applicable(arch, shape)[0]:
            continue
        specs = input_specs(cfg, cell)
        axes = {}
        for part, fn in (("batch", D.batch_axes_for_path),
                         ("cache", D.cache_axes_for_path)):
            leaves = jax.tree_util.tree_flatten_with_path(
                specs.get(part, {}))[0]
            for kp, leaf in leaves:
                p = D.sh.path_str(kp)
                axes[part + p] = list(fn(p, leaf.shape))
        out["axes"][arch + "/" + shape] = axes
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_specs_match_the_reference(arch, shape):
    """Parameters (stacked per layer), AdamW's state, the batch and the
    cache: the reference's shapes and types, leaf for leaf.  The cache
    positions are Python ints in the port (`init_cache`); each stands
    for the reference's int32 array of the same shape."""
    params = port_param_specs(arch)
    assert all(p.is_meta for p in params.values())
    got = {p: (leaf["shape"], _dtype(leaf["dtype"])) for p, leaf in
           sh.stacked_leaves(params.items()).items()}
    assert got == _ref_leaves(ref_param_specs(arch))

    opt = M.opt_state_specs(params)
    got = {}
    for key in ("mu", "nu"):
        got.update({p: (leaf["shape"], _dtype(leaf["dtype"])) for p, leaf in
                    sh.stacked_leaves(opt[key].items(), (key,)).items()})
    got["/count/"] = (tuple(opt["count"].shape), _dtype(opt["count"].dtype))
    assert got == _ref_leaves(ref_opt_specs(arch))

    specs = input_specs(get_config(arch), SHAPES[shape])
    want = ref_input_specs(ref_get_config(arch), REF_SHAPES[shape])
    assert sorted(specs) == sorted(want)
    for part in specs:
        assert _port_leaves(specs[part]) == _ref_leaves(want[part]), part
    if "cache" in specs:
        assert all(t.is_meta for t in jax.tree_util.tree_leaves(
            specs["cache"]) if isinstance(t, torch.Tensor))
        want_cache = RM.cache_specs(ref_get_config(arch),
                                    REF_SHAPES[shape].global_batch,
                                    REF_SHAPES[shape].seq_len)
        assert _port_leaves(M.cache_specs(
            get_config(arch), SHAPES[shape].global_batch,
            SHAPES[shape].seq_len)) == _ref_leaves(want_cache)


# --------------------------------------------------------------- sharding
def _ref_rules(arch, shape, mesh, plan):
    cfg = ref_get_config(arch)
    if plan == "optimized":
        cfg = dataclasses.replace(cfg, moe_impl="capacity",
                                  logits_dtype="bfloat16",
                                  mla_absorbed=True)
    cell = REF_SHAPES[shape]
    stub = ref_mesh_stub(REF_AXES[mesh])
    pl = ref_planner.plan(cfg, cell.kind, cell.seq_len, cell.global_batch,
                          stub, optimized=plan == "optimized", arch=arch,
                          shape=shape)
    return ref_sh.Rules(pl.rules, stub), pl


def _port_rules(arch, shape, mesh, plan):
    cfg = get_config(arch)
    if plan == "optimized":
        cfg = dataclasses.replace(cfg, moe_impl="capacity",
                                  logits_dtype="bfloat16",
                                  mla_absorbed=True)
    cell = SHAPES[shape]
    m = make_production_mesh(multi_pod=mesh == "multi")
    pl = planner.plan(cfg, cell.kind, cell.seq_len, cell.global_batch, m,
                      optimized=plan == "optimized", arch=arch, shape=shape)
    return sh.Rules(pl.rules, m), pl


def _ref_spec(rules, axes, shape) -> tuple:
    return tuple(rules.spec_for(tuple(axes), tuple(shape)))


SHARDING = [(a, s, m, p) for a, s in CELLS for m in MESHES for p in PLANS]


@pytest.mark.parametrize("arch,shape,mesh,plan", SHARDING,
                         ids=["-".join(c) for c in SHARDING])
def test_sharding_matches_the_reference(arch, shape, mesh, plan, ref_dryrun):
    """Every parameter, AdamW state, cache and batch leaf: the port's
    ``Rules.spec_for(axes_for_path(...))`` is the reference's, with the
    reference's rules from its planner on ``mesh_stub`` (no 512-device
    backend).  A per-layer parameter's spec is the stacked one without
    its first entry; the planner maps ``layer`` to no mesh axis."""
    ref_rules, ref_plan = _ref_rules(arch, shape, mesh, plan)
    rules, pl = _port_rules(arch, shape, mesh, plan)
    assert pl.rules == ref_plan.rules
    assert pl.rules["layer"] is None
    params = port_param_specs(arch)
    ref_params = {ref_sh.path_str(kp): tuple(leaf.shape) for kp, leaf in
                  jax.tree_util.tree_flatten_with_path(
                      ref_param_specs(arch))[0]}
    stacked = sh.stacked_shardings(params.items(), rules)
    assert {p: v[2] for p, v in stacked.items()} == {
        p: _ref_spec(ref_rules, ref_sh.axes_for_path(p, s), s)
        for p, s in ref_params.items()}
    leaves = sh.stacked_leaves(params.items())
    per_layer = sh.params_shardings(params.items(), rules)
    axes = sh.param_axes_tree(params.items())
    for path, leaf in leaves.items():
        spec = stacked[path][2]
        for name in leaf["names"]:
            assert per_layer[name] == (spec[1:] if leaf["stacked"]
                                       else spec)
            assert len(per_layer[name]) == params[name].dim()
            assert len(axes[name]) == params[name].dim()

    ref_opt = {ref_sh.path_str(kp): tuple(leaf.shape) for kp, leaf in
               jax.tree_util.tree_flatten_with_path(ref_opt_specs(arch))[0]}
    opt = M.opt_state_specs(params)
    got = {}
    for key in ("mu", "nu"):
        got.update({p: v[2] for p, v in sh.stacked_shardings(
            opt[key].items(), rules, (key,)).items()})
    got["/count/"] = rules.spec_for(sh.axes_for_path("/count/", ()), ())
    assert got == {p: _ref_spec(ref_rules, ref_sh.axes_for_path(p, s), s)
                   for p, s in ref_opt.items()}

    specs = input_specs(get_config(arch), SHAPES[shape])
    ref_axes = ref_dryrun["axes"][f"{arch}/{shape}"]
    got = {}
    for part, fn in (("batch", dryrun.batch_axes_for_path),
                     ("cache", dryrun.cache_axes_for_path)):
        for p, (s, _, spec) in dryrun.tree_shardings(
                specs.get(part, {}), fn, rules).items():
            assert list(fn(p, s)) == ref_axes[part + p], part + p
            got[part + p] = (spec, _ref_spec(ref_rules, ref_axes[part + p],
                                             s))
    assert sorted(got) == sorted(ref_axes)
    assert all(a == b for a, b in got.values()), {
        k: v for k, v in got.items() if v[0] != v[1]}


def test_layer_split_leaves():
    """Where a stacked leaf's first spec entry is a mesh axis (the q, k
    and v biases, whose rule reads the stacked (L, H, D) shape as
    (embed, heads, head_dim); qwen2-vl's 80 layers divide the 16-way
    data axis in training), the dry run's per-device bytes divide the
    layer stack, as the reference's do."""
    rules, _ = _port_rules("qwen2-vl-72b", "train_4k", "single", "baseline")
    params = port_param_specs("qwen2-vl-72b")
    stacked = sh.stacked_shardings(params.items(), rules)
    leaves = sh.stacked_leaves(params.items())
    split = {p for p, (_, _, spec) in stacked.items()
             if leaves[p]["stacked"] and spec[0]}
    assert split == {"/layers/attn/q/b/", "/layers/attn/k/b/",
                     "/layers/attn/v/b/"}
    shape, _, spec = stacked["/layers/attn/q/b/"]
    assert spec == ("data", "model", None)
    assert sh.shard_shape(shape, spec, rules.mesh.shape) == (5, 4, 128)


def test_mesh_and_shard_shape():
    assert PRODUCTION_MESH_AXES == REF_AXES
    from repro.launch import mesh as ref_mesh
    from repro_torch.launch import mesh
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        r = ref_mesh_stub(REF_AXES["multi" if multi else "single"])
        assert mesh.mesh_device_count(m) == ref_mesh.mesh_device_count(r)
        assert mesh.dp_axes(m) == ref_mesh.dp_axes(r)
    assert mesh.make_smoke_mesh().shape == {"data": 1, "model": 1}
    assert mesh_stub({"a": 2}).shape == {"a": 2}
    ms = {"pod": 2, "data": 16, "model": 16}
    assert sh.shard_shape((256, 4096, 20, 128), (("pod", "data"), None,
                                                  "model", None), ms) == (
        8, 4096, 2, 128)
    assert sh.shard_shape((7,), (), ms) == (7,)


def test_constrain_records_only_under_rules():
    x = torch.zeros(4, 6)
    assert sh.constrain(x, ("batch", "embed")) is x
    assert sh.active_rules() is None
    rules = sh.Rules({"batch": "data", "embed": "model"},
                     mesh_stub({"data": 2, "model": 4}))
    with sh.use_rules(rules):
        assert sh.constrain(x, ("batch", "embed")) is x
        assert sh.constrain(x, ("batch", "embed")) is x
    assert sh.active_rules() is None
    (row,) = rules.constrained.values()
    assert row == {"names": ["batch", "embed"], "shape": [4, 6],
                   "spec": ["data", None], "per_device": [2, 6],
                   "count": 2}


def test_the_models_annotate_beneath_the_launchers():
    """`constrain` and its rule stack live in `models.annotate`, which
    the models import; `launch.sharding` re-exports them, and no module
    of the models imports the launchers."""
    import ast
    from repro_torch.models import annotate
    from repro_torch.models import transformer as T
    assert sh.constrain is annotate.constrain is T.constrain
    assert sh.use_rules is annotate.use_rules
    assert sh.active_rules is annotate.active_rules
    models = os.path.join(ROOT, "src", "repro_torch", "models")
    for name in sorted(os.listdir(models)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(models, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            assert not any(m.startswith("repro_torch.launch")
                           for m in mods), (name, mods)


def test_kernel_work_reads_its_formula_only_while_counting():
    """A launch with no op counter active pays one check: the wrapper's
    (FLOPs, bytes) callable is not called.  Under `op_analysis` it is
    called once, and the call is one kernel row."""
    calls = []

    def work():
        calls.append(1)
        return 7.0, 11

    def launch():
        with kernels.kernel_work("probe", work):
            return torch.ones(2) + 1

    assert not kernels.COUNTERS
    launch()
    assert calls == []
    res = op_analysis.analyze(launch)
    assert calls == [1]
    assert res["kernels"]["probe"]["calls"] == 1
    assert res["dot_flops"] == 7.0
    assert not kernels.COUNTERS


# ------------------------------------------------- active params and flops
def test_active_params_and_model_flops(ref_dryrun):
    for arch in ARCHS:
        cfg = get_config(arch)
        assert dryrun.active_params(cfg) == \
            ref_dryrun["active_params"][arch], arch
        for kind in ("train", "prefill", "decode"):
            assert [dryrun.model_flops(cfg, kind, t) for t in
                    (1, 4096, 8388608)] == \
                ref_dryrun["model_flops"][arch][kind], (arch, kind)


# ------------------------------------------------------- kernels on meta
def _gen(seed=0):
    return np.random.default_rng(seed)


def _t(rng, shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(dtype)


def _meta_like(*ts, grad=False):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            .requires_grad_(grad and t.is_floating_point()) for t in ts]


def _sig(ts) -> list:
    return [None if t is None else (tuple(t.shape), t.dtype) for t in ts]


def _ssd_inputs(rng, b=1, s=40, h=4, p=8, n=16, dtype=torch.bfloat16):
    x = _t(rng, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_t(rng, (b, s, h))).to(dtype)
    a_log = _t(rng, (h,), scale=0.5)
    bb = _t(rng, (b, s, 1, n), dtype)
    cc = _t(rng, (b, s, 1, n), dtype)
    return x, dt, a_log, bb, cc


def _grads_of(fn, ins):
    ins = [t.detach().requires_grad_(t.is_floating_point()) for t in ins]
    with torch.enable_grad():
        out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(o.float().sum() for o in outs)
        grads = torch.autograd.grad(
            loss, [t for t in ins if t.requires_grad])
    return outs, grads


META_CASES = ["ssd", "flash_attention", "flash_attention_window",
              "ragged_dot"]


def _meta_case(name):
    rng = _gen(1)
    if name == "ssd":
        ins = _ssd_inputs(rng)
        return (lambda *a: ssd_ops.ssd(*a, chunk=16)), ins
    if name.startswith("flash_attention"):
        q = _t(rng, (1, 40, 4, 16), torch.bfloat16)
        k = _t(rng, (1, 40, 2, 16), torch.bfloat16)
        v = _t(rng, (1, 40, 2, 16), torch.bfloat16)
        window = 8 if name.endswith("window") else None
        return (lambda *a: fa_ops.flash_attention(
            *a, window=window, block_k=16)), (q, k, v)
    x = _t(rng, (10, 24), torch.bfloat16)
    w = _t(rng, (3, 24, 8))
    offs = torch.tensor([0, 4, 4, 10], dtype=torch.int32)
    return rd_ops.ragged_dot, (x, w, offs)


@pytest.mark.parametrize("name", META_CASES)
def test_kernel_meta_branch_shapes(name):
    """A meta call returns the plain version's shapes and types, and
    under autograd its gradients do too; nothing launches."""
    fn, ins = _meta_case(name)
    kernels.reset_launches()
    want_out, want_grads = _grads_of(fn, ins)
    got_out = fn(*_meta_like(*ins))
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    assert _sig(got_out) == _sig(want_out)
    assert all(t.is_meta for t in got_out)
    got_out, got_grads = _grads_of(fn, _meta_like(*ins))
    assert _sig(got_out) == _sig(want_out)
    assert _sig(got_grads) == _sig(want_grads)
    assert all(g.is_meta for g in got_grads)
    assert not any(kernels.LAUNCHES.values())


def test_ssd_bwd_meta_branch():
    ins = _ssd_inputs(_gen(2))
    dy = torch.ones_like(ins[0])
    fin = torch.ones((1, 4, 8, 16))
    for d_final in (None, fin):
        want = ssd_ops.ssd_bwd(*ins, dy, d_final, chunk=16)
        got = ssd_ops.ssd_bwd(*_meta_like(*ins, dy),
                              *(_meta_like(d_final) if d_final is not None
                                else [None]), chunk=16)
        assert _sig(got) == _sig(want)


def test_meta_branches_keep_the_card_routes_checks():
    """A meta call is held to what the card's kernel takes: the SSD to
    one group, flash to head dims up to 256 (the CPU takes both)."""
    rng = _gen(3)
    x, dt, a_log, b, c = _ssd_inputs(rng)
    b2, c2 = (torch.cat([t, t], dim=2) for t in (b, c))
    ssd_ops.ssd(x, dt, a_log, b2, c2, chunk=16)
    with pytest.raises(ValueError, match="one group"):
        ssd_ops.ssd(*_meta_like(x, dt, a_log, b2, c2), chunk=16)
    q = torch.empty((1, 8, 2, 320), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="on cpu, q on meta"):
        fa_ops.flash_attention(*[torch.empty(1, 2, 1, 4, device=d)
                                 for d in ("meta", "cpu", "cpu")])


# ----------------------------------------------------- kernel formulas
def _flop_count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _bwd_flop_count(fn, ins) -> int:
    """FlopCounterMode's count of the backward alone of ``fn``.  The
    forward runs under a counter of its own, as `op_analysis` counts a
    whole step, so the graph is the one a counter sees (on the CPU the
    plain products' rows are blocked only outside a dispatch mode:
    `kernels.row_blocks`)."""
    ins = [t.detach().requires_grad_(t.is_floating_point()) for t in ins]
    with torch.enable_grad(), FlopCounterMode(display=False):
        out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        grads = [torch.ones_like(o) for o in outs]
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(outs, [t for t in ins if t.requires_grad],
                            grads)
    return fc.get_total_flops()


SSD_SHAPES = [(1, 64, 2, 8, 16, 16), (2, 40, 4, 8, 16, 16),
              (1, 100, 3, 16, 8, 32), (2, 17, 2, 4, 4, 8)]


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_formulas_count_the_plain_version(shape):
    b, s, h, p, n, chunk = shape
    ins = _ssd_inputs(_gen(4), b, s, h, p, n, torch.float32)
    assert _flop_count(lambda: ssd_chunked(*ins, chunk=chunk)) == \
        ssd_ops.flops((b, s, h, p), n, chunk)
    assert _bwd_flop_count(lambda *a: ssd_chunked(*a, chunk=chunk),
                           ins) == ssd_ops.bwd_flops((b, s, h, p), n, chunk)


FA_SHAPES = [(1, 40, 4, 40, 2, 16, None, 16), (2, 33, 2, 70, 2, 8, 8, 32),
             (1, 64, 8, 64, 1, 32, None, 512), (1, 1, 4, 50, 4, 16, None, 16)]


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
def test_flash_formula_counts_the_plain_version(shape):
    b, sq, hq, sk, hkv, d, window, block = shape
    rng = _gen(5)
    q, k, v = (_t(rng, (b, sq, hq, d)), _t(rng, (b, sk, hkv, d)),
               _t(rng, (b, sk, hkv, d)))
    off = sk - sq

    def fn(*a):
        return flash_attention_ref(*a, q_offset=off, window=window,
                                   block_k=block)
    f = fa_ops.flops(q.shape, sk, block)
    assert _flop_count(lambda: fn(q, k, v)) == f
    assert _bwd_flop_count(fn, (q, k, v)) == 2 * f


RD_SHAPES = [(10, 24, 8, [0, 4, 4, 10]), (64, 16, 32, [0, 16, 32, 48, 64]),
             (7, 8, 8, [0, 7]), (30, 40, 12, [0, 0, 10, 25, 30, 30])]


@pytest.mark.parametrize("shape", RD_SHAPES, ids=str)
def test_ragged_formula_counts_the_plain_version(shape):
    m, k, n, offs = shape
    rng = _gen(6)
    x, w = _t(rng, (m, k)), _t(rng, (len(offs) - 1, k, n))
    o = torch.tensor(offs, dtype=torch.int32)
    assert _flop_count(lambda: ragged_dot_ref(x, w, o)) == \
        rd_ops.flops(m, k, n)
    assert _bwd_flop_count(lambda a, b: ragged_dot_ref(a, b, o),
                           (x, w)) == 2 * rd_ops.flops(m, k, n)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_wrapper_counts_once_by_its_formula(device):
    """Under `op_analysis`, a wrapper's call is one kernel row at its
    formula on the CPU too, where the plain version's own products run
    uncounted."""
    ins = _ssd_inputs(_gen(7), 2, 40, 4, 8, 16, torch.float32)
    if device == "meta":
        ins = _meta_like(*ins)
    res = op_analysis.analyze(lambda: ssd_ops.ssd(*ins, chunk=16))
    f = ssd_ops.flops((2, 40, 4, 8), 16, 16)
    assert res["dot_flops"] == f
    assert res["kernels"]["ssd"]["calls"] == 1
    assert not {"bmm", "mm"} & set(res["counter"].by_op)
    assert res["collective_total_bytes"] == 0.0
    assert res["counter"].top_ops(1)[0][2] == "ssd"


# ------------------------------------------------------------------ CLI
REF_RECORD_KEYS = {
    "arch", "shape", "mesh", "optimized", "chips", "skipped", "lower_s",
    "compile_s", "per_device", "memory_analysis", "roofline", "planner"}
REF_NESTED_KEYS = {
    "per_device": {"hlo_flops", "hlo_bytes", "collective_bytes",
                   "collective_detail", "cost_analysis_flops_uncorrected",
                   "cost_analysis_bytes_uncorrected"},
    "memory_analysis": {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "generated_code_size_in_bytes",
                        "alias_size_in_bytes"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops_total", "hlo_flops_total",
                 "useful_flops_ratio", "roofline_fraction"},
    "planner": {"rules", "predicted_collective_bytes", "transfers"}}


def test_cli_traces_on_the_cpu_without_cuda(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the two cells, with
    every entry into ``torch.cuda`` made to raise: the records carry the
    reference's keys."""
    out = tmp_path / "dry"
    code = f"""
import runpy, sys, torch
def refuse(*a, **k):
    raise AssertionError("the dry run touched torch.cuda")
torch.cuda._lazy_init = refuse
torch.cuda.is_available = refuse
for argv in (["--arch", "zamba2-1.2b", "--shape", "train_4k",
              "--mesh", "single"],
             ["--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k",
              "--mesh", "multi", "--plan", "optimized"]):
    sys.argv = ["dryrun"] + argv + ["--out", {str(out)!r}]
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("PASS ") == 2, proc.stdout
    for tag, chips in (("zamba2-1.2b__train_4k__single", 256),
                       ("deepseek-v2-lite-16b__decode_32k__multi__opt",
                        512)):
        rec = json.loads((out / f"{tag}.json").read_text())
        assert REF_RECORD_KEYS <= set(rec)
        for key, keys in REF_NESTED_KEYS.items():
            assert keys <= set(rec[key]), key
        assert rec["chips"] == chips and not rec["skipped"]
        assert rec["roofline"]["hlo_flops_total"] > \
            rec["roofline"]["model_flops_total"] > 0
        assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
        assert rec["activations"]
        assert rec["roofline"]["peak_flops"] == 989e12


def test_skipped_cell():
    rec = dryrun.trace_cell("glm4-9b", "long_500k", multi_pod=False)
    assert rec["skipped"] and "sub-quadratic" in rec["reason"]


# ------------------------------------------------------------- slow tests
@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,mesh,plan", SHARDING,
                         ids=["-".join(c) for c in SHARDING])
def test_every_cell_traces(arch, shape, mesh, plan):
    """The full sweep: every applicable cell on both meshes under both
    plans traces on meta, with every argument leaf's spec from the
    rules and the step's products counted."""
    rec = dryrun.trace_cell(arch, shape, multi_pod=mesh == "multi",
                            optimized=plan == "optimized")
    assert not rec["skipped"]
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert rec["roofline"]["hlo_flops_total"] > 0
    assert rec["roofline"]["model_flops_total"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["activations"]
    for act in rec["activations"]:
        assert len(act["per_device"]) == len(act["shape"]) == len(
            act["names"])


@pytest.mark.slow
def test_argument_bytes_match_the_reference_compile():
    """The reference's own ``lower_cell`` on 512 placeholder devices (a
    subprocess) for zamba2-1.2b's decode_32k cell: XLA's
    ``argument_size_in_bytes`` equals the port's, taken from the specs.
    (A cell whose step leaves an argument unused differs: ``jax.jit``
    drops unused arguments, such as whisper's encoder weights in its
    served decode.)"""
    code = """
import json
from repro.launch import dryrun as D
rec = D.lower_cell("zamba2-1.2b", "decode_32k", multi_pod=False)
print(json.dumps(rec["memory_analysis"]))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    rec = dryrun.trace_cell("zamba2-1.2b", "decode_32k", multi_pod=False)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        want["argument_size_in_bytes"]
