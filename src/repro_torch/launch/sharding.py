"""Logical-axis sharding, as the reference's ``launch/sharding.py``: rules
map logical axis names to mesh axes.

Model code annotates activations with ``constrain(x, ("batch", "seq",
...))`` and parameters are annotated by path (`axes_for_path`).  The
active rule set is installed by the launcher (`use_rules`) from the
planner's output; with no rules installed `constrain` returns its input
and does nothing else, so serving and training on one card never touch
the mesh machinery.  `use_rules`, `active_rules` and `constrain` live in
`models.annotate`, beneath the models, and are re-exported here.

The port runs on one device and has no ``PartitionSpec``: a spec is a
plain tuple with one entry per tensor dim, each None (replicated), a
mesh axis name or a tuple of them.  Under the dry run's rules
`constrain` records each activation's logical names, its global shape
and its per-device shape (`shard_shape`), which `launch.dryrun` reports.

Divisibility fallback: a logical->mesh mapping is dropped (replicated)
for a tensor dimension the mesh axis does not divide — e.g. qwen1.5's
20 heads on a 16-way model axis.  This is the planner's "multicast beats
relay" degradation: replication of a high-reuse tensor is preferred over
padded sharding.

Parameter names.  The reference's rules key on its pytree paths
(``/layers/mamba/in_x/w/``) and see its layer-stacked shapes; the port's
parameters are module paths (``layers.3.mamba.in_x.w``), one per layer.
`stacked_leaves` maps them back through `models.convert.reference_path`
to the reference's leaves and stacked shapes, so the rules see the same
strings and shapes.  A per-layer parameter's spec is the stacked leaf's
spec without its first entry (`params_shardings`).  The planner maps the
``layer`` axis to no mesh axis, so that entry is None for every leaf
whose rule begins with ``layer``; a rule that names the stacked dim
otherwise (``/q/``, ``/k/`` and ``/v/`` biases, whose rule reads the
stacked (L, H, D) shape as (embed, heads, head_dim)) can give it a mesh
axis, and then the port splits its stack of per-layer modules over that
axis: the dry run's per-device bytes are taken on the stacked leaf
(`stacked_shardings`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.annotate import (active_rules,  # noqa: F401
                                         constrain, use_rules)
from repro_torch.models.convert import reference_path


def _axis_size(mesh_shape: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh_shape[a] for a in axes]))


def shard_shape(shape, spec, mesh_shape: dict) -> tuple:
    """The per-device shape of a tensor of global ``shape`` under
    ``spec`` on a mesh of ``mesh_shape`` (axis -> size); a dim a spec
    entry does not divide is rounded up, as XLA pads it."""
    return tuple(-(-int(n) // _axis_size(mesh_shape, axes))
                 for n, axes in zip(shape, tuple(spec) + (None,) * (
                     len(shape) - len(spec))))


class Rules:
    """logical axis name -> mesh axis (str | tuple | None), and the
    activations `constrain` saw under them (``constrained``)."""

    def __init__(self, mapping: dict, mesh):
        self.mapping = dict(mapping)
        self.mesh = mesh
        #: (names, global shape) -> {"names", "shape", "spec",
        #: "per_device", "count"}
        self.constrained: dict = {}

    def spec_for(self, names: tuple, shape: tuple | None = None) -> tuple:
        """The spec for logical ``names``; drops non-divisible and
        duplicate mesh-axis entries (first occurrence wins)."""
        parts = []
        used: set = set()
        for i, nm in enumerate(names):
            mx = self.mapping.get(nm)
            if mx is None:
                parts.append(None)
                continue
            axes = (mx,) if isinstance(mx, str) else tuple(mx)
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                parts.append(None)
                continue
            size = _axis_size(self.mesh.shape, axes)
            if shape is not None and shape[i] % size != 0:
                # divisibility fallback: keep the divisible prefix
                keep = []
                for a in axes:
                    if shape[i] % _axis_size(self.mesh.shape,
                                             tuple(keep + [a])) == 0:
                        keep.append(a)
                axes = tuple(keep)
                if not axes:
                    parts.append(None)
                    continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def record(self, names: tuple, shape: tuple) -> tuple:
        """The spec of a constrained activation, kept in
        ``constrained`` with its per-device shape."""
        spec = self.spec_for(names, shape)
        row = self.constrained.setdefault((tuple(names), shape), {
            "names": list(names), "shape": list(shape),
            "spec": [list(a) if isinstance(a, tuple) else a for a in spec],
            "per_device": list(shard_shape(shape, spec, self.mesh.shape)),
            "count": 0})
        row["count"] += 1
        return spec


# --------------------------------------------------------- param axes map
def axes_for_path(path: str, shape: tuple) -> tuple:
    """Logical axis names for a parameter, from its reference pytree path
    and its stacked shape (the reference's rules, as they are).

    Conventions (see models/*.py): stacked layer params have a leading
    'layer' axis; expert weights lead with 'expert'; attention projections
    end with (heads|kv_heads, head_dim).
    """
    p = path.lower()
    nd = len(shape)

    def lead(*names):
        base = ("layer",) * (nd - len(names)) + tuple(names)
        return base

    if "embed/table" in p:
        return ("vocab", "embed")
    if "unembed" in p:
        return lead("embed", "vocab")
    if any(k in p for k in ("norm", "ln", "scale", "a_log", "dt_bias",
                            "d_skip")) and nd <= 2:
        return ("layer",) * (nd - 1) + ("embed",)
    if "router" in p:
        return lead("embed", "expert")
    if "w_gate" in p or "w_up" in p:
        return lead("expert", "embed", "mlp")
    if "w_down" in p:
        return lead("expert", "mlp", "embed")
    if "/q/" in p or "/k/" in p or "/v/" in p:
        if nd >= 3 and shape[-1] <= 512:
            return lead("embed", "heads", "head_dim") if "/q/" in p \
                else lead("embed", "kv_heads", "head_dim")
        return lead("heads", "head_dim") if nd >= 2 else lead("head_dim")
    if "/uk/" in p or "/uv/" in p:
        return lead("kv_lora", "heads", "head_dim")
    if "/dkv/" in p:
        return lead("embed", "kv_lora")
    if "/kpe/" in p:
        return lead("embed", "head_dim")
    if "/o/" in p:
        return lead("heads_merged", "embed")
    if "gate/" in p or "up/" in p:
        return lead("embed", "mlp")
    if "down/" in p:
        return lead("mlp", "embed")
    if "in_x" in p or "in_z" in p:
        return lead("embed", "ssm_inner")
    if "in_b" in p or "in_c" in p:
        return lead("embed", "ssm_state")
    if "in_dt" in p:
        return lead("embed", "ssm_heads")
    if "conv/w" in p:
        return lead("conv_w", "ssm_inner")
    if "conv/b" in p:
        return lead("ssm_inner")
    if "out/" in p:
        return lead("ssm_inner", "embed")
    # bias vectors and anything else: replicate non-layer dims
    return ("layer",) * (nd - 1) + (None,) if nd else ()


def path_str(keys) -> str:
    """The reference's path string of a list of keys: ``/a/b/c/``."""
    return "/" + "/".join(str(k) for k in keys) + "/"


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list[tuple]:
    """(path string, shape, dtype) of every leaf of a nested dict of
    tensors, in key order.  A Python int (a cache position) stands for
    the reference's int32 scalar and a list of them for its (n,) int32
    array."""
    out = []
    for key, val in tree.items():
        keys = prefix + (key,)
        if isinstance(val, dict):
            out += tree_leaves_with_path(val, keys)
        elif isinstance(val, torch.Tensor):
            out.append((path_str(keys), tuple(val.shape), val.dtype))
        elif isinstance(val, list):
            out.append((path_str(keys), (len(val),), torch.int32))
        else:
            out.append((path_str(keys), (), torch.int32))
    return out


def stacked_leaves(named, prefix: tuple = ()) -> dict[str, dict]:
    """The reference's leaves behind the port's named tensors ``named``
    (pairs of module path and tensor: parameters, or optimizer moments
    keyed by parameter name): reference path string (``prefix`` keys
    first) -> {"shape": the stacked shape, "dtype", "names": the port's
    names, in layer order, "stacked": whether a layer axis leads}."""
    leaves: dict[str, dict] = {}
    for name, t in named:
        parts, index = reference_path(name)
        leaf = leaves.setdefault(path_str(prefix + tuple(parts)), {
            "shape": tuple(t.shape), "dtype": t.dtype, "names": [],
            "stacked": index is not None})
        leaf["names"].append((index, name))
    for leaf in leaves.values():
        leaf["names"] = [n for _, n in sorted(
            leaf["names"], key=lambda p: -1 if p[0] is None else p[0])]
        if leaf["stacked"]:
            leaf["shape"] = (len(leaf["names"]),) + leaf["shape"]
    return leaves


def param_axes_tree(named, prefix: tuple = ()) -> dict[str, tuple]:
    """Port name -> logical axes of each of ``named``: the stacked leaf's
    axes, without the first for a per-layer tensor."""
    out = {}
    for path, leaf in stacked_leaves(named, prefix).items():
        axes = axes_for_path(path, leaf["shape"])
        for name in leaf["names"]:
            out[name] = axes[1:] if leaf["stacked"] else axes
    return out


def stacked_shardings(named, rules: Rules, prefix: tuple = ()) -> dict:
    """Reference path string -> (stacked shape, dtype, spec) of the
    leaves behind ``named``: the specs the reference gives its stacked
    tree."""
    return {path: (leaf["shape"], leaf["dtype"],
                   rules.spec_for(axes_for_path(path, leaf["shape"]),
                                  leaf["shape"]))
            for path, leaf in stacked_leaves(named, prefix).items()}


def params_shardings(named, rules: Rules, prefix: tuple = ()) -> dict:
    """Port name -> spec of each of ``named`` (parameters, or optimizer
    moments under ``prefix`` ("mu",) or ("nu",)): the stacked leaf's
    spec, without its first entry for a per-layer tensor (see the module
    docstring)."""
    out = {}
    leaves = stacked_leaves(named, prefix)
    for path, (shape, _, spec) in stacked_shardings(
            named, rules, prefix).items():
        for name in leaves[path]["names"]:
            out[name] = spec[1:] if leaves[path]["stacked"] else spec
    return out
