"""Weight carry-over between the JAX package's parameter tree and the
port's modules.

The reference holds its parameters as nested dicts with the layer axis
stacked (``["layers"]["mamba"]["in_x"]["w"]`` is (L, d_in, d_out)); the
port's module paths are the same keys with that axis split per layer
(``layers.<i>.mamba.in_x.w``, ``layers.<i>.attn.q.w``,
``layers.<i>.ln1.bias``).  `from_reference` takes the tree as
nested dicts of numpy arrays (for instance ``jax.tree.map(np.asarray,
params)``) and builds the port's model from it; `to_reference` gives
the tree back (`to_reference_tree` does the same for any tensors keyed
by parameter name, such as gradients or optimizer moments).  A tied
embedding has no ``unembed`` leaf on either side.
zamba2's shared attention block is one module, loaded once and reused
by every invocation.  The moe family's leaves need nothing special:
the stacked expert weights ``["layers"]["ffn"]["w_gate"]`` (L, E, D,
F) are ``layers.<i>.ffn.w_gate`` (E, D, F), the router and the shared
MLP are ``ffn.router`` and ``ffn.shared``, and MLA's projections
``attn.q``, ``dkv``, ``kpe``, ``uk``, ``uv`` and ``o``.  The encdec
family stacks its encoder as ``["enc_layers"]`` (``enc_layers.<i>.``)
beside ``["enc_norm"]``, and its decoder layers add ``ln_x`` and the
cross-attention ``xattn``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import transformer as T
from .layers import resolve_device
from .transformer import ModelConfig

_STACKED = ("layers", "enc_layers")


def reference_path(path: str) -> tuple[list[str], int | None]:
    """(the reference tree's keys, the layer index or None) behind the
    module path ``path``: ``layers.3.mamba.in_x.w`` is leaf
    ``["layers"]["mamba"]["in_x"]["w"]``, layer 3 of its stack."""
    parts = path.split(".")
    if parts[0] in _STACKED:
        return [parts[0]] + parts[2:], int(parts[1])
    return parts, None


def _leaf(tree: dict, path: str) -> np.ndarray:
    """The reference leaf behind the module path ``path``."""
    parts, index = reference_path(path)
    node = tree
    for key in parts:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"the reference tree has no leaf for {path!r}")
        node = node[key]
    arr = np.asarray(node)
    return arr[index] if index is not None else arr


def _leaf_paths(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out += _leaf_paths(val, name + ".")
        else:
            out.append(name)
    return out


def from_reference(cfg: ModelConfig, params_np: dict, device=None) -> nn.Module:
    """The port's model of ``cfg`` holding the reference's weights
    ``params_np`` (nested dicts of numpy arrays), on ``device``."""
    dev = resolve_device(device)
    model = T.build_model(cfg, device=torch.device("meta"))
    model = model.to_empty(device=dev)
    used = set()
    for path, p in model.named_parameters():
        arr = _leaf(params_np, path)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: reference shape {arr.shape}, port "
                             f"shape {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr)))
        parts = path.split(".")
        used.add(".".join(parts[:1] + parts[2:]) if parts[0] in _STACKED
                 else path)
    missing = sorted(set(_leaf_paths(params_np)) - used)
    if missing:
        raise ValueError(f"reference leaves with no port parameter: "
                         f"{missing}")
    return model


def to_reference(cfg: ModelConfig, model: nn.Module) -> dict:
    """The reference's parameter tree (nested dicts of float32 numpy
    arrays, layer axis stacked) of the port's ``model``."""
    return to_reference_tree(model.named_parameters())


def to_reference_tree(named) -> dict:
    """The reference's tree (layer axis stacked) of ``named``, pairs of
    (module path, tensor or array): a model's parameters, or its
    gradients or optimizer moments keyed by parameter name."""
    tree: dict = {}
    stacked: dict[str, list] = {}
    for path, t in named:
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        parts, index = reference_path(path)
        if index is not None:
            stacked.setdefault(".".join(parts), []).append((index, arr))
            continue
        _put(tree, parts, arr)
    for key, items in stacked.items():
        items.sort(key=lambda t: t[0])
        _put(tree, key.split("."), np.stack([a for _, a in items]))
    return tree


def _put(tree: dict, parts: list[str], arr: np.ndarray) -> None:
    node = tree
    for key in parts[:-1]:
        node = node.setdefault(key, {})
    node[parts[-1]] = arr
