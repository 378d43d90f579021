"""Weight carry-over between the JAX package's parameter tree and the
port's modules.

The reference holds its parameters as nested dicts with the layer axis
stacked (``["layers"]["mamba"]["in_x"]["w"]`` is (L, d_in, d_out)); the
port's module paths are the same keys with that axis split per layer
(``layers.<i>.mamba.in_x.w``, ``layers.<i>.attn.q.w``,
``layers.<i>.ln1.bias``).  `from_reference` takes the tree as
nested dicts of numpy arrays (for instance ``jax.tree.map(np.asarray,
params)``) and builds the port's model from it; `to_reference` gives
the tree back.  A tied embedding has no ``unembed`` leaf on either side.
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


def _leaf(tree: dict, path: str) -> np.ndarray:
    """The reference leaf behind the module path ``path``."""
    parts = path.split(".")
    index = None
    if parts[0] in _STACKED:
        index = int(parts[1])
        parts = [parts[0]] + parts[2:]
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
    tree: dict = {}
    stacked: dict[str, list] = {}
    for path, p in model.named_parameters():
        arr = p.detach().cpu().numpy()
        parts = path.split(".")
        if parts[0] in _STACKED:
            key = ".".join(parts[:1] + parts[2:])
            stacked.setdefault(key, []).append((int(parts[1]), arr))
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
