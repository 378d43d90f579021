"""Step-scoped checkpoint/restore of the training state, in the JAX
package's format (``repro/checkpoint/ckpt.py``), so a directory written
by either package loads in the other.

Format: one directory per step, ``step_%08d/``, with one ``.npz`` shard
per host (``shard_{host}.npz``) and a small JSON manifest (step, time,
keys, extra).  Writes go to a tmp directory renamed into place, so a
failure mid-write never corrupts the latest checkpoint;
`CheckpointManager` keeps the newest ``keep`` checkpoints and removes
the rest.

Arrays are keyed by the reference's leaf paths joined with ``/``: a
tuple's items by index, a dict's by key.  A model (`nn.Module`) stands
for its reference parameter tree (the layer axis stacked, as
`models.convert.to_reference` names it), and so does a dict of tensors
keyed by parameter name (module paths, which hold a ``.``: the
optimizer's ``mu`` and ``nu``).  The trainer's state ``(model,
{"mu", "nu", "count"}, step)`` is therefore saved under the keys of the
reference's ``(params, opt_state, step)``: ``0/layers/mamba/in_x/w``,
``1/mu/...``, ``1/count``, ``2``.  Keep ``count`` and ``step`` as int32
tensors, as the reference's are.

`load_checkpoint` restores into the structure of ``like``: a model's
parameters and a parameter dict's tensors are loaded in place; any
other tensor is made anew on ``device`` (default: the device of
``like``'s tensor), where the reference takes ``shardings=``.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch
from torch import nn

from repro_torch.models.convert import reference_path


def _is_param_dict(tree) -> bool:
    return isinstance(tree, dict) and bool(tree) and all(
        "." in k and isinstance(v, torch.Tensor) for k, v in tree.items())


def _flatten(tree, prefix: str = "") -> dict:
    """key -> [(layer index or None, tensor / array / number)]: the
    leaves of ``tree`` under the reference's keys, a stacked leaf as its
    per-layer tensors."""
    out: dict = {}
    if isinstance(tree, nn.Module) or _is_param_dict(tree):
        items = tree.named_parameters() if isinstance(tree, nn.Module) \
            else tree.items()
        for name, t in items:
            parts, index = reference_path(name)
            out.setdefault(prefix + "/".join(parts), []).append((index, t))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = [(None, tree)]
    return out


def _array(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _stacked(items) -> np.ndarray:
    if len(items) == 1 and items[0][0] is None:
        return _array(items[0][1])
    return np.stack([_array(t) for _, t in sorted(items,
                                                  key=lambda it: it[0])])


def _shape(items) -> tuple:
    if len(items) == 1 and items[0][0] is None:
        return tuple(np.shape(items[0][1]))
    return (len(items), *tuple(items[0][1].shape))


def save_checkpoint(path: str, state, step: int, *, host_id: int = 0,
                    extra: dict | None = None) -> str:
    """Atomically write ``state`` under ``path/step_<step>``."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _stacked(items) for k, items in _flatten(state).items()}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **arrays)
    if host_id == 0:
        manifest = {
            "step": step, "time": time.time(),
            "keys": sorted(arrays.keys()),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    os.replace(tmp, final) if not os.path.exists(final) else \
        _merge_tmp(tmp, final)
    return final


def _merge_tmp(tmp: str, final: str) -> None:
    for f in os.listdir(tmp):
        os.replace(os.path.join(tmp, f), os.path.join(final, f))
    shutil.rmtree(tmp, ignore_errors=True)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith("tmp0")]
    return max(steps) if steps else None


def load_checkpoint(path: str, like, step: int | None = None,
                    *, device=None):
    """Restore into the structure of ``like``; returns (state,
    manifest).  Models and parameter dicts in ``like`` are loaded in
    place and returned as they are."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: dict[str, np.ndarray] = {}
    for f_ in sorted(os.listdir(d)):
        if f_.startswith("shard_") and f_.endswith(".npz"):
            with np.load(os.path.join(d, f_)) as z:
                for k in z.files:
                    arrays[k] = z[k]
    want = _flatten(like)
    missing = set(want) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}")
    for k, items in want.items():
        if tuple(arrays[k].shape) != _shape(items):
            raise ValueError(f"shape mismatch for {k}: "
                             f"{arrays[k].shape} vs {_shape(items)}")
    return _restore(like, arrays, "", device), manifest


def _restore(like, arrays: dict, prefix: str, device):
    if isinstance(like, nn.Module) or _is_param_dict(like):
        items = like.named_parameters() if isinstance(like, nn.Module) \
            else like.items()
        with torch.no_grad():
            for name, t in items:
                parts, index = reference_path(name)
                arr = arrays[prefix + "/".join(parts)]
                t.copy_(torch.from_numpy(np.array(
                    arr if index is None else arr[index])))
        return like
    if isinstance(like, dict):
        return {k: _restore(v, arrays, f"{prefix}{k}/", device)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_restore(v, arrays, f"{prefix}{i}/", device)
                          for i, v in enumerate(like))
    arr = arrays[prefix[:-1]]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            like.device if device is None else device)
    if isinstance(like, np.ndarray):
        return arr
    return type(like)(arr)


class CheckpointManager:
    """Retention + cadence policy around save/load."""

    def __init__(self, path: str, *, keep: int = 3, every: int = 100):
        self.path = path
        self.keep = keep
        self.every = every

    def maybe_save(self, state, step: int, **kw) -> str | None:
        if step % self.every:
            return None
        out = save_checkpoint(self.path, state, step, **kw)
        self._gc()
        return out

    def _gc(self) -> None:
        if not os.path.isdir(self.path):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.path)
                       if d.startswith("step_") and "tmp" not in d)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like, **kw):
        return load_checkpoint(self.path, like, **kw)
