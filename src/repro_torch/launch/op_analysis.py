"""Op-level FLOP and byte counts of a traced step: the port's counterpart
of the reference's ``launch/hlo_analysis.py``.

The port has no HLO.  PyTorch runs eagerly, so the counts come from the
ops as they are dispatched: `analyze` runs a function under `OpCounter`,
a `TorchDispatchMode` that sees every ATen op, on any device (``meta``
for the dry run, where nothing is computed, or the card).  It gives the
reference's keys:

- ``dot_flops``: 2 · numel(result) · contracted size over ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv`` and ``dot`` (an ``einsum`` or
  ``matmul`` reaches them), plus each hand-written kernel's stated
  formula, the dot FLOPs of its plain version (`kernels.kernel_work`;
  a kernel launched through ``ctypes`` is seen by no dispatch mode).
  Elementwise FLOPs are not counted, as the reference does not count
  them.
- ``hbm_bytes``: the bytes of every op's tensor inputs and outputs, each
  op a boundary (views and ``empty`` move nothing and are not counted; a
  kernel counts its inputs and outputs once).  The reference counts at
  XLA's fusion boundaries, where an elementwise chain is one op; eager
  PyTorch runs every op of it on its own, so this count is an upper
  bound on the reference's.
- ``collective_bytes``, ``collective_counts`` and
  ``collective_total_bytes``: zero.  The trace is global (one logical
  device, the mesh only in the sharding rules), so it holds no
  collective; the dry run takes the planner's predicted collective
  bytes instead.

`OpCounter.top_ops` lists the ops by bytes, the reference's
drill-down.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
#: op -> index of its first product operand; each counts 2 · numel(result)
#: · that operand's last dim.
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
         _aten.dot.default: 0, _aten.addmm.default: 1,
         _aten.baddbmm.default: 1}
#: Ops that move no bytes: allocation without a write, and aliases.
_NO_BYTES = ("empty", "empty_like", "empty_strided", "detach", "alias",
             "lift_fresh")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _moves_nothing(func) -> bool:
    if getattr(func, "is_view", False):
        return True
    return func.overloadpacket.__name__ in _NO_BYTES


class OpCounter(TorchDispatchMode):
    """Counts the dot FLOPs and the bytes of every op dispatched while it
    is active, per op name (``by_op``) and per hand-written kernel
    (``kernels``); see the module docstring."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        #: op name -> [calls, dot FLOPs, bytes]
        self.by_op: dict[str, list] = {}
        #: kernel name -> [calls, dot FLOPs, bytes]
        self.kernels: dict[str, list] = {}
        self._inside = 0
        self._entered = 0

    def __enter__(self):
        # Entered again for each decomposition (`__torch_dispatch__`);
        # registered with the kernels once.
        if not self._entered:
            with kernels._COUNT_LOCK:
                kernels.COUNTERS.append(self)
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        if not self._entered:
            with kernels._COUNT_LOCK:
                kernels.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def _add(self, table: dict, name: str, flops: float, nbytes: float):
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.dot_flops += flops
        self.hbm_bytes += nbytes

    def kernel_begin(self, name: str, flops: float, nbytes: float) -> None:
        """A wrapper's kernel starts: counted once, by its formula, unless
        it runs inside another kernel; the ops until `kernel_end` are
        not counted."""
        if not self._inside:
            self._add(self.kernels, name, float(flops), float(nbytes))
        self._inside += 1

    def kernel_end(self) -> None:
        self._inside -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._inside:
            return func(*args, **kwargs)
        if func not in _DOTS:
            # A composite op (``matmul``, ``einsum`` or ``linear`` under
            # inference mode, where autograd does not decompose them)
            # is counted by the ops it decomposes into.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        flops = 0.0
        lhs = _DOTS.get(func)
        if lhs is not None:
            res = out if isinstance(out, torch.Tensor) else out[0]
            flops = 2.0 * res.numel() * args[lhs].shape[-1]
        nbytes = 0.0
        if not _moves_nothing(func):
            nbytes = float(sum(
                _nbytes(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor)))
        self._add(self.by_op, func.overloadpacket.__name__, flops, nbytes)
        return out

    def result(self) -> dict:
        """The reference's keys (see the module docstring), and the
        per-kernel counts under ``kernels``."""
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": {k: 0.0 for k in COLLECTIVES},
            "collective_counts": {k: 0 for k in COLLECTIVES},
            "collective_total_bytes": 0.0,
            "n_ops": sum(r[0] for r in self.by_op.values()),
            "kernels": {name: {"calls": r[0], "dot_flops": r[1],
                               "bytes": r[2]}
                        for name, r in sorted(self.kernels.items())},
        }

    def top_ops(self, k: int = 15) -> list[tuple]:
        """The ``k`` ops (hand-written kernels among them) with the most
        bytes: (bytes, calls, op, dot FLOPs), most first."""
        rows = [(r[2], r[0], name, r[1]) for name, r in
                list(self.by_op.items()) + list(self.kernels.items())]
        return sorted(rows, reverse=True)[:k]


def analyze(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` under an `OpCounter`: its `result`, with
    ``fn``'s return value under ``"out"`` and the counter under
    ``"counter"`` (its `OpCounter.top_ops`)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return dict(counter.result(), out=out, counter=counter)
