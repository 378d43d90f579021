"""The checked wrapper for the sbts_step conflict-count kernel.

`selection_counts(rows32, sel32)` takes ``int32 [n, W]`` adjacency words
and ``int32 [K, W]`` selection words (uint32 bit patterns) and returns
``int32 [K, n]`` = |N(v) ∩ S_k|.  Tensors on the CPU go to the plain
version (`ref.selection_counts_plain`); CUDA tensors go to the kernel
(``csrc/selection_counts.cu``), built at first use, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import count_launch
from .._build import load
from .ref import selection_counts_plain

_NAME = "selection_counts"


def _check(rows32: torch.Tensor, sel32: torch.Tensor) -> None:
    for name, t in (("rows32", rows32), ("sel32", sel32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows32.shape[1] != sel32.shape[1]:
        raise ValueError(f"word counts differ: rows32 {tuple(rows32.shape)}"
                         f" vs sel32 {tuple(sel32.shape)}")
    if rows32.device != sel32.device:
        raise ValueError(f"rows32 on {rows32.device}, sel32 on "
                         f"{sel32.device}")
    if rows32.shape[0] >= 2**31 or sel32.shape[0] >= 2**31:
        raise ValueError("more than 2**31 - 1 rows")


def _launcher():
    """The kernel's C launcher, with its ctypes signature declared (a
    pointer passed as a plain int would be cut to 32 bits)."""
    fn = load("sbts_step").selection_counts_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def selection_counts(rows32: torch.Tensor,
                     sel32: torch.Tensor) -> torch.Tensor:
    """|N(v) ∩ S_k| as ``int32 [K, n]`` (see the module docstring)."""
    _check(rows32, sel32)
    if rows32.device.type == "cpu":
        return selection_counts_plain(rows32, sel32)
    if rows32.device.type != "cuda":
        raise ValueError(f"selection_counts runs on cpu or cuda, not "
                         f"{rows32.device}")
    n, w = rows32.shape
    k = sel32.shape[0]
    out = torch.empty((k, n), dtype=torch.int32, device=rows32.device)
    if n == 0 or k == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(rows32.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(rows32.data_ptr(), sel32.data_ptr(), out.data_ptr(),
                     n, k, w, stream)
    if err != 0:
        raise RuntimeError(f"selection_counts launch failed: CUDA error "
                           f"{err}")
    count_launch(_NAME)
    return out
