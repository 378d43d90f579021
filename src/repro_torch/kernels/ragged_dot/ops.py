"""The checked wrapper for the grouped (ragged) matrix product kernel.

`ragged_dot(x, w, group_offsets)` takes x (M, K) with rows sorted by
group, w (G, K, N) and group_offsets (G + 1,) int32 (group g the rows
``[offsets[g], offsets[g + 1])``) and returns (M, N) in x's type, as
`ref.ragged_dot_ref`.  Tensors on the CPU go to that plain version.
CUDA tensors go to ``csrc/ragged_dot.cu``, built at first use, or the
call raises: bfloat16 to the tensor-core kernel (mma.sync bf16 -> fp32,
one rounding to bf16), float32 to the CUDA-core fp32 kernel (the fp32
compute mode's).  The kernels read the offsets on the card, so a call
makes no host sync.  Every launch adds one to ``LAUNCHES["ragged_dot"]``
and one to the route it took, ``LAUNCHES["ragged_dot_bf16"]`` or
``LAUNCHES["ragged_dot_fp32"]``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import count_launch
from .._build import load
from .ref import ragged_dot_ref

_NAME = "ragged_dot"
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w, group_offsets) -> None:
    for name, t in (("x", x), ("w", w), ("group_offsets", group_offsets)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dim() != 2 or w.dim() != 3 or group_offsets.dim() != 1:
        raise ValueError("ragged_dot takes x (M, K), w (G, K, N) and "
                         "group_offsets (G + 1,)")
    if w.shape[1] != x.shape[1] or group_offsets.shape[0] != w.shape[0] + 1:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and "
                         f"group_offsets {tuple(group_offsets.shape)} "
                         f"disagree")
    if w.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype}, w is {w.dtype}")
    if group_offsets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group_offsets must be int32 or int64, not "
                        f"{group_offsets.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_NAME} runs on cpu or cuda, not {x.device}")


def _launcher():
    fn = load(_NAME).ragged_dot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ragged_dot(x, w, group_offsets):
    """The grouped product (see the module docstring)."""
    _check(x, w, group_offsets)
    if x.device.type == "cpu":
        return ragged_dot_ref(x, w, group_offsets)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{_NAME} takes float32 or bfloat16, not {x.dtype}")
    if group_offsets.dtype != torch.int32:
        raise TypeError("the kernel takes int32 group_offsets")
    for name, t in (("x", x), ("w", w), ("group_offsets", group_offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x.shape
    groups, _, n = w.shape
    if max(m, k, n, groups) >= 2**31:
        raise ValueError(f"{_NAME}: a size is out of range")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
    # cp.async moves 16 bytes: whole rows of 8 bf16 from 16-byte bases.
    vec = int(k % 8 == 0 and n % 8 == 0 and all(p % 16 == 0 for p in ptrs))
    fp32 = x.dtype == torch.float32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), w.data_ptr(),
                          group_offsets.data_ptr(), y.data_ptr(), m, k, n,
                          groups, vec, int(fp32), stream)
    route = "fp32" if fp32 else "bf16"
    if err != 0:
        raise RuntimeError(f"{_NAME} ({route}) launch failed: "
                           f"CUDA error {err}")
    count_launch(_NAME, route)
    return y
