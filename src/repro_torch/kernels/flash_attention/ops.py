"""The checked wrapper for the flash-attention kernel.

`flash_attention(q, k, v, q_offset=, window=)` takes q (B, Sq, Hq, D)
and k, v (B, Sk, Hkv, D), float32 or bfloat16, and returns
(B, Sq, Hq, D) in q's type.  Tensors on the CPU go to the plain version
(`ref.flash_attention_ref`).  CUDA tensors go to a tensor-core kernel
chosen by dtype, built at first use, or the call raises: bfloat16 to
``csrc/flash_attention_tc.cu`` (wgmma), float32 to
``csrc/flash_attention.cu`` (TF32 operands, each product split into
three, which holds the 2e-6 fp32 tolerance that one TF32 or bf16
product misses: wgmma up to D = 64; past it P V on mma.sync and S in
fp32 on the CUDA cores, in the plain version's order).  Both take head
dims D up to 256, the largest of the repository's configs; a wider head
raises.  Every launch adds one to ``LAUNCHES["flash_attention"]`` and
one to the route it took, ``LAUNCHES["flash_attention_bf16"]`` or
``LAUNCHES["flash_attention_fp32"]``.  There is no backward kernel yet
(ROADMAP Queue 2): a CUDA call under autograd (grad enabled and an input
requiring it) raises `NotImplementedError`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import count_launch
from .._build import load
from .ref import flash_attention_ref

_NAME = "flash_attention"
_TC = "flash_attention_tc"     # the bf16 kernel's library
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype: {name} is "
                            f"{t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"differ")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[2]} key heads")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_NAME} runs on cpu or cuda, not {q.device}")


def _launcher(bf16: bool):
    fn = load(_TC).flash_attention_tc_launch if bf16 else \
        load(_NAME).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, q_offset: int = 0,
                    window: int | None = None, block_k: int = 512):
    """Causal GQA attention (see the module docstring); ``block_k`` is
    the plain version's key block and does not change the result."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset,
                                   window=window, block_k=block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            f"{_NAME} has no backward kernel yet (ROADMAP Queue 2: flash "
            f"attention's backward); training on the card takes attention "
            f"over at most 4096^2 (query, key) pairs, the plain product")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{_NAME} takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d > 256:
        raise ValueError(f"{_NAME} takes head dims up to 256 (the largest "
                         f"of the repository's configs), not {d}; a wider "
                         f"head is not planned (ROADMAP.md)")
    if max(b, sq, sk, hq, 64 * hkv * d) >= 2**31 or abs(q_offset) >= 2**30:
        raise ValueError(f"{_NAME}: a size or q_offset is out of range")
    win = 0 if window is None or window <= 0 else int(window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    bf16 = q.dtype == torch.bfloat16
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    # cp.async moves 16 bytes: rows of D % 8 == 0 bf16 or D % 4 == 0
    # fp32 values from 16-byte aligned bases; otherwise plain loads.
    vec = int(d % (16 // q.element_size()) == 0 and
              all(p % 16 == 0 for p in ptrs))
    # The bf16 kernel takes the scale times log2(e) (it computes exp2).
    scale = d ** -0.5 * (math.log2(math.e) if bf16 else 1.0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(bf16)(*ptrs, b, sq, sk, hq, hkv, d, int(q_offset),
                              win, scale, vec, stream)
    route = "bf16" if bf16 else "fp32"
    if err != 0:
        raise RuntimeError(f"{_NAME} ({route}) launch failed: "
                           f"CUDA error {err}")
    count_launch(_NAME, route)
    return out
