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

On the ``meta`` device (the dry run's) a call takes the CUDA route's
checks and returns an output of q's shape and type, computing nothing and
launching nothing; under autograd it is a `torch.autograd.Function` whose
backward gives gradients of the inputs' shapes, so a dry run traces a
train step past 4096^2 pairs that the card cannot take yet.  On every
device each call tells the op counters its dot FLOPs (`flops`, and twice
that for a meta backward; `kernels.kernel_work`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import count_launch, kernel_work, tensor_bytes
from .._build import load
from .ref import flash_attention_ref

_NAME = "flash_attention"
_TC = "flash_attention_tc"     # the bf16 kernel's library
_DTYPES = (torch.float32, torch.bfloat16)


def flops(q_shape, sk: int, block_k: int = 512) -> float:
    """The dot FLOPs of the plain version (`ref.flash_attention_ref`) for
    q of ``q_shape`` (B, Sq, Hq, D) over ``sk`` keys: the keys padded to
    whole blocks of ``block_k``, Q K^T and P V over every block (masked
    pairs included), 2 FLOPs a multiply-add."""
    b, sq, hq, d = q_shape
    return 4.0 * b * sq * hq * d * -(-sk // block_k) * block_k


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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{_NAME} runs on cpu, cuda or meta, not "
                         f"{q.device}")


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

    def work():
        # Bytes: q, k and v, and the output (q's).
        return (flops(q.shape, k.shape[1], block_k),
                tensor_bytes(q, k, v) + tensor_bytes(q))
    if q.device.type == "cpu":
        with kernel_work(_NAME, work):
            return flash_attention_ref(q, k, v, q_offset=q_offset,
                                       window=window, block_k=block_k)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if grad and not q.is_meta:
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
    if grad:
        return _MetaAttention.apply(q, k, v, block_k)
    with kernel_work(_NAME, work):
        return _launch(q, k, v, q_offset, window)


def _launch(q, k, v, q_offset: int, window):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    win = 0 if window is None or window <= 0 else int(window)
    out = torch.empty_like(q)
    if q.is_meta or out.numel() == 0:
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


class _MetaAttention(torch.autograd.Function):
    """`flash_attention` on meta tensors under autograd: the output, and
    in the backward the gradients of q, k and v, by shape only, counted
    at `flops` and twice that (each product gives one gradient of each
    operand)."""

    @staticmethod
    def forward(ctx, q, k, v, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.flops = flops(q.shape, k.shape[1], block_k)
        with kernel_work(_NAME, lambda: (
                ctx.flops, tensor_bytes(q, k, v) + tensor_bytes(q))):
            return torch.empty_like(q)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with kernel_work(_NAME + "_bwd", lambda: (
                2 * ctx.flops,
                2 * tensor_bytes(q, k, v) + tensor_bytes(dout))):
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None)
