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
``LAUNCHES["flash_attention_fp32"]``.

Under autograd (grad enabled and an input requiring it) a call is one
`torch.autograd.Function` on every device.  Its forward also writes
each row's log-sum-exp (B, Hq, Sq) fp32, and saves q, k, v, the output
and the LSE; its backward is `flash_attention_bwd`: on the CPU the plain
version (`ref.flash_attention_bwd_ref`), on the card the two kernels of
``csrc/flash_attention_bwd.cu`` (``flash_bwd_dq``, then
``flash_bwd_dkdv``): bf16 on wgmma for every shape (D off 8 and
unaligned bases through plain loads into the same tiles), fp32 on
mma.sync's TF32 tensor cores, every product split into three (S and dP
too), within 1e-5 of each gradient's max |ref| where one TF32 product
misses it by 93x.  Each
backward call adds one to ``LAUNCHES["flash_attention_bwd"]`` and to
``["flash_attention_bwd_bf16"]`` or ``["flash_attention_bwd_fp32"]``.
Under per-block remat the forward runs twice a step (the recomputed one
writes the LSE the backward reads) and the backward once.

On the ``meta`` device (the dry run's) a call takes the CUDA route's
checks and returns outputs of the right shapes and types, computing
nothing and launching nothing, its backward too.  On every device each
call tells the op counters its dot FLOPs (`flops`, and twice that for
the backward; `kernels.kernel_work`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import count_launch, kernel_work, tensor_bytes
from .._build import load
from .ref import flash_attention_bwd_ref, flash_attention_ref

_NAME = "flash_attention"
_TC = "flash_attention_tc"     # the bf16 kernel's library
_BWD = "flash_attention_bwd"   # the backward's library and launch count
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, q_offset: int = 0,
                    window: int | None = None, block_k: int = 512):
    """Causal GQA attention (see the module docstring); ``block_k`` is
    the plain version's key block and does not change the result."""
    _check(q, k, v)
    if q.device.type != "cpu":
        _check_cuda(q, k, v, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_offset, window, block_k)
    return _forward(q, k, v, q_offset, window, block_k, False)[0]


def _check_cuda(q, k, v, q_offset: int) -> None:
    """What the CUDA kernels (forward and backward) take."""
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


def _forward(q, k, v, q_offset: int, window, block_k: int, with_lse: bool):
    """(output, the rows' LSE or None)."""
    def work():
        # Bytes: q, k and v, and the output (q's).
        return (flops(q.shape, k.shape[1], block_k),
                tensor_bytes(q, k, v) + tensor_bytes(q))
    with kernel_work(_NAME, work):
        if q.device.type == "cpu":
            res = flash_attention_ref(q, k, v, q_offset=q_offset,
                                      window=window, block_k=block_k,
                                      return_lse=with_lse)
            return res if with_lse else (res, None)
        return _launch(q, k, v, q_offset, window, with_lse)


def _launch(q, k, v, q_offset: int, window, with_lse: bool = False):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    win = 0 if window is None or window <= 0 else int(window)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.is_meta or out.numel() == 0:
        return out, lse
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
        err = _launcher(bf16)(*ptrs, 0 if lse is None else lse.data_ptr(),
                              b, sq, sk, hq, hkv, d, int(q_offset), win,
                              scale, vec, stream)
    route = "bf16" if bf16 else "fp32"
    if err != 0:
        raise RuntimeError(f"{_NAME} ({route}) launch failed: "
                           f"CUDA error {err}")
    count_launch(_NAME, route)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd, on every device: the forward with
    the rows' LSE, and `flash_attention_bwd` on the saved tensors."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, window, block_k):
        out, lse = _forward(q, k, v, q_offset, window, block_k, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(q_offset=q_offset, window=window, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout, **ctx.args),
                None, None, None)


def _bwd_launcher():
    fn = load(_BWD).flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q, k, v, out, lse, dout, *, q_offset: int = 0,
                        window: int | None = None, block_k: int = 512):
    """The gradients (dq, dk, dv) of `flash_attention` given its output
    ``out``, its rows' LSE (B, Hq, Sq) fp32 and ``dout``, each in its
    input's type.  CPU tensors take `ref.flash_attention_bwd_ref`; CUDA
    tensors the two backward kernels of their dtype, or the call raises;
    meta tensors the CUDA route's checks, and outputs only."""
    _check(q, k, v)
    b, sq, hq, _ = q.shape
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (b, hq, sq))):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(
                shape) or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} on {q.device}")

    def work():
        # Bytes: q, k, v, out, dout and the LSE read; the gradients written.
        return (2 * flops(q.shape, k.shape[1], block_k),
                2 * tensor_bytes(q, k, v) + tensor_bytes(dout))
    if q.device.type == "cpu":
        with kernel_work(_BWD, work):
            return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           q_offset=q_offset, window=window,
                                           block_k=block_k)
    _check_cuda(q, k, v, q_offset)
    with kernel_work(_BWD, work):
        return _launch_bwd(q, k, v, out, lse, dout, q_offset, window)[:3]


def _launch_bwd(q, k, v, out, lse, dout, q_offset: int, window, *,
                parts: int = 3, delta=None):
    """(dq, dk, dv, delta): both kernels (``parts`` 3), or the dq kernel
    alone (1, which writes delta) or the dk/dv kernel alone (2, reading a
    ``delta`` that an earlier call wrote), for timing each."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if delta is None:
        delta = torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)
    if q.is_meta:
        return dq, dk, dv, delta
    if dq.numel() == 0:   # no query: nothing reaches k or v
        return dq, dk.zero_(), dv.zero_(), delta
    win = 0 if window is None or window <= 0 else int(window)
    fp32 = q.dtype == torch.float32
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    tensors = (q, k, v, out, lse, dout, dq, dk, dv, delta)
    ptrs = [t.data_ptr() for t in tensors]
    # cp.async moves 16 bytes: rows of D % 8 == 0 bf16 or D % 4 == 0 fp32
    # values from 16-byte aligned bases; otherwise plain loads.
    vec = int(d % (16 // q.element_size()) == 0 and
              all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher()(*ptrs, b, sq, sk, hq, hkv, d, int(q_offset),
                              win, d ** -0.5, int(fp32), vec, parts, stream)
    route = "fp32" if fp32 else "bf16"
    if err != 0:
        raise RuntimeError(f"{_BWD} ({route}) launch failed: CUDA error "
                           f"{err}")
    if parts == 3:
        count_launch(_BWD, route)
    return dq, dk, dv, delta
