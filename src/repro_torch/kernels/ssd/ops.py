"""The checked wrapper for the SSD scan kernel.

`ssd(x, dt, a_log, b, c, chunk=)` takes x (B, S, H, P), dt (B, S, H),
a_log (H,) float32 and b, c (B, S, G, N) and returns (y (B, S, H, P) in
x's type, final state (B, H, P, N) float32), as `ref.ssd_chunked`.
Tensors on the CPU go to that plain version.  CUDA tensors go to the
chunk-parallel tensor-core stages chosen by dtype (three CUDA kernels a
call, on scratch this wrapper allocates), built at first use, or the
call raises: bfloat16 to ``csrc/ssd_tc.cu`` (split-bf16 operands),
float32 to ``csrc/ssd.cu`` (TF32 operands, each product split into
three, which holds the fp32 tolerances of 1e-4 + 1e-5 |y| that one or
two TF32 products miss).  Both take one group (G = 1), as the TPU kernel does,
N <= 128 and chunks of up to 1024 steps; S need not be a multiple of
the chunk.  Every call adds one to ``LAUNCHES["ssd"]`` and one to the
route it took, ``LAUNCHES["ssd_bf16"]`` or ``LAUNCHES["ssd_fp32"]``.

Under autograd (grad enabled and an input requiring it) a CUDA call is
a `torch.autograd.Function`: the forward kernels above, and for the
backward `ssd_bwd`, hand-written kernels chosen by dtype (one group, N
<= 128, chunks <= 1024, S off a multiple of the chunk): bfloat16 to
``csrc/ssd_bwd_tc.cu`` (five kernels, the products on the bf16 tensor
cores with each fp32 operand in two bf16 terms, dB and dC summed over
groups of heads before their products), float32 to ``csrc/ssd_bwd.cu``
(fp32 arithmetic on the CUDA cores).  `ssd_bwd` on CPU
tensors is the plain version, `ref.ssd_chunked_bwd` (autograd through
`ref.ssd_chunked`), which is also how a CPU call of `ssd` is
differentiated.  Every backward launch adds one to
``LAUNCHES["ssd_bwd"]`` and to ``LAUNCHES["ssd_bwd_bf16"]`` or
``["ssd_bwd_fp32"]``.

On the ``meta`` device (the dry run's) both take the CUDA route's checks
and its autograd, return outputs of the right shapes and types, compute
nothing and launch nothing.  On every device each call tells the op
counters its dot FLOPs (`flops`, `bwd_flops`; `kernels.kernel_work`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import count_launch, kernel_work, tensor_bytes
from .._build import load
from .ref import ssd_chunked, ssd_chunked_bwd

_NAME = "ssd"
_TC = "ssd_tc"     # the bf16 stages' library
_BWD = "ssd_bwd"   # the fp32 backward's library
_BWD_TC = "ssd_bwd_tc"   # the bf16 backward's library
# ssd_bwd_tc.cu's kGroup (heads whose dB and dC one block sums) and
# kTermsH, kTermsDS (bf16 terms of the states H and dS it reads).
_TC_GROUP, _TC_TERMS_H, _TC_TERMS_DS = 8, 2, 2
_DTYPES = (torch.float32, torch.bfloat16)


def flops(shape, n: int, chunk: int) -> float:
    """The dot FLOPs of the plain scan (`ref.ssd_chunked`) on x of
    ``shape`` (B, S, H, P) with state N: S padded to whole chunks of L,
    its four products per chunk and head, C B^T (L x L x N), the gated
    scores times x (L x L x P), the chunk state (P x N x L) and C times
    the carried state (L x P x N), 2 FLOPs a multiply-add."""
    bsz, s, h, p = shape
    nc = -(-s // chunk)
    return 2.0 * bsz * nc * h * chunk * (chunk * n + chunk * p + 2 * p * n)


def bwd_flops(shape, n: int, chunk: int) -> float:
    """The dot FLOPs of the scan's backward given its forward: each of
    the four products gives two (one a gradient of each operand), so
    twice `flops`.  (`ref.ssd_chunked_bwd` also reruns the forward
    first; that is the forward's count, not the backward's.)"""
    return 2.0 * flops(shape, n, chunk)


def _check(x, dt, a_log, b, c) -> None:
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b", b),
                    ("c", c)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or \
            b.dim() != 4 or c.dim() != 4:
        raise ValueError("ssd takes x (B,S,H,P), dt (B,S,H), a_log (H,), "
                         "b and c (B,S,G,N)")
    bsz, s, h, _ = x.shape
    if tuple(dt.shape) != (bsz, s, h) or a_log.shape[0] != h:
        raise ValueError(f"dt {tuple(dt.shape)} or a_log "
                         f"{tuple(a_log.shape)} disagree with x "
                         f"{tuple(x.shape)}")
    if b.shape != c.shape or tuple(b.shape[:2]) != (bsz, s) or \
            b.shape[2] == 0 or h % b.shape[2]:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} "
                         f"disagree with x {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{_NAME} runs on cpu, cuda or meta, not "
                         f"{x.device}")


def _work(x, dt, a_log, b, c, chunk: int) -> tuple[float, int]:
    """(dot FLOPs, bytes: the inputs, y and the fp32 final state)."""
    bsz, _, h, p = x.shape
    n = b.shape[3]
    return flops(x.shape, n, chunk), (tensor_bytes(x, dt, a_log, b, c) +
                                      tensor_bytes(x) + 4 * bsz * h * p * n)


def _launcher(bf16: bool):
    fn = load(_TC).ssd_tc_launch if bf16 else load(_NAME).ssd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd(x, dt, a_log, b, c, *, chunk: int = 64):
    """Chunked SSD scan; see the module docstring for shapes."""
    _check(x, dt, a_log, b, c)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, not {chunk}")
    if x.device.type == "cpu":
        with kernel_work(_NAME, lambda: _work(x, dt, a_log, b, c, chunk)):
            return ssd_chunked(x, dt, a_log, b, c, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_log, b, c)):
        return _SSD.apply(x, dt, a_log, b, c, chunk)
    return _forward(x, dt, a_log, b, c, chunk)


def _check_cuda(x, dt, a_log, b, c, chunk: int) -> None:
    """What the CUDA kernels (forward and backward) take."""
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, b, c)):
        raise TypeError(f"{_NAME} takes x, dt, b and c of one type, "
                        f"float32 or bfloat16; got {x.dtype}, {dt.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if a_log.dtype != torch.float32:
        raise TypeError(f"a_log must be float32, not {a_log.dtype}")
    if b.shape[2] != 1:
        raise ValueError(f"the {_NAME} kernel takes one group, as the TPU "
                         f"kernel does, not {b.shape[2]}")
    bsz, s, h, p = x.shape
    n = b.shape[3]
    if n > 128 or chunk > 1024:
        raise ValueError(f"the {_NAME} kernel takes N <= 128 and chunks "
                         f"<= 1024, not N = {n}, chunk = {chunk}")
    if max(bsz, s, h, p) >= 2**31:
        raise ValueError(f"{_NAME}: a size is out of range")
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b", b),
                    ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward(x, dt, a_log, b, c, chunk: int):
    """The forward kernels on CUDA tensors: (y, final state); on meta
    tensors the outputs only."""
    _check_cuda(x, dt, a_log, b, c, chunk)
    with kernel_work(_NAME, lambda: _work(x, dt, a_log, b, c, chunk)):
        return _launch(x, dt, a_log, b, c, chunk)


def _launch(x, dt, a_log, b, c, chunk: int):
    bsz, s, h, p = x.shape
    n = b.shape[3]
    y = torch.empty_like(x)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if x.is_meta or (y.numel() == 0 and fin.numel() == 0):
        return y, fin
    bf16 = x.dtype == torch.bfloat16
    # Scratch of the stages: cum per chunk and head, the chunk states,
    # and the state before each chunk as the split terms the last stage
    # reads (three bf16 terms; two TF32 terms, hi and lo, held in fp32).
    nc = -(-s // chunk)
    cum = torch.empty((bsz, nc, h, chunk), dtype=torch.float32,
                      device=x.device)
    st = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                     device=x.device)
    prev = torch.empty((3 if bf16 else 2, bsz, nc, h, p, n), dtype=x.dtype,
                       device=x.device)
    ptrs = [t.data_ptr() for t in (x, dt, a_log, b, c, y, fin, cum, st,
                                   prev)]
    # cp.async moves 16 bytes: P and N multiples of 8 bf16 or 4 fp32
    # values, from 16-byte aligned bases; otherwise plain loads.
    per16 = 16 // x.element_size()
    vec = int(p % per16 == 0 and n % per16 == 0 and
              all(q % 16 == 0 for q in ptrs))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(bf16)(*ptrs, bsz, s, h, p, n, chunk, vec, stream)
    route = "bf16" if bf16 else "fp32"
    if err != 0:
        raise RuntimeError(f"{_NAME} ({route}) launch failed: "
                           f"CUDA error {err}")
    count_launch(_NAME, route)
    return y, fin


class _SSD(torch.autograd.Function):
    """`ssd` on CUDA tensors under autograd: the forward kernels, then
    the backward kernel on the saved inputs (`ssd_bwd`).  An output whose
    gradient is not needed passes None: dy then is zeros, and a missing
    d_final is zero in the kernel."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c)
        ctx.chunk = chunk
        return _forward(x, dt, a_log, b, c, chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a_log, b, c = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_bwd(x, dt, a_log, b, c, dy, d_final, chunk=ctx.chunk)
        return (*grads, None)


def _bwd_launcher(bf16: bool):
    if bf16:
        fn = load(_BWD_TC).ssd_bwd_tc_launch
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    else:
        fn = load(_BWD).ssd_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_bwd(x, dt, a_log, b, c, dy, d_final=None, *, chunk: int = 64):
    """The gradients of `ssd`'s (y, final state) on x, dt, a_log, b and c
    given ``dy`` (x's shape) and ``d_final`` ((B, H, P, N), or None for
    zero): (dx, ddt, d_a_log, db, dc), each in its input's type.  CPU
    tensors take `ref.ssd_chunked_bwd`; CUDA tensors the backward kernels
    of their dtype, or the call raises; meta tensors the CUDA route's
    checks, and outputs only."""
    _check(x, dt, a_log, b, c)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, not {chunk}")
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} disagrees "
                         f"with x {tuple(x.shape)} on {x.device}")
    bsz, s, h, p = x.shape
    n = b.shape[3]
    if d_final is not None and (
            tuple(d_final.shape) != (bsz, h, p, n) or
            d_final.device != x.device):
        raise ValueError(f"d_final {tuple(d_final.shape)} disagrees with "
                         f"the state {(bsz, h, p, n)}")
    def work():
        # Bytes: the inputs, and the gradients (a_log's in fp32).
        return (bwd_flops(x.shape, n, chunk),
                tensor_bytes(x, dt, a_log, b, c, dy, d_final) +
                tensor_bytes(x, dt, b, c) + 4 * h)
    if x.device.type == "cpu":
        with kernel_work(_BWD, work):
            return ssd_chunked_bwd(x, dt, a_log, b, c, dy, d_final,
                                   chunk=chunk)
    _check_cuda(x, dt, a_log, b, c, chunk)
    with kernel_work(_BWD, work):
        return _launch_bwd(x, dt, a_log, b, c, dy, d_final, chunk)


def _launch_bwd(x, dt, a_log, b, c, dy, d_final, chunk: int):
    bsz, s, h, p = x.shape
    n = b.shape[3]
    if x.is_meta:
        return (torch.empty_like(x), torch.empty_like(dt),
                torch.empty((h,), dtype=torch.float32, device=x.device),
                torch.empty_like(b), torch.empty_like(c))
    dy = dy.to(x.dtype).contiguous()
    if d_final is not None:
        d_final = d_final.float().contiguous()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((h,), **f32)
    if x.numel() == 0:
        return dx, ddt, da.zero_(), db.zero_(), dc.zero_()
    nc = -(-s // chunk)
    bf16 = x.dtype == torch.bfloat16
    cum = torch.empty((bsz, nc, h, chunk), **f32)
    sc = torch.empty((4, bsz, nc, h, chunk), **f32)
    dap = torch.empty((bsz, nc, h), **f32)
    head = [x, dt, a_log, b, c, dy, d_final, dx, ddt, da, db, dc]
    if bf16:
        # Scratch: cum and dt in fp32; the chunk states S and R (dS is
        # written over R);
        # H and dS as bf16 terms; each warp's part of <dS, H>; the four
        # per-position sums; dB and dC per group of heads; each chunk's
        # part of d_a_log; a counter per head.
        ng = -(-h // _TC_GROUP)
        nw = 8 * -(-(p * n) // 256)
        sr = torch.empty((2, bsz, nc, h, p, n), **f32)
        planes = torch.empty((_TC_TERMS_H + _TC_TERMS_DS, bsz, nc, h, p, n),
                             dtype=x.dtype, device=dev)
        dhp = torch.empty((bsz * h, nc, nw), **f32)
        dbp = torch.empty((bsz, s, ng, n), **f32)
        dcp = torch.empty_like(dbp)
        cnt = torch.empty((h,), dtype=torch.int32, device=dev)
        scratch = [cum, torch.empty_like(cum), sr, planes[:_TC_TERMS_H],
                   planes[_TC_TERMS_H:], dhp, sc, dbp, dcp, dap, cnt]
    else:
        # Scratch: cum, the four per-position sums, the state before each
        # chunk and dS (written over the two chunk products), the per-head
        # dB and dC, and each chunk's part of d_a_log.
        hst = torch.empty((bsz, nc, h, p, n), **f32)
        dbp = torch.empty((bsz, s, h, n), **f32)
        scratch = [cum, hst, torch.empty_like(hst), dbp,
                   torch.empty_like(dbp), sc, dap]
    ptrs = [0 if t is None else t.data_ptr() for t in head + scratch]
    args = [bsz, s, h, p, n, chunk]
    if bf16:
        # cp.async moves 16 bytes: P and N multiples of 8 from 16-byte
        # aligned bases; otherwise plain loads.
        args.append(int(p % 8 == 0 and n % 8 == 0 and
                        all(q % 16 == 0 for q in ptrs if q)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher(bf16)(*ptrs, *args, stream)
    route = "bf16" if bf16 else "fp32"
    if err != 0:
        name = _BWD_TC if bf16 else _BWD
        raise RuntimeError(f"{name} ({route}) launch failed: CUDA error "
                           f"{err}")
    count_launch(_BWD, route)
    return dx, ddt, da, db, dc
