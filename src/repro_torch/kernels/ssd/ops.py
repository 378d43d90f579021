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
"""

from __future__ import annotations

import ctypes

import torch

from .. import count_launch
from .._build import load
from .ref import ssd_chunked

_NAME = "ssd"
_TC = "ssd_tc"     # the bf16 stages' library
_DTYPES = (torch.float32, torch.bfloat16)


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_NAME} runs on cpu or cuda, not {x.device}")


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
        return ssd_chunked(x, dt, a_log, b, c, chunk=chunk)
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
    y = torch.empty_like(x)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 and fin.numel() == 0:
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
