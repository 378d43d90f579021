"""The checked wrapper for the grouped (ragged) matrix product kernel.

`ragged_dot(x, w, group_offsets)` takes x (M, K) with rows sorted by
group, w (G, K, N) and group_offsets (G + 1,) int32 (group g the rows
``[offsets[g], offsets[g + 1])``) and returns (M, N) in x's type, as
`ref.ragged_dot_ref`.  w is of x's type, or float32 with bfloat16 x:
the weights are then rounded to bfloat16 (to nearest even, as
``w.to(torch.bfloat16)``) as they are loaded, so the MoE FFN passes its
fp32 expert stacks as they are stored.  Any other pair of types raises.
Tensors on the CPU go to the plain version.  CUDA tensors go to
``csrc/ragged_dot.cu``, built at first use, or the call raises:

- bfloat16 x to the TMA + wgmma kernel (``ragged_dot_tc_kernel``), for
  K a multiple of 8, N a multiple of 4 (fp32 w) or 8 (bf16 w), x and w
  on 16 bytes and G <= 1024 (the model paths' shapes);
- other bfloat16 inputs to the mma.sync kernel (``ragged_dot_kernel``);
- float32 x and w (the fp32 compute mode's) to the TF32 tensor cores
  (``ragged_tf32_kernel`` in ``csrc/ragged_tf32.cuh``: TMA + wgmma,
  three TF32 products for each fp32 product, each 32-deep stage summed
  apart and joined to an fp32 total) where K and N are multiples of 4
  from 16-byte bases and G <= 1024 (`fp32_tc_route`: every model
  path's shape), else to the CUDA-core kernel (``ragged_dot_f32_kernel``).

The kernels read the offsets on the card, so a call makes no host sync.
Every launch adds one to ``LAUNCHES["ragged_dot"]`` and one to the
route it took: ``LAUNCHES["ragged_dot_wgmma"]``,
``LAUNCHES["ragged_dot_mma"]`` or ``LAUNCHES["ragged_dot_fp32"]``; an
fp32 launch also to its kernel's, ``["ragged_dot_fp32_tc"]`` or
``["ragged_dot_fp32_cores"]``.

Under autograd (grad enabled and x or w requiring it) a call is one
`torch.autograd.Function` on every device, whose backward is
`ragged_dot_bwd`: on the CPU the plain version
(`ref.ragged_dot_bwd_ref`), on the card the two kernels of
``csrc/ragged_dot_bwd.cu`` (``ragged_dot_dx``: dx = dy w[g]^T,
``ragged_dot_dw``: dw[g] = x[rows_g]^T dy[rows_g]): bf16 x on TMA and
wgmma where K and N are multiples of 8 from 16-byte bases (`bwd_tc_route`:
every model path's shape), on mma.sync elsewhere (fp32 weights rounded
on load, dw rounded to bf16 and written in w's type); fp32 on the TF32
tensor cores where `fp32_tc_route` allows (dx the forward's kernel, dw
with dy transposed into K-major panels as it lands), on the CUDA cores
elsewhere.  Each backward call adds one to ``LAUNCHES["ragged_dot_bwd"]``
and to ``["ragged_dot_bwd_bf16"]`` or ``["ragged_dot_bwd_fp32"]``, and to
its kernels' route: ``["ragged_dot_bwd_wgmma"]`` or
``["ragged_dot_bwd_mma"]`` (bf16), ``["ragged_dot_bwd_fp32_tc"]`` or
``["ragged_dot_bwd_fp32_cores"]`` (fp32).

On the ``meta`` device (the dry run's) a call takes the CUDA route's
checks and returns outputs of the right shapes and types, computing
nothing and launching nothing, its backward too.  On every device each
call tells the op counters its dot FLOPs (`flops`, and twice that for the
backward; `kernels.kernel_work`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import count_launch, kernel_work, tensor_bytes
from .._build import load
from .ref import ragged_dot_bwd_ref, ragged_dot_ref

_NAME = "ragged_dot"
_BWD = "ragged_dot_bwd"   # the backward's library and launch count
#: (x's type, w's types) the wrapper takes.
_PAIRS = {torch.float32: (torch.float32,),
          torch.bfloat16: (torch.bfloat16, torch.float32)}
#: The most groups the TMA route takes (``tc::kMaxGroups``).
TC_MAX_GROUPS = 1024


def flops(m: int, k: int, n: int) -> float:
    """The dot FLOPs of the grouped product of x (M, K) by w (G, K, N):
    2 M K N, every row once through its group's weights (XLA's count of
    a ``ragged-dot``).  The plain version counts the rows its offsets
    cover, which is all M on the MoE FFN's path."""
    return 2.0 * m * k * n


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
    if w.dtype != x.dtype and w.dtype not in _PAIRS.get(x.dtype, ()):
        raise TypeError(f"x is {x.dtype}, w is {w.dtype}: w must be of "
                        f"x's type, or float32 with bfloat16 x")
    if group_offsets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group_offsets must be int32 or int64, not "
                        f"{group_offsets.dtype}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{_NAME} runs on cpu, cuda or meta, not "
                         f"{x.device}")


def _work(x, w, group_offsets) -> tuple[float, int]:
    """(dot FLOPs, bytes: the inputs and the (M, N) output)."""
    m, k = x.shape
    n = w.shape[2]
    return flops(m, k, n), (tensor_bytes(x, w, group_offsets)
                            + m * n * x.element_size())


def _launcher(symbol: str, n_ints: int):
    fn = getattr(load(_NAME), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fp32_tc_route(k: int, n: int, groups: int, ptrs) -> bool:
    """Whether an fp32 call (forward, dx or dw) takes the TF32
    tensor-core kernels: TMA copies rows of whole 16-byte units (K and N
    multiples of 4) from 16-byte bases (``ptrs``: the operands' and the
    outputs' addresses), and a block keeps at most `TC_MAX_GROUPS` group
    edges (``tf::takes``)."""
    return (k % 4 == 0 and n % 4 == 0 and groups <= TC_MAX_GROUPS
            and all(p % 16 == 0 for p in ptrs))


def tc_route(x, w) -> bool:
    """Whether a bfloat16 call takes the TMA + wgmma kernel: TMA copies
    rows of whole 16-byte units from 16-byte bases."""
    k, n = x.shape[1], w.shape[2]
    w_units = 16 // w.element_size()
    return (k % 8 == 0 and n % w_units == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and w.shape[0] <= TC_MAX_GROUPS)


def ragged_dot(x, w, group_offsets, *, route: str | None = None):
    """The grouped product (see the module docstring).  ``route``
    ("wgmma" or "mma") names the bf16 kernel a CUDA call must take, for
    comparing the two; a shape the named kernel cannot take raises.  By
    default the TMA kernel takes every shape it can."""
    _check(x, w, group_offsets)
    if route not in (None, "wgmma", "mma"):
        raise ValueError(f"route must be None, 'wgmma' or 'mma', not "
                         f"{route!r}")
    if x.device.type != "cpu":
        _check_cuda(x, w, group_offsets)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RaggedDot.apply(x, w, group_offsets, route)
    return _forward(x, w, group_offsets, route)


def _check_cuda(x, w, group_offsets) -> None:
    """What the CUDA kernels (forward and backward) take."""
    if x.dtype not in _PAIRS:
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


def _forward(x, w, group_offsets, route):
    with kernel_work(_NAME, lambda: _work(x, w, group_offsets)):
        if x.device.type == "cpu":
            return ragged_dot_ref(x, w, group_offsets)
        return _launch(x, w, group_offsets, route)


def _launch(x, w, group_offsets, route):
    m, k = x.shape
    groups, _, n = w.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.is_meta or y.numel() == 0:
        return y
    w_fp32 = int(w.dtype == torch.float32)
    fp32 = x.dtype == torch.float32
    if fp32:
        if route is not None:
            raise ValueError(f"{_NAME}: float32 inputs take the fp32 "
                             f"kernels, not {route!r}")
        route = "fp32_tc" if fp32_tc_route(
            k, n, groups, (x.data_ptr(), w.data_ptr(), y.data_ptr())) \
            else "fp32_cores"
    elif route is None:
        route = "wgmma" if tc_route(x, w) else "mma"
    elif route == "wgmma" and not tc_route(x, w):
        raise ValueError(f"{_NAME}: the TMA kernel cannot take x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)} "
                         f"{w.dtype} at these addresses")
    ptrs = (x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(),
            y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = _launcher("ragged_dot_tc_launch", 5)(
                *ptrs, m, k, n, groups, w_fp32, stream)
        elif route == "fp32_tc":
            err = _launcher("ragged_dot_tf32_launch", 4)(
                *ptrs, m, k, n, groups, stream)
        else:
            # cp.async moves 16 bytes: whole rows of 8 bf16 from 16-byte
            # bases.
            vec = int(k % 8 == 0 and n % 8 == 0 and
                      all(p % 16 == 0 for p in (ptrs[0], ptrs[1], ptrs[3])))
            err = _launcher("ragged_dot_launch", 7)(
                *ptrs, m, k, n, groups, vec, int(fp32), w_fp32, stream)
    if err != 0:
        raise RuntimeError(f"{_NAME} ({route}) launch failed: "
                           f"error {err}")
    count_launch(_NAME, *(("fp32", route) if fp32 else (route,)))
    return y


class _RaggedDot(torch.autograd.Function):
    """`ragged_dot` under autograd, on every device: the forward above,
    and `ragged_dot_bwd` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, group_offsets, route):
        ctx.save_for_backward(x, w, group_offsets)
        return _forward(x, w, group_offsets, route)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_offsets = ctx.saved_tensors
        dx, dw = ragged_dot_bwd(x, w, group_offsets, dy)
        need_x, need_w = ctx.needs_input_grad[:2]
        return dx if need_x else None, dw if need_w else None, None, None


def _bwd_launcher(symbol: str, n_ints: int):
    fn = getattr(load(_BWD), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ragged_dot_bwd(x, w, group_offsets, dy):
    """The gradients of `ragged_dot` on x and w given ``dy`` (M, N):
    (dx in x's type, dw in w's type), as `ref.ragged_dot_bwd_ref`.  CPU
    tensors take that plain version; CUDA tensors the two kernels of
    ``csrc/ragged_dot_bwd.cu``, or the call raises; meta tensors the
    CUDA route's checks, and outputs only."""
    _check(x, w, group_offsets)
    m, n = x.shape[0], w.shape[2]
    if not isinstance(dy, torch.Tensor) or tuple(dy.shape) != (m, n) or \
            dy.device != x.device:
        raise ValueError(f"dy must be ({m}, {n}) on {x.device}")

    def work():
        # Bytes: x, w, dy and the offsets read, dx and dw written.
        return (2 * _work(x, w, group_offsets)[0],
                2 * tensor_bytes(x, w) + tensor_bytes(dy, group_offsets))
    if x.device.type == "cpu":
        with kernel_work(_BWD, work):
            return ragged_dot_bwd_ref(x, w, group_offsets, dy)
    _check_cuda(x, w, group_offsets)
    with kernel_work(_BWD, work):
        return _launch_bwd(x, w, group_offsets, dy)


def bwd_tc_route(x, w, dy) -> bool:
    """Whether a bfloat16 backward takes the TMA + wgmma kernels: TMA
    copies rows of whole 16-byte units of x, dy and w from 16-byte
    bases."""
    k, n = x.shape[1], w.shape[2]
    return (k % 8 == 0 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
            and w.shape[0] <= TC_MAX_GROUPS)


def _launch_bwd(x, w, group_offsets, dy, *, parts: int = 3):
    """(dx, dw): both kernels (``parts`` 3), or the dx kernel alone (1)
    or the dw kernel alone (2), for timing each (the one not launched is
    left unwritten).  bf16 x takes the TMA + wgmma kernels where
    `bwd_tc_route` allows, else the mma.sync ones; fp32 x the TF32
    tensor-core kernels where `fp32_tc_route` allows, else the CUDA
    cores."""
    m, k = x.shape
    groups, _, n = w.shape
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.is_meta:
        return dx, dw
    dy = dy.to(x.dtype).contiguous()
    fp32 = x.dtype == torch.float32
    ptrs = (x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw.data_ptr())
    x_p, w_p, o_p, dy_p, dx_p, dw_p = ptrs
    if fp32:
        route = "fp32_tc" if fp32_tc_route(
            k, n, groups, (x_p, w_p, dy_p, dx_p, dw_p)) else "fp32_cores"
    else:
        route = "wgmma" if bwd_tc_route(x, w, dy) else "mma"
    w_fp32 = int(w.dtype == torch.float32)
    err = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "fp32_tc":
            if parts & 1:
                err = _bwd_launcher("ragged_dot_dx_tf32_launch", 4)(
                    dy_p, w_p, o_p, dx_p, m, k, n, groups, stream)
            if err == 0 and parts & 2:
                err = _bwd_launcher("ragged_dot_dw_tf32_launch", 4)(
                    x_p, dy_p, o_p, dw_p, m, k, n, groups, stream)
        elif route == "wgmma":
            if parts & 1:
                err = _bwd_launcher("ragged_dot_dx_tc_launch", 5)(
                    dy_p, w_p, o_p, dx_p, m, k, n, groups, w_fp32, stream)
            if err == 0 and parts & 2:
                err = _bwd_launcher("ragged_dot_dw_tc_launch", 5)(
                    x_p, dy_p, o_p, dw_p, m, k, n, groups, w_fp32, stream)
        else:
            # cp.async moves 16 bytes: rows of whole chunks of 8 from
            # 16-byte bases (fp32 weights then load as pairs of float4).
            vec = int(k % 8 == 0 and n % 8 == 0 and
                      all(p % 16 == 0 for p in ptrs))
            args = (m, k, n, groups, vec, int(fp32), w_fp32)
            if parts & 1:
                err = _bwd_launcher("ragged_dot_dx_launch", 7)(
                    dy_p, w_p, o_p, dx_p, *args, stream)
            if err == 0 and parts & 2:
                err = _bwd_launcher("ragged_dot_dw_launch", 7)(
                    x_p, dy_p, o_p, dw_p, *args, stream)
    kind = "fp32" if fp32 else "bf16"
    if err != 0:
        raise RuntimeError(f"{_BWD} ({kind}, {route}) launch failed: "
                           f"error {err}")
    if parts == 3:
        count_launch(_BWD, kind, route)
    return dx, dw
