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
- float32 x and w to the CUDA-core fp32 kernel (the fp32 compute
  mode's).

The kernels read the offsets on the card, so a call makes no host sync.
Every launch adds one to ``LAUNCHES["ragged_dot"]`` and one to the
route it took: ``LAUNCHES["ragged_dot_wgmma"]``,
``LAUNCHES["ragged_dot_mma"]`` or ``LAUNCHES["ragged_dot_fp32"]``.
There is no backward kernel yet (ROADMAP Queue 2): a CUDA call under
autograd (grad enabled and x or w requiring it) raises
`NotImplementedError`.

On the ``meta`` device (the dry run's) a call takes the CUDA route's
checks and returns an (M, N) output of x's type, computing nothing and
launching nothing; under autograd it is a `torch.autograd.Function` whose
backward gives gradients of x's and w's shapes and types.  On every
device each call tells the op counters its dot FLOPs (`flops`, twice that
for a meta backward; `kernels.kernel_work`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import count_launch, kernel_work, tensor_bytes
from .._build import load
from .ref import ragged_dot_ref

_NAME = "ragged_dot"
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
    if x.device.type == "cpu":
        with kernel_work(_NAME, lambda: _work(x, w, group_offsets)):
            return ragged_dot_ref(x, w, group_offsets)
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if grad and not x.is_meta:
        raise NotImplementedError(
            f"{_NAME} has no backward kernel yet (ROADMAP Queue 2: "
            f"ragged_dot's backward), so the moe family does not train on "
            f"the card")
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
    if grad:
        return _MetaRaggedDot.apply(x, w, group_offsets)
    with kernel_work(_NAME, lambda: _work(x, w, group_offsets)):
        return _launch(x, w, group_offsets, route)


def _launch(x, w, group_offsets, route):
    m, k = x.shape
    groups, _, n = w.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.is_meta or y.numel() == 0:
        return y
    w_fp32 = int(w.dtype == torch.float32)
    if x.dtype == torch.float32:
        if route is not None:
            raise ValueError(f"{_NAME}: float32 inputs take the fp32 "
                             f"kernel, not {route!r}")
        route = "fp32"
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
        else:
            # cp.async moves 16 bytes: whole rows of 8 bf16 from 16-byte
            # bases.
            vec = int(k % 8 == 0 and n % 8 == 0 and
                      all(p % 16 == 0 for p in (ptrs[0], ptrs[1], ptrs[3])))
            err = _launcher("ragged_dot_launch", 7)(
                *ptrs, m, k, n, groups, vec, int(route == "fp32"), w_fp32,
                stream)
    if err != 0:
        raise RuntimeError(f"{_NAME} ({route}) launch failed: "
                           f"error {err}")
    count_launch(_NAME, route)
    return y


class _MetaRaggedDot(torch.autograd.Function):
    """`ragged_dot` on meta tensors under autograd: the output, and in
    the backward the gradients of x and w, by shape only, counted at
    `flops` and twice that (dx = dy w^T and dw = x^T dy per group)."""

    @staticmethod
    def forward(ctx, x, w, group_offsets):
        ctx.save_for_backward(x, w, group_offsets)
        with kernel_work(_NAME, lambda: _work(x, w, group_offsets)):
            return torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                               device=x.device)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_offsets = ctx.saved_tensors
        with kernel_work(_NAME + "_bwd", lambda: (
                2 * _work(x, w, group_offsets)[0],
                2 * tensor_bytes(x, w) + tensor_bytes(dy, group_offsets))):
            return torch.empty_like(x), torch.empty_like(w), None
