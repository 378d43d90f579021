"""Hand-written CUDA kernels for the port, one package per kernel, each
with ``csrc/`` (the CUDA source), ``ref.py`` (its plain torch version)
and ``ops.py`` (the checked wrapper):

- sbts_step/        ``selection_counts``: |N(v) ∩ S_k| by AND +
                    popcount over packed words — the device SBTS
                    engine's conflict counts, on the tensor cores'
                    .b1 wgmma (replaces
                    ``repro/kernels/sbts_step/kernel.py::selection_counts_pallas``);
                    ``probe.mma_rates`` times the four MMA instructions
                    that could carry it and the two TF32 forms the fp32
                    kernels below could take (``csrc/mma_probe.cu``)
- conflict_matrix/  ``conflict_matrix`` and ``conflict_matrix_packed``:
                    the conflict graph's occupancy/clique predicate
                    over every vertex pair, as a dense int8 matrix (the
                    pair predicate) and as packed bitset words (the OR
                    of each row's two group masks) — behind
                    ``build_conflict_graph(use_kernel="packed-cuda")``
                    (replace ``conflict_matrix_pallas`` and
                    ``conflict_matrix_packed_pallas`` of
                    ``repro/kernels/conflict_matrix/kernel.py``)
- flash_attention/  ``flash_attention``: forward GQA attention, causal
                    from ``q_offset``, optional sliding window — the
                    no-cache forward's shared-attention block on long
                    prompts (replaces
                    ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``).
                    Two routes by dtype, both on the tensor cores: bf16
                    to ``flash_attention_tc.cu`` (wgmma), fp32 to
                    ``flash_attention.cu`` (split-TF32 operands,
                    3xTF32: wgmma up to D = 64; past it P V on
                    mma.sync, S in fp32 on the CUDA cores); head dims
                    up to 256 on both; and its backward,
                    ``flash_attention_bwd`` (the dq kernel, then the
                    dk/dv kernel: wgmma for bf16, S and dP once per
                    tile pair and block up to D = 256; the CUDA cores
                    for fp32), fed the forward's row LSE, the training
                    path's past 4096^2 (query, key) pairs
- ssd/              ``ssd``: the Mamba2 SSD chunked scan — every Mamba2
                    layer's prefill (replaces
                    ``repro/kernels/ssd/kernel.py::ssd_pallas``).  Two
                    routes by dtype, each three chunk-parallel stages on
                    the tensor cores: bf16 to ``ssd_tc.cu`` (mma.sync,
                    split-bf16 operands), fp32 to ``ssd.cu`` (split-TF32
                    operands, 3xTF32; mma.sync, and wgmma for the last
                    stage up to N = 64); and ``ssd_bwd``, its backward,
                    behind ``ssd``'s autograd on the card — the training
                    path's (no TPU kernel: the reference differentiates
                    the plain scan): bf16 to ``ssd_bwd_tc.cu`` (five
                    kernels, mma.sync, split-bf16 operands, dB and dC
                    summed over head groups before their products),
                    fp32 to ``ssd_bwd.cu`` (the CUDA cores).  CPU tests
                    hold a plain-torch model of the bf16 design to
                    ``jax.vjp`` (``tests/test_torch_ssd.py``); the card
                    tests (``-m gpu tests/test_torch_gpu.py -k
                    ssd_bwd``) hold both routes to autograd through
                    the plain scan
- ragged_dot/       ``ragged_dot``: the grouped matrix product of the
                    MoE FFN (rows sorted by expert, each expert's rows
                    times its own weights), with the group offsets read
                    on the card: bf16 x on TMA and wgmma (fp32 or bf16
                    weights, rounded to bf16 on load; mma.sync for
                    shapes TMA cannot take), fp32 on TMA and TF32 wgmma
                    (3xTF32, ``csrc/ragged_tf32.cuh``; the CUDA cores
                    for shapes TMA cannot take) —
                    the port's counterpart of
                    ``jax.lax.ragged_dot`` in
                    ``repro/models/moe.py::moe_ffn``, an XLA operation
                    with no Pallas kernel behind it; and its backward,
                    ``ragged_dot_bwd`` (dx and dw on TMA and wgmma for
                    bf16 x, mma.sync for shapes TMA cannot take; for
                    fp32 on TF32 wgmma, the CUDA cores for shapes TMA
                    cannot take), the training path's

A wrapper runs the plain version for tensors on the CPU and launches
its kernel for CUDA tensors, or raises; it never falls back.  Under
autograd each of ``ssd``, ``flash_attention`` and ``ragged_dot`` is one
`torch.autograd.Function` whose backward runs its backward kernels on
the card (``ssd_bwd``; flash's dq and dk/dv kernels in
``flash_attention/csrc/flash_attention_bwd.cu``; the grouped product's
dx and dw kernels in ``ragged_dot/csrc/ragged_dot_bwd.cu``), each
counted as ``LAUNCHES[name + "_bwd"]`` and its route, and the plain
backward on the CPU.  Each
wrapper call that launches adds one to ``LAUNCHES[name]`` through
`count_launch`, so a run can show which kernels its path went through;
a kernel with more than one route also adds one to the route it took:
``LAUNCHES[name + "_bf16"]`` or ``LAUNCHES[name + "_fp32"]`` (flash
attention, the SSD scan and the three backwards),
``LAUNCHES["ragged_dot_wgmma"]``, ``["ragged_dot_mma"]`` or
``["ragged_dot_fp32"]`` (an fp32 launch also to
``["ragged_dot_fp32_tc"]`` or ``["ragged_dot_fp32_cores"]``, the TF32
tensor cores or the CUDA cores), and ``ragged_dot_bwd`` to
``["ragged_dot_bwd_wgmma"]`` or ``["ragged_dot_bwd_mma"]`` (bf16),
``["ragged_dot_bwd_fp32_tc"]`` or ``["ragged_dot_bwd_fp32_cores"]``
(fp32) besides.  The counts are
exact when several threads launch: every update holds one lock.

A wrapper also tells the op counters of `launch.op_analysis` what its
kernel does (`kernel_work`), on every device: a kernel launched through
``ctypes`` is seen by no dispatch mode, and on the ``meta`` device (the
dry run's) a wrapper returns outputs of the right shapes and types and
computes nothing.  The count is a stated formula, the dot FLOPs of the
kernel's plain version (``flops`` in each ``ops.py``), and the ops the
wrapper runs inside (the plain version on the CPU, scratch on the card)
are not counted again.  A meta call launches nothing and adds nothing to
``LAUNCHES``.
"""

import contextlib
import threading

_COUNT_LOCK = threading.Lock()

#: kernel name -> launches since the last `reset_launches`.
LAUNCHES: dict[str, int] = {"selection_counts": 0, "conflict_matrix": 0,
                             "conflict_matrix_packed": 0,
                             "flash_attention": 0,
                             "flash_attention_bf16": 0,
                             "flash_attention_fp32": 0,
                             "ssd": 0, "ssd_bf16": 0, "ssd_fp32": 0,
                             "ssd_bwd": 0, "ssd_bwd_bf16": 0,
                             "ssd_bwd_fp32": 0,
                             "ragged_dot": 0, "ragged_dot_wgmma": 0,
                             "ragged_dot_mma": 0, "ragged_dot_fp32": 0,
                             "ragged_dot_fp32_tc": 0,
                             "ragged_dot_fp32_cores": 0,
                             "ragged_dot_bwd": 0, "ragged_dot_bwd_bf16": 0,
                             "ragged_dot_bwd_fp32": 0,
                             "ragged_dot_bwd_wgmma": 0,
                             "ragged_dot_bwd_mma": 0,
                             "ragged_dot_bwd_fp32_tc": 0,
                             "ragged_dot_bwd_fp32_cores": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bwd_bf16": 0,
                             "flash_attention_bwd_fp32": 0}


def count_launch(name: str, *routes: str) -> None:
    """Add one to ``LAUNCHES[name]`` and to ``LAUNCHES[f"{name}_{route}"]``
    for each of ``routes`` (the kernel that launched: "bf16" or "fp32",
    ragged_dot's "wgmma", "mma" or "fp32" with "fp32_tc" or "fp32_cores",
    or both of its backward's: "bf16" and "wgmma" or "mma", "fp32" and
    "fp32_tc" or "fp32_cores"), under one lock (a ``+=`` on a dict entry
    is a read and a write that two threads can interleave)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        for route in routes:
            LAUNCHES[f"{name}_{route}"] += 1


#: The op counters counting now (`launch.op_analysis.OpCounter`), each
#: with ``kernel_begin(name, flops, nbytes)`` and ``kernel_end()``.
COUNTERS: list = []


_NOT_COUNTING = contextlib.nullcontext()


def kernel_work(name: str, work):
    """Around a wrapper's work: each active op counter counts one call of
    kernel ``name`` at ``work()``'s (dot FLOPs, bytes: its inputs read
    once and its outputs written once), and none of the ops run inside.
    With no counter active (serving and training) a call costs one check
    of `COUNTERS`, and ``work`` is not called."""
    if not COUNTERS:
        return _NOT_COUNTING
    return _counted(name, *work())


@contextlib.contextmanager
def _counted(name: str, flops: float, nbytes: float):
    with _COUNT_LOCK:
        counters = list(COUNTERS)
    for c in counters:
        c.kernel_begin(name, flops, nbytes)
    try:
        yield
    finally:
        for c in reversed(counters):
            c.kernel_end()


#: The rows a plain product on the CPU takes at a time (`row_blocks`).
ROW_BLOCK = 64


def row_blocks(fn, a, dim: int = 0, out: int = 0):
    """``fn(a)``, a product whose rows are ``a``'s entries along ``dim``
    (the result's along ``out``), on the CPU in blocks of exactly
    `ROW_BLOCK` rows, the last zero-padded.  torch's float32 GEMM on the
    CPU picks its kernel and its blocking by the row count, so one
    product over all the rows sums a row in another order with other
    rows beside it (a decode step's few rows against the no-cache
    forward's many: a bf16 ulp of deepseek's logits at K = 2048, where
    XLA's CPU dot sums each row alike; tests/test_torch_decode_drift.py);
    within one block shape it does not.  Up to K = 512 a block gives the
    bits of one product over all the rows but a lone row's (torch's
    gemv), so the smoke configs' values stand.  On other devices, and
    under a dispatch mode (an op or FLOP counter, to which the padding
    would add rows), ``fn(a)``."""
    import torch
    from torch.utils._python_dispatch import is_in_torch_dispatch_mode
    if a.device.type != "cpu" or is_in_torch_dispatch_mode():
        return fn(a)
    n = a.shape[dim]
    pad = -n % ROW_BLOCK
    if pad:
        shape = list(a.shape)
        shape[dim] = pad
        a = torch.cat([a, a.new_zeros(shape)], dim)
    return torch.cat([fn(blk) for blk in a.split(ROW_BLOCK, dim)],
                     out).narrow(out, 0, n)


def tensor_bytes(*tensors) -> int:
    """The bytes of ``tensors`` (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
