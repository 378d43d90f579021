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
                    up to 256 on both
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
                    shapes TMA cannot take), fp32 on the CUDA cores —
                    the port's counterpart of
                    ``jax.lax.ragged_dot`` in
                    ``repro/models/moe.py::moe_ffn``, an XLA operation
                    with no Pallas kernel behind it

A wrapper runs the plain version for tensors on the CPU and launches
its kernel for CUDA tensors, or raises; it never falls back.  Under
autograd on the card, ``ssd`` runs its backward kernel; ``flash_attention``
and ``ragged_dot`` have no backward kernel yet (ROADMAP Queue 2) and
raise rather than hand back results that carry no gradient.  Each
wrapper call that launches adds one to ``LAUNCHES[name]`` through
`count_launch`, so a run can show which kernels its path went through;
a kernel with more than one route also adds one to the route it took:
``LAUNCHES[name + "_bf16"]`` or ``LAUNCHES[name + "_fp32"]`` (flash
attention, the SSD scan and its backward), ``LAUNCHES["ragged_dot_wgmma"]``,
``["ragged_dot_mma"]`` or ``["ragged_dot_fp32"]``.  The counts are
exact when several threads launch: every update holds one lock.
"""

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
                             "ragged_dot_mma": 0, "ragged_dot_fp32": 0}


def count_launch(name: str, route: str | None = None) -> None:
    """Add one to ``LAUNCHES[name]`` and, with a ``route`` (the kernel
    that launched: "bf16" or "fp32", or ragged_dot's "wgmma", "mma" or
    "fp32"), to ``LAUNCHES[f"{name}_{route}"]``, under one lock (a
    ``+=`` on a dict entry is a read and a write that two threads can
    interleave)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if route is not None:
            LAUNCHES[f"{name}_{route}"] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
