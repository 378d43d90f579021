"""Peak rates of the tensor-core instructions that can carry
`selection_counts`, and of the two TF32 forms that can carry the fp32
kernels' split products, measured on the card (``csrc/mma_probe.cu``).

`mma_rates()` times each probe with CUDA events and returns, per
instruction, its operations per second (2 m n k an instruction, k in
bits for ``.b1``): the numbers that chose the ``.b1`` wgmma for
``csrc/selection_counts.cu``, and the TF32 rate that the fp32 kernels'
bounds take from the data sheet.  It measures and never runs on the main
path; it needs a CUDA GPU.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load

#: probe id -> (instruction, operations per instruction, instructions
#: per block and iteration: 8 warps x 8 chains for mma.sync, 2
#: warpgroups x 4 for wgmma).
PROBES = {
    0: ("mma.sync m16n8k256 .b1 .and.popc", 2 * 16 * 8 * 256, 64),
    1: ("mma.sync m16n8k32 .s8", 2 * 16 * 8 * 32, 64),
    2: ("wgmma m64n256k32 .s8", 2 * 64 * 256 * 32, 8),
    3: ("wgmma m64n256k256 .b1 .and.popc", 2 * 64 * 256 * 256, 8),
    4: ("mma.sync m16n8k8 .tf32", 2 * 16 * 8 * 8, 64),
    5: ("wgmma m64n256k8 .tf32", 2 * 64 * 256 * 8, 8),
}


def mma_rates(iters: int = 2000, device=None) -> dict[str, float]:
    """Instruction -> operations/s on ``device`` (default: the current
    CUDA device), each probe on 2 blocks an SM after a warm-up."""
    fn = load("mma_probe").mma_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda" if device is None else device)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    rates = {}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for which, (name, ops, per_block) in PROBES.items():
            for n in (10, iters):                 # warm-up, then timed
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                err = fn(which, sink.data_ptr(), n, blocks, stream)
                t1.record()
                if err != 0:
                    raise RuntimeError(f"mma probe {name}: CUDA error {err}")
                torch.cuda.synchronize(dev)
            seconds = t0.elapsed_time(t1) / 1e3
            rates[name] = ops * per_block * iters * blocks / seconds
    return rates
