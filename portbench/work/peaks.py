"""The table of peaks: one NVIDIA H100 SXM5 80GB HBM3 at its 700 W
limit, as NVIDIA's datasheet gives them (dense, no sparsity).  Every
share of a peak or a roofline is stated against these at one rate,
whatever precision a kernel computes in."""

#: bf16 tensor-core FLOP/s.
PEAK_FLOPS = 989e12
#: HBM3 bytes/s.
PEAK_BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of work of ``flops`` operations and ``nbytes``
    bytes: the larger of the two at their peaks."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
