"""CnKm kernel-loop DFG generators (paper §IV-A).

In every iteration a CnKm kernel consumes n input-channel data and produces
m output-channel data; each of the n channel data is spatially reused by the
m kernels.  The computing body is the MAC lattice

    acc[j] = sum_i  in[i] * w[i][j]        (j = 0..m-1)

with the weights held in LRFs (temporal reuse — only the *input* data is the
high-spatial-reuse case the paper targets), giving:

- n VIOs, each with RD = m (consumed by the m MACs of its column),
- n*m computing MAC ops, chained over i within each output channel j,
- m VOOs (RD = 1) fed by the last MAC of each chain.
"""

from __future__ import annotations

from .dfg import DFG, OpKind

# The seven kernels evaluated in the paper's Fig. 5.  The text names C2K4,
# C3K6 and C5K5; the remaining four are chosen to cover the m<=4 / m>4 split
# the figure shows (see DESIGN.md §3).
PAPER_KERNELS: list[tuple[int, int]] = [
    (1, 2), (2, 4), (2, 6), (3, 6), (4, 4), (2, 8), (5, 5),
]

# Extra kernels beyond the paper's seven: heavier packing stress (C4K8,
# C3K8) and a port-starved case (C8K6) where even BandMap's allocation
# falls back to routing PEs (Q < ceil(RD/M)).
EXTRA_KERNELS: list[tuple[int, int]] = [(4, 8), (3, 8), (8, 6)]


def cnkm_name(n: int, m: int) -> str:
    return f"C{n}K{m}"


def make_cnkm(n: int, m: int) -> DFG:
    """Build the CnKm DFG described above."""
    d = DFG()
    vins = [d.add_op(OpKind.VIN, f"in{i}") for i in range(n)]
    # mac[i][j]: consumes in[i]; chained over i per output channel j.
    mac = [[d.add_op(OpKind.COMPUTE, f"mac{i}_{j}") for j in range(m)]
           for i in range(n)]
    for i in range(n):
        for j in range(m):
            d.add_edge(vins[i], mac[i][j])
            if i > 0:
                d.add_edge(mac[i - 1][j], mac[i][j])
    vouts = [d.add_op(OpKind.VOUT, f"out{j}") for j in range(m)]
    for j in range(m):
        d.add_edge(mac[n - 1][j], vouts[j])
    return d


def all_paper_kernels() -> dict[str, DFG]:
    return {cnkm_name(n, m): make_cnkm(n, m) for n, m in PAPER_KERNELS}
