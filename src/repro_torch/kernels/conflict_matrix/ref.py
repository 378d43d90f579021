"""Oracle and plain torch versions of the conflict-matrix kernels — the
O(|V_C|²) hot spot of the paper's own pipeline (phase 3a).

A candidate vertex is encoded as 8 int32 features (see ``encode`` /
core/conflict.py):

  kind   0=TIN 1=TOUT 2=QUAD
  op     op id (clique rule: one candidate per op)
  m      modulo slot
  port   tin: IPORT row / tout: OPORT col / quad: -1
  pe_r, pe_c                     (quad only, else -1)
  mode   tin: 0 bus, 1 grf       (else -1)
  drive  quad routing: 0 none, 1 row, 2 col

Pairwise conflict (the dense occupancy/clique part — dependency-edge
realizability is sparse and handled host-side):

  same_op:    op_i == op_j                                   (i != j)
  iport:      both TIN  & port equal & m equal
  oport:      both TOUT & port equal & m equal
  pe:         both QUAD & pe equal   & m equal

`conflict_matrix_ref` is the reference's numpy oracle.  The two
``*_plain`` functions are the plain torch versions of the CUDA kernels
(``csrc/conflict_matrix.cu``): the same broadcast compares, on any
device, with the kernels' output layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitset import n_words, pack_words

TIN, TOUT, QUAD = 0, 1, 2
N_FEATURES = 8


def encode(vertices) -> np.ndarray:
    """core.conflict.Vertex list -> (n, 8) int32 feature matrix."""
    from repro_torch.core.conflict import QUAD as QS
    from repro_torch.core.conflict import TIN as TS
    from repro_torch.core.conflict import TOUT as OS
    from repro_torch.core.tec import ROW
    kind_map = {TS: TIN, OS: TOUT, QS: QUAD}
    out = np.full((len(vertices), N_FEATURES), -1, np.int32)
    for i, v in enumerate(vertices):
        drive = 0
        if v.drive is not None:
            drive = 1 if v.drive[0] == ROW else 2
        out[i] = (kind_map[v.kind], v.op, v.m, v.port,
                  v.pe[0], v.pe[1],
                  {"": -1, "bus": 0, "grf": 1}.get(v.mode, -1), drive)
    return out


def conflict_matrix_ref(feat: np.ndarray) -> np.ndarray:
    """(n, 8) int32 -> (n, n) bool adjacency (occupancy + clique rules)."""
    kind = feat[:, 0]
    op = feat[:, 1]
    m = feat[:, 2]
    port = feat[:, 3]
    pe_r, pe_c = feat[:, 4], feat[:, 5]

    same_op = op[:, None] == op[None, :]
    same_m = m[:, None] == m[None, :]
    both = lambda k: (kind[:, None] == k) & (kind[None, :] == k)  # noqa
    same_port = port[:, None] == port[None, :]
    same_pe = (pe_r[:, None] == pe_r[None, :]) & \
        (pe_c[:, None] == pe_c[None, :])

    adj = same_op.copy()
    adj |= both(TIN) & same_port & same_m
    adj |= both(TOUT) & same_port & same_m
    adj |= both(QUAD) & same_pe & same_m
    np.fill_diagonal(adj, False)
    return adj


def _adjacency(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> bool ``[n, n]``: `conflict_matrix_ref`'s
    compares, in its order, on ``feat``'s device."""
    kind, op, m, port = feat[:, 0], feat[:, 1], feat[:, 2], feat[:, 3]
    pe_r, pe_c = feat[:, 4], feat[:, 5]

    def eq(a: torch.Tensor) -> torch.Tensor:
        return a[:, None] == a[None, :]

    def both(k: int) -> torch.Tensor:
        return (kind[:, None] == k) & (kind[None, :] == k)

    same_m = eq(m)
    same_port = eq(port)
    same_pe = eq(pe_r) & eq(pe_c)
    adj = eq(op)
    adj |= both(TIN) & same_port & same_m
    adj |= both(TOUT) & same_port & same_m
    adj |= both(QUAD) & same_pe & same_m
    adj.fill_diagonal_(False)
    return adj


def conflict_matrix_plain(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> ``int8 [n, n]`` adjacency (1 = conflict):
    the plain version of the dense kernel."""
    return _adjacency(feat).to(torch.int8)


def conflict_matrix_packed_plain(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> ``int32 [n, 2*n_words(n)]`` packed adjacency
    words, the plain version of the packed kernel: bit j % 32 of word
    j // 32 is column j (little-endian), columns j >= n are zero, and
    the word count is even so that the host can view word pairs as the
    uint64 rows `BitsetGraph` holds."""
    n = feat.shape[0]
    adj = _adjacency(feat)
    pad = 64 * n_words(n) - n
    if pad:
        adj = torch.cat([adj, adj.new_zeros((n, pad))], dim=1)
    return pack_words(adj)
