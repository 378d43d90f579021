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
``*_plain`` functions evaluate the pair predicate by broadcast compares,
on any device, with the kernels' output layouts: `conflict_matrix_plain`
is the dense kernel's plain version.

The dense kernel evaluates the same predicate on folded words: each
vertex's op, and a place word (`fold_keys`) that two vertices share iff
they have the same place, exact while the fields fit its bit widths.  A
tile of `TILE_ROWS` rows by `STRIP` columns whose fields all fit
compares the two words; any other compares the fields themselves
(`fold_tiles` says which).  `conflict_matrix_folded` is that arithmetic
in torch, so that the CPU tests hold the fold to the reference.

The packed kernel computes the same words another way.  The predicate
is the union of two equivalence relations: same op; and same place,
i.e. the same kind, slot and port for TIN and TOUT, the same slot and
PE for QUAD (other kinds have no place).  So, with one group id per
vertex for each relation, row i is the OR of two group masks,

  out[i, w] = M[g_op(i), w] | M[g_place(i), w]   (bit i cleared),

where M[g] has bit j set for every vertex j of group g.
`conflict_matrix_packed_groups` is that formulation in torch, the
packed kernel's plain version; `group_ids` gives the ids, by the
kernel's mixed-radix arithmetic where the fields' ranges are narrow
(`radix_plan`) and by sorting otherwise.
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


# ------------------------------------------------------------- fold
#: The dense kernel's tile: rows a tile, columns a strip
#: (``kTileRows``, ``kStrip`` in ``csrc/conflict_matrix.cu``).
TILE_ROWS, STRIP = 32, 512
#: Signed bit widths of the slot, the TIN/TOUT port and each PE
#: coordinate in the place word (``kMBits``, ``kPortBits``, ``kPeBits``).
#: A CPU test holds these five equal to the kernel source's.
M_BITS, PORT_BITS, PE_BITS = 14, 16, 8


def _fits(x: torch.Tensor, bits: int) -> torch.Tensor:
    return (x >= -(1 << (bits - 1))) & (x < (1 << (bits - 1)))


def fold_keys(feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``int32 [n, 8]`` -> (op, place, fits), the dense kernel's folded
    words as int64 ``[n]`` and whether each vertex's fields fit them:

    - TIN/TOUT: ``kind << 30 | (m & 0x3fff) << 16 | (port & 0xffff)``;
    - QUAD: ``2 << 30 | (m & 0x3fff) << 16 | (pe_r & 0xff) << 8 |
      (pe_c & 0xff)``;
    - no place (other kinds): ``3 << 30 | j``, the vertex's own index.

    Where two vertices fit, their place words are equal iff both have
    the same place (the low bits of a field that fits its signed width
    determine it), so the predicate is ``op_i == op_j or place_i ==
    place_j`` off the diagonal."""
    f = feat.to(torch.int64)
    kind, op, m, port, pe_r, pe_c = (f[:, c] for c in range(6))
    j = torch.arange(f.shape[0], device=feat.device)
    port_kind = (kind == TIN) | (kind == TOUT)
    quad = kind == QUAD
    slot = kind << 30 | (m & ((1 << M_BITS) - 1)) << 16
    pe_mask = (1 << PE_BITS) - 1
    place = torch.where(
        port_kind, slot | (port & ((1 << PORT_BITS) - 1)),
        torch.where(quad, slot | (pe_r & pe_mask) << PE_BITS |
                    (pe_c & pe_mask), 3 << 30 | j))
    fits = torch.where(
        port_kind, _fits(m, M_BITS) & _fits(port, PORT_BITS),
        torch.where(quad, _fits(m, M_BITS) & _fits(pe_r, PE_BITS) &
                    _fits(pe_c, PE_BITS), j < 2**30))
    return op, place, fits


def _all_per(fits: torch.Tensor, size: int) -> torch.Tensor:
    """Per run of ``size`` entries: do all fit (past the end counts as
    fitting, as the kernel's zero-filled padding does)?"""
    pad = -fits.shape[0] % size
    return torch.cat([fits, fits.new_ones(pad)]).view(-1, size).all(1)


def fold_tiles(feat: torch.Tensor) -> torch.Tensor:
    """bool ``[row tiles, strips]``: the dense kernel's tiles that take
    the folded loop (every row and column fits), the rest the general
    loop."""
    fits = fold_keys(feat)[2]
    return _all_per(fits, TILE_ROWS)[:, None] & \
        _all_per(fits, STRIP)[None, :]


def conflict_matrix_folded(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> ``int8 [n, n]``: the dense kernel's
    arithmetic, the folded words' compares on tiles that fit and the
    fields' compares on the rest (the same matrix as
    `conflict_matrix_plain`)."""
    n = feat.shape[0]
    op, place, _ = fold_keys(feat)
    folded = (op[:, None] == op[None, :]) | \
        (place[:, None] == place[None, :])
    tiles = fold_tiles(feat)
    fast = tiles.repeat_interleave(TILE_ROWS, 0)[:n] \
        .repeat_interleave(STRIP, 1)[:, :n]
    adj = torch.where(fast, folded, _adjacency(feat))
    adj.fill_diagonal_(False)
    return adj.to(torch.int8)


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


# ------------------------------------------------------------ groups
#: radix_plan's fields, in the order the CUDA launcher takes them.
PLAN_FIELDS = ("lo_op", "lo_m", "lo_port", "lo_pe_r", "lo_pe_c",
               "r_op", "r_m", "r_port", "r_pe_r", "r_pe_c")


def radix_plan(feat: torch.Tensor) -> tuple[int, ...] | None:
    """The mixed-radix group ids' lows and radices (`PLAN_FIELDS`), from
    one ``aminmax`` over the op, slot, port and PE columns, or None when
    the ids would span more than ``max(n, 1024)`` mask rows (wide or
    scattered values), where `sorted_ids` compacts them instead.

    Op ids are ``op - lo_op`` in ``[0, r_op)``; place ids follow them:
    TIN/TOUT ``r_op + (kind r_m + m - lo_m) r_port + port - lo_port``,
    QUAD ``r_op + 2 r_m r_port + ((m - lo_m) r_pe_r + pe_r - lo_pe_r)
    r_pe_c + pe_c - lo_pe_c``.  The ranges are taken over every row, so
    the "none" values (-1) that `encode` writes are inside them."""
    n = feat.shape[0]
    lo, hi = torch.aminmax(feat[:, 1:6], dim=0)
    lo, hi = lo.tolist(), hi.tolist()
    r = [h - lo_ + 1 for lo_, h in zip(lo, hi)]
    if group_rows((*lo, *r)) > max(n, 1024):
        return None
    return (*lo, *r)


def group_rows(plan: tuple[int, ...]) -> int:
    """Mask rows the ids of a `radix_plan` span."""
    r_op, r_m, r_port, r_pe_r, r_pe_c = plan[5:]
    return r_op + 2 * r_m * r_port + r_m * r_pe_r * r_pe_c


def radix_ids(feat: torch.Tensor,
              plan: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """(op ids, place ids) as ``int32 [n]`` by `radix_plan`'s
    arithmetic (the packed kernel's); a vertex with no place gets -1."""
    lo_op, lo_m, lo_port, lo_pe_r, lo_pe_c, r_op, r_m, r_port, r_pe_r, \
        r_pe_c = plan
    f = feat.to(torch.int64)
    kind, op, m, port, pe_r, pe_c = (f[:, c] for c in range(6))
    dm = m - lo_m
    tin_tout = r_op + (kind * r_m + dm) * r_port + port - lo_port
    quad = r_op + 2 * r_m * r_port + \
        (dm * r_pe_r + pe_r - lo_pe_r) * r_pe_c + pe_c - lo_pe_c
    place = torch.where((kind == TIN) | (kind == TOUT), tin_tout,
                        torch.where(kind == QUAD, quad, -1))
    return (op - lo_op).to(torch.int32), place.to(torch.int32)


def sorted_ids(feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                            int]:
    """(op ids, place ids, mask rows): compact ids by sorting (`unique`)
    for any int32 values; place ids follow the op ids, -1 for none."""
    kind, op, m = feat[:, 0], feat[:, 1], feat[:, 2]
    ops, op_id = torch.unique(op, return_inverse=True)
    quad = kind == QUAD
    placed = (kind == TIN) | (kind == TOUT) | quad
    # (kind, slot, port, 0) for TIN/TOUT, (QUAD, slot, pe_r, pe_c).
    key = torch.stack([kind, m, torch.where(quad, feat[:, 4], feat[:, 3]),
                       torch.where(quad, feat[:, 5], 0)], dim=1)
    place_id = torch.full_like(op, -1)
    places = 0
    if bool(placed.any()):
        uniq, inv = torch.unique(key[placed], dim=0, return_inverse=True)
        place_id[placed] = (len(ops) + inv).to(torch.int32)
        places = len(uniq)
    return op_id.to(torch.int32), place_id, len(ops) + places


def group_ids(feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                           int]:
    """(op ids, place ids, mask rows) of ``int32 [n, 8]`` features: the
    mixed-radix ids where `radix_plan` allows them, else sorted ones."""
    plan = radix_plan(feat) if feat.shape[0] else None
    if plan is None:
        return sorted_ids(feat)
    return (*radix_ids(feat, plan), group_rows(plan))


def conflict_matrix_packed_groups(feat: torch.Tensor) -> torch.Tensor:
    """``int32 [n, 8]`` -> ``int32 [n, 2*n_words(n)]``: the packed
    kernel's plain version, the OR of each row's two group masks with
    its own bit cleared (the same words as
    `conflict_matrix_packed_plain`)."""
    n = feat.shape[0]
    w32 = 2 * n_words(n)
    if n == 0:
        return torch.zeros((0, w32), dtype=torch.int32, device=feat.device)
    op_id, place_id, rows = group_ids(feat)
    j = torch.arange(n, device=feat.device)
    word = j >> 5
    bit = torch.bitwise_left_shift(torch.ones_like(j), j & 31)
    none = rows                               # an all-zero mask row
    place = torch.where(place_id >= 0, place_id.long(), none)
    masks = torch.zeros((rows + 1, w32), dtype=torch.int64,
                        device=feat.device)
    # A vertex adds its own bit once to each of its two rows, so the
    # sums are ORs of distinct bits.
    masks.index_put_((op_id.long(), word), bit, accumulate=True)
    masks.index_put_((place, word), bit, accumulate=True)
    masks[none] = 0
    out = masks[op_id.long()] | masks[place]
    out[j, word] &= ~bit
    # [0, 2**32) -> the int32 with the same bits.
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
