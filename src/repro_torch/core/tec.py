"""Time-Extended CGRA (TEC), T_II(V_T, E_T): the CGRA replicated for modulo
slots 0..II-1.  Binding places ops on TEC nodes; an edge of the TEC is a
single-hop routing path (same-PE across time via LRF, same-row via a row
bus, same-column via a column bus).

Bus inventory per DESIGN.md §3 (reconstructed from the quadruple notation
bus_{i,x} / bus_{j,y} in TABLE I — x/y index multiple buses per row/column):

- row r: bus (ROW, r, 0) = IBUS_r, fed by IPORT_r (or re-driven by a PE:
  "bus routing", which conflicts with port use — edge rule 2);
  bus (ROW, r, 1) = row routing bus, PE-driven.
- col c: bus (COL, c, 0) = OBUS_c, drained by OPORT_c, PE-driven;
  bus (COL, c, 1) = column routing bus, PE-driven.

One driver per bus per cycle.  A datum driven on a row(col) bus at slot m is
readable by every PE of that row(col) at m.
"""

from __future__ import annotations

import dataclasses

from .cgra import CGRAConfig

ROW = "row"
COL = "col"


@dataclasses.dataclass(frozen=True)
class TECNode:
    r: int
    c: int
    m: int  # modulo slot


class TEC:
    def __init__(self, cgra: CGRAConfig, ii: int):
        self.cgra = cgra
        self.ii = ii

    def nodes(self):
        for m in range(self.ii):
            for r in range(self.cgra.rows):
                for c in range(self.cgra.cols):
                    yield TECNode(r, c, m)

    def buses(self, scope: str, idx: int) -> list[tuple[str, int, int]]:
        """All physical buses of a row/column scope."""
        return [(scope, idx, k) for k in range(self.cgra.buses_per_scope)]

    @staticmethod
    def reachable(src: tuple[int, int], dst: tuple[int, int]) -> bool:
        """Single-hop reachability between PEs (same PE / row / column)."""
        return src == dst or src[0] == dst[0] or src[1] == dst[1]
