"""CGRA architecture model (Fig. 1 of the paper).

Reconstructed resource model (documented in DESIGN.md §3):

- 2-D PEA with ``rows`` x ``cols`` PEs.  Following the paper's notation the
  number of PEs attached to a common IBUS is M = ``cols`` (a row shares one
  input bus) and tuples use ports n = 1..N with N = ``rows``.
- Each row r has an input bus IBUS_r fed by the hardwired input port
  IPORT_r; the memory-side crossbar can *multicast* one datum to several
  IPORTs in the same cycle — that is how a VIO bound to Q ports reaches
  Q x M PEs without routing PEs (Fig. 2(e)).
- Each column c has an output bus OBUS_c drained by OPORT_c.  A PE (r, c)
  hears IBUS_r and OBUS_c, and can drive OBUS_c (sending results out or
  PE->PE within the column) or re-drive IBUS_r (**bus routing**, the BusMap
  mechanism: a routing PE re-broadcasts a cached datum on a bus).  One driver
  per bus per cycle.
- Optional GRF: a global register file readable/writable by all PEs in
  parallel; a datum parked in the GRF is readable by every PE the next cycle
  (capacity-limited), which removes residual routing PEs (paper §IV).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CGRAConfig:
    rows: int = 4               # N: number of row buses / input ports
    cols: int = 4               # M: PEs per IBUS
    lrf: int = 8                # local register file capacity per PE
    grf: int = 0                # global register file capacity (0 = absent)
    # Physical buses per row/column scope (DESIGN.md §3: bus 0 is the
    # hardwired IBUS_r / OBUS_c, bus 1 the PE-driven routing bus).  The
    # single source of truth for bus capacity — tec.py::buses, the
    # validator's assignment search and the conflict graph's bus-pressure
    # edges all read it from here.
    buses_per_scope: int = 2

    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    @property
    def n_iports(self) -> int:
        return self.rows

    @property
    def n_oports(self) -> int:
        return self.cols

    @property
    def pes_per_ibus(self) -> int:
        """M in the paper's bandwidth-allocation policy."""
        return self.cols

    def pe_coords(self):
        for r in range(self.rows):
            for c in range(self.cols):
                yield (r, c)

    def view(self, rows: int, cols: int, *,
             grf: int | None = None) -> "CGRAConfig":
        """Region view: a ``rows`` x ``cols`` sub-array sharing this
        config's per-PE parameters (lrf, buses_per_scope).

        Used by the co-mapping subsystem (`repro.comap`): each rectangular
        region of the PEA is mapped as if it were a standalone CGRA of
        this shape, with the region's row/column indices translated back
        to global coordinates afterwards.  ``grf`` overrides the global
        register file share granted to the region (the GRF is a single
        physical resource, so co-resident regions must split it)."""
        assert 0 < rows <= self.rows and 0 < cols <= self.cols
        return dataclasses.replace(
            self, rows=rows, cols=cols,
            grf=self.grf if grf is None else grf)


# Resource identifiers used across scheduling / binding.  A resource instance
# is (kind, index, modulo_time).
PE = "pe"          # index = (row, col)
IPORT = "iport"    # index = row
OPORT = "oport"    # index = col
IBUS = "ibus"      # index = row
OBUS = "obus"      # index = col
GRF = "grf"        # index = slot
