"""Multi-kernel co-mapping: partition a PEA into rectangular regions,
map one DFG per region at a common II, arbitrate the bus scopes regions
share, and replay the merged binding through the global validator."""

from .arbiter import ArbiterReport, arbitrate, merge_mappings
from .comap import CoMapResult, co_map
from .regions import Region, partition

__all__ = [
    "ArbiterReport", "arbitrate", "merge_mappings",
    "CoMapResult", "co_map", "Region", "partition",
]
