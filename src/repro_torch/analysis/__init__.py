"""Static analysis the port needs so far: `demand`, the schedule-free
II floor behind ``map_dfg``'s static pre-pass.  `dfglint` waits for a
later slice (ROADMAP, "workloads/dfglint")."""

from .demand import (DemandBound, demand_mii, effective_fanout,
                     implied_demand_bounds)

__all__ = ["DemandBound", "demand_mii", "effective_fanout",
           "implied_demand_bounds"]
