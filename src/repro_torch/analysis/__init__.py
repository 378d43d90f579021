"""Static analysis the port needs so far: `demand`, the schedule-free
II floor behind ``map_dfg``'s static pre-pass, and `dfglint`, the
structural lint whose generator-family invariants `core.workloads`
asserts.  The reference's `analyze`/`static_infeasibility` wrappers and
its repo linter (`astlint`) are not ported."""

from .demand import (DemandBound, demand_mii, effective_fanout,
                     implied_demand_bounds)
from .dfglint import (LintFinding, fatal_findings,
                      generator_invariant_findings, lint_dfg)

__all__ = ["DemandBound", "LintFinding", "demand_mii", "effective_fanout",
           "fatal_findings", "generator_invariant_findings",
           "implied_demand_bounds", "lint_dfg"]
