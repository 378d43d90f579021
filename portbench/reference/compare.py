"""The numbers the correctness check compares, from two sets of readings
(`reference.train.readings`' form): a run's and the float32
reference's.

- ``loss_gap``: the largest |loss - reference loss| over the steps
  (nats).
- ``loss_gap_first``: the same of the first step alone, which no update
  has moved yet: steady from seed to seed where a large first update
  makes the later steps' losses swing.
- ``grad_gap``: over the leaves, the largest gap between the norms of
  the first clipped gradient, |n - n_ref|, over the larger of n_ref and
  the median leaf's n_ref.
- ``grad_gap_median``: the median leaf's gap of the same: steady from
  seed to seed, where the largest swings with one small leaf.
- ``grad_gap_matrices``: the largest of the same over the matrices, the
  leaves of two or more dimensions (by that rule, not by name): a fault
  in the gradient of a few leaves, which moves the median leaf not at
  all, shows here, and the per-head and per-channel vectors, whose
  norms swing from seed to seed, are out.
- ``change_gap``: the same of each leaf's change over the steps, over
  the leaves whose first reference gradient is at least `MOVED` times
  the median leaf's (a leaf with no gradient to speak of moves under
  Adam by round-off alone).

A reading that is not finite is infinite.
"""

from __future__ import annotations

import math
import statistics

#: Share of the median leaf's first gradient below which a leaf's change
#: is not compared.
MOVED = 1e-3


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """name -> |got - want| over the larger of want and the median
    leaf's want (infinite where not finite)."""
    names = list(names)
    if not names:
        return {}
    med = statistics.median(want[k] for k in names)
    out = {}
    for k in names:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def gaps(got: dict, want: dict) -> dict:
    """{"loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
    "grad_gap_matrices", "change_gap"} of ``got`` against ``want`` (the reference's readings,
    with each leaf's ``dims``); both hold the same leaves and steps."""
    if set(got["grad_norms"]) != set(want["grad_norms"]) or \
            len(got["losses"]) != len(want["losses"]):
        raise ValueError("the readings hold different leaves or steps")
    steps = [abs(a - b) if math.isfinite(abs(a - b)) else math.inf
             for a, b in zip(got["losses"], want["losses"])]
    g = want["grad_norms"]
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= MOVED * med]
    grad = leaf_gaps(got["grad_norms"], g, g)
    change = leaf_gaps(got["change_norms"], want["change_norms"], moved)
    matrices = [grad[k] for k in g if want["dims"][k] >= 2]
    return {"loss_gap": max(steps, default=0.0),
            "loss_gap_first": steps[0] if steps else 0.0,
            "grad_gap": max(grad.values(), default=0.0),
            "grad_gap_median": statistics.median(grad.values()),
            "grad_gap_matrices": max(matrices, default=0.0),
            "change_gap": max(change.values(), default=0.0)}


def checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the numbers a cell's
    ``limits`` name: correct when each is at most its limit."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
