"""Activation annotations: the reference's sharding constraint, below both
the models and the launchers.

Model code annotates activations with ``constrain(x, ("batch", "seq",
...))``.  The launcher installs a rule set (`launch.sharding.Rules`, from
the planner's output) with `use_rules`; with none installed `constrain`
returns its input and does nothing else, so serving and training on one
card never touch the mesh machinery.  Under rules it returns its input
too, and the rules record the activation (``rules.record(names,
shape)``): the port runs on one device, so nothing is resharded.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


@contextlib.contextmanager
def use_rules(rules):
    """Install ``rules`` (a `launch.sharding.Rules`, or None) for the
    calling thread."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def active_rules():
    return getattr(_state, "rules", None)


def constrain(x, names: tuple):
    """The reference's sharding constraint: with no active rules ``x``
    and nothing else; under rules, ``x``, with its names, global shape
    and per-device shape recorded (`launch.sharding.Rules.record`).  One
    device holds the whole tensor either way."""
    rules = active_rules()
    if rules is not None:
        rules.record(tuple(names), tuple(x.shape))
    return x
