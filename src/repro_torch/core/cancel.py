"""Cooperative cancellation for racing mapping backends.

`CancelToken` is the one primitive the exact-vs-portfolio race
(`repro.exact.race`) threads through the engine: `map_dfg` checks it
between (II, jitter) combinations and harvest rounds,
`PortfolioSBTS.run` checks it once per lock-step iteration, and the
exact CSP (`certify._search_complete`) checks it every few dozen
search nodes.  Cancellation is *cooperative and loss-free*: a
cancelled solver stops at the next checkpoint and returns whatever it
has (an ``ok=False`` result, never a partial claim of proof), so the
race can discard the loser without waiting out its budget.

Tokens chain: a child token with a ``parent`` reports cancelled when
either itself or the parent is cancelled.  The race gives each
competitor its own child of the caller's token — the winner cancels
only its rival, while the caller can still cancel the whole race.
"""

from __future__ import annotations

import threading


class CancelToken:
    """Thread-safe cancellation flag (see module docstring)."""

    def __init__(self, parent: "CancelToken | None" = None) -> None:
        self._ev = threading.Event()
        self._parent = parent

    def cancel(self) -> None:
        self._ev.set()

    # threading.Event-compatible alias.
    set = cancel

    def is_set(self) -> bool:
        return self._ev.is_set() or (self._parent is not None
                                     and self._parent.is_set())
