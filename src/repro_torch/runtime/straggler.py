"""Straggler mitigation.

Synchronous SPMD training runs at the speed of the slowest participant.
The mitigator tracks an EWMA of per-host step durations and applies, in
order of escalation:

1. **rebalance** — shrink the slow host's batch slice (the data pipeline
   is index-sliced per host, so this is a pure bookkeeping change) and
   grow the fastest hosts' slices to conserve the global batch;
2. **exclude**  — a host slower than ``exclude_ratio``× median for
   ``patience`` windows is reported to the coordinator for an elastic
   restart without it (runtime/elastic.py).

This is control-plane logic (no jax, no torch): unit-tested directly, driven by the
trainer loop on real deployments.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HostStat:
    ewma_s: float = 0.0
    n: int = 0
    slow_windows: int = 0


class StragglerMitigator:
    def __init__(self, n_hosts: int, global_batch: int, *,
                 alpha: float = 0.3, rebalance_ratio: float = 1.15,
                 exclude_ratio: float = 1.6, patience: int = 3,
                 min_rows: int = 1):
        self.n_hosts = n_hosts
        self.global_batch = global_batch
        self.alpha = alpha
        self.rebalance_ratio = rebalance_ratio
        self.exclude_ratio = exclude_ratio
        self.patience = patience
        self.min_rows = min_rows
        self.stats = [HostStat() for _ in range(n_hosts)]
        base = global_batch // n_hosts
        self.rows = [base] * n_hosts
        for i in range(global_batch - base * n_hosts):
            self.rows[i] += 1

    # ------------------------------------------------------------- update
    def observe(self, host: int, step_seconds: float) -> None:
        st = self.stats[host]
        st.ewma_s = (step_seconds if st.n == 0 else
                     (1 - self.alpha) * st.ewma_s
                     + self.alpha * step_seconds)
        st.n += 1

    def _median(self) -> float:
        xs = sorted(s.ewma_s for s in self.stats if s.n)
        return xs[len(xs) // 2] if xs else 0.0

    # ------------------------------------------------------------- policy
    def rebalance(self) -> list[int]:
        """Adjust per-host row counts; returns the new slice sizes."""
        med = self._median()
        if med <= 0:
            return self.rows
        for h, st in enumerate(self.stats):
            if not st.n:
                continue
            ratio = st.ewma_s / med
            if ratio > self.rebalance_ratio and \
                    self.rows[h] > self.min_rows:
                give = max(1, int(self.rows[h] * (1 - 1 / ratio)))
                give = min(give, self.rows[h] - self.min_rows)
                fastest = min(
                    (i for i in range(self.n_hosts) if self.stats[i].n),
                    key=lambda i: self.stats[i].ewma_s)
                self.rows[h] -= give
                self.rows[fastest] += give
            st.slow_windows = st.slow_windows + 1 \
                if ratio > self.exclude_ratio else 0
        assert sum(self.rows) == self.global_batch
        return self.rows

    def to_exclude(self) -> list[int]:
        return [h for h, st in enumerate(self.stats)
                if st.slow_windows >= self.patience]

    def host_slices(self) -> list[slice]:
        out, lo = [], 0
        for r in self.rows:
            out.append(slice(lo, lo + r))
            lo += r
        return out
