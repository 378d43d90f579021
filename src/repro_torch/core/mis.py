"""Phase 3b: maximum-independent-set solver on packed-bitset adjacency.

The paper applies SBTS — general Swap-Based multiple neighborhood Tabu
Search (Jin & Hao, 2015) — to the conflict graph.  This re-implements its
core loop over :class:`~repro_torch.core.bitset.BitsetGraph` rows:

- greedy (min-degree, randomized) construction of an initial solution,
- (1,0) *add* moves: insert any vertex with zero conflicts in S,
- (1,1) *swap* moves: insert a vertex with exactly one conflicting member u
  and evict u (tabu on u for `tenure` iterations, aspiration on best),
- perturbation (random k-eviction) when the search plateaus.

Two entry points:

- :func:`solve_mis` — one SBTS trajectory (the original API; accepts a
  dense bool matrix or a BitsetGraph);
- :func:`solve_mis_portfolio` — K independent seeds advanced in lock-step:
  every per-iteration quantity (conflict counts, move candidates, tabu
  clocks) is a ``[K, n]`` array, so one numpy expression serves the whole
  portfolio and the per-iteration interpreter overhead is amortised K-fold.
  The portfolio exits as soon as any seed reaches ``target`` (= |V_D|, one
  placement per op) — the mapping use-case never needs a certified maximum.
"""

from __future__ import annotations

import dataclasses
import math as _math

import numpy as np

from .bitset import BitsetGraph, as_bitset_graph, pack_bool

# Unpacked-row caches ([n, n] uint8) are materialised only below this
# byte bound; larger graphs fall back to per-move unpack.
ROW_CACHE_LIMIT = 1 << 25


@dataclasses.dataclass(frozen=True)
class GroupMoveConfig:
    """Knobs for the clustered group-move ("kick") neighbourhood.

    The (1,1) swap neighbourhood moves one vertex at a time, so a VIO
    whose bus-fed consumers ended up spread over several rows can never
    be repaired: every candidate of the unplaced op conflicts with >= 2
    selected vertices at once, and the portfolio stalls just below full
    coverage.  The kick ejects the *whole* blocking cluster — the
    unplaced op's conflicting placements, discovered from the packed
    adjacency in one union-AND (`BitsetGraph.cluster_members`) — and
    re-inserts the cluster's ops atomically at a different row/slot
    assignment, with the ejected placements tabu'd for ``tenure``
    iterations so the seed cannot immediately rebuild the local minimum.

    ``cadence``     — kick every this many portfolio super-iterations
                      (the kick replaces that iteration's swap, so the
                      flag-on/off iteration budgets stay comparable).
    ``max_cluster`` — cap on the number of ops ejected per kick; a
                      candidate blocked by more ops than this is not
                      kicked (the cluster for a stalled VIO is its
                      target row's occupants plus its own stray
                      consumers, ~rows + fanout ops).
    ``tenure``      — tabu tenure applied to ejected placements; longer
                      than the swap tenure so a kick outlives the swap
                      phase's churn.
    """
    enabled: bool = True
    cadence: int = 40
    max_cluster: int = 24
    tenure: int = 30


def greedy_mis(adj, rng: np.random.Generator,
               row_cache: np.ndarray | None = None) -> np.ndarray:
    """Randomized min-degree construction; returns a maximal IS.

    The degree update unpacks only the *killed* rows (gathered from
    ``row_cache`` when the caller shares one): the decrement of
    ``deg[v]`` is the number of killed neighbours of v, i.e. the
    column sum of the killed vertices' rows — integer-identical to the
    old whole-matrix ``popcount(rows & kill)`` pass but O(|kill| * n)
    instead of O(n * words) per placement, which is what made cold
    portfolio warm-starts dominate 16x16-fabric map walls (PR 8
    traces)."""
    g = as_bitset_graph(adj)
    n = g.n
    deg = g.degrees()
    alive = np.ones(n, dtype=bool)
    in_s = np.zeros(n, dtype=bool)
    while alive.any():
        cand = np.flatnonzero(alive)
        d = deg[cand] + rng.random(cand.size)  # random tie-break
        v = cand[int(np.argmin(d))]
        in_s[v] = True
        kill = g.row_u8(v).astype(bool) & alive
        alive[v] = False
        alive[kill] = False
        killed = np.flatnonzero(kill)
        if killed.size:
            rows = row_cache[killed] if row_cache is not None \
                else g.rows_u8(killed)
            deg -= rows.sum(axis=0, dtype=np.int64)
    return in_s


class PortfolioSBTS:
    """K SBTS trajectories in lock-step over one BitsetGraph.

    State arrays are ``[K, n]``; one super-iteration applies one move per
    seed (a conflict-free add where available, else a tabu-guarded swap),
    with per-seed plateau perturbation.  Independence is invariant per
    seed: adds require ``conf == 0``, swaps evict the unique conflicting
    member before inserting.
    """

    def __init__(self, g: BitsetGraph, inits, *, tenure: int = 7,
                 seed: int = 0, row_cache: np.ndarray | None = None,
                 row_cache_limit: int | None = None,
                 op_of: np.ndarray | None = None,
                 group_move: "GroupMoveConfig | None" = None):
        self.g = g
        self.k = len(inits)
        self.tenure = tenure
        self.rng = np.random.default_rng(seed)
        n = g.n
        # Unpacked 0/1 row cache for delta updates: one unpackbits of the
        # whole packed adjacency (or a caller-shared one, e.g. the
        # certificate stage's), after which each move's row fetch is a
        # fancy gather.  Bounded to ``row_cache_limit`` bytes (default
        # ROW_CACHE_LIMIT = 32 MiB); beyond that, rows are unpacked per
        # move (still O(n/8) traffic) — the |V_C| ~ 10^4 regime of a
        # 16x16 PEA lands on this fallback.  Resolved before the inits
        # so cold greedy constructions gather from the shared cache.
        self.row_cache_limit = ROW_CACHE_LIMIT if row_cache_limit is None \
            else row_cache_limit
        if row_cache is not None:
            self._u8 = row_cache
        else:
            self._u8 = g.rows_u8(np.arange(n)) \
                if 0 < n * n <= self.row_cache_limit else None
        self.in_s = np.zeros((self.k, n), dtype=bool)
        for i, init in enumerate(inits):
            if init is None:
                self.in_s[i] = greedy_mis(g, self.rng, self._u8)
            else:
                self.in_s[i] = init
        # conf[k, v] = number of members of S_k adjacent to v.
        conf_dtype = np.int16 if n < (1 << 15) else np.int32
        self.conf = np.stack([g.conflict_counts(pack_bool(row))
                              for row in self.in_s]).astype(conf_dtype)
        self.tabu = np.zeros((self.k, n), dtype=np.int32)
        self.stall = np.zeros(self.k, dtype=np.int64)
        # Desynchronized plateau thresholds: members of a lock-step
        # portfolio stall together, so identical thresholds would fire
        # every perturbation (and its add-sweep refill) simultaneously.
        self._thresh = 60 + self.rng.integers(0, 24, self.k)
        # Pregenerated tabu-tenure jitter (values 0..3): cycling 256 draws
        # replaces a per-iteration bit-generator call.
        self._ints = self.rng.integers(0, 4, (256, self.k), dtype=np.int32)
        self.size = self.in_s.sum(axis=1)
        self.best = self.in_s.copy()
        self.best_size = self.size.copy()
        self.it = 0
        self._probe_adds = True
        self._rand = self.rng.random((self.k, 2 * max(n, 1)),
                                     dtype=np.float32)
        self._pool_uses = 0
        self._stride = 0   # drawn (coprime to n) at the first _draw
        self._u8_ext: np.ndarray | None = None  # row_cache() overflow copy
        # Group-move neighbourhood (off by default).  Everything below is
        # inert when disabled: the main loop's state arrays, RNG stream
        # and move sequence are untouched, so flag-off trajectories stay
        # bit-identical to a solver constructed without these arguments.
        self._gm = group_move if group_move is not None \
            and group_move.enabled else None
        if self._gm is not None and op_of is None:
            raise ValueError("group_move requires op_of (vertex -> op)")
        if op_of is not None:
            op_of = np.asarray(op_of, dtype=np.int64)
            _, self._op_idx = np.unique(op_of, return_inverse=True)
            self._n_ops = int(self._op_idx.max()) + 1 if n else 0
            order = np.argsort(self._op_idx, kind="stable")
            bounds = np.searchsorted(self._op_idx[order],
                                     np.arange(1, self._n_ops))
            self._op_cands = np.split(order, bounds)
        else:
            self._op_idx = None
        # Separate RNG stream: kicks never advance the main generator, so
        # enabling the flag perturbs only the iterations it fires on.
        self._gm_rng = np.random.default_rng(
            (seed * 2654435761 + 0x9E3779B9) & 0x7FFFFFFFFFFFFFFF)

    def row_cache(self) -> np.ndarray:
        """Unpacked 0/1 adjacency ``uint8 [n, n]``, shared with callers
        (e.g. ejection-repair retries).  When the constructor skipped the
        cache (graph beyond the 32 MiB bound), materialise it lazily here
        so the solver's per-move path keeps its per-move unpack policy
        while one-shot consumers still get a single unpack."""
        if self._u8 is not None:
            return self._u8
        if self._u8_ext is None:
            self._u8_ext = self.g.rows_u8(np.arange(self.g.n))
        return self._u8_ext

    def _rows(self, vs: np.ndarray) -> np.ndarray:
        return self._u8[vs] if self._u8 is not None else self.g.rows_u8(vs)

    def _row(self, v: int) -> np.ndarray:
        return self._u8[v] if self._u8 is not None else self.g.row_u8(v)

    def run(self, max_iters: int, target: int | None = None,
            cancel=None, tracer=None) -> np.ndarray:
        """Advance all seeds up to ``max_iters`` iterations each (an
        iteration is a full (1,0) add sweep or one (1,1) swap, matching
        the single-trajectory SBTS accounting); stop early when any
        seed's best reaches ``target``.  Returns per-seed best
        memberships ``bool [K, n]``.

        ``cancel`` (a `core.cancel.CancelToken`) is polled at the top of
        every iteration: a cancelled run stops before advancing further
        and returns the bests so far.  ``cancel=None`` leaves the
        trajectories bit-identical to the flag-less engine (the polling
        never touches the RNG streams)."""
        # Per-super-iteration counter handle; the NullCounter default
        # keeps the untraced loop at one no-op call per [K, n] sweep and
        # never touches the RNG streams either way.
        from repro_torch.obs.trace import live
        iters_counter = live(tracer).counter("portfolio.iters")
        kick_counter = live(tracer).counter("portfolio.kicks")
        if self.g.n == 0 or self.k == 0:
            return self.best
        if target is not None and (self.best_size >= target).any():
            return self.best
        n, k_idx = self.g.n, np.arange(self.k)
        for _ in range(max_iters):
            if cancel is not None and cancel.is_set():
                break
            self.it += 1
            iters_counter.inc()
            it = self.it
            # Periodic group-move kick: spend this iteration ejecting and
            # atomically re-placing a blocking cluster per stalled seed
            # (see GroupMoveConfig).  Counts against the iteration budget
            # so flag-on/off runs compare at equal budgets.
            if self._gm is not None and it % self._gm.cadence == 0:
                kick_counter.inc()
                self._group_kick(target)
                if target is not None and \
                        (self.best_size >= target).any():
                    return self.best
                continue
            # Add moves appear only after evictions free a vertex's whole
            # neighbourhood — probe for them periodically (and right
            # after perturb/rearm/reset) instead of every iteration; a
            # deferred (1,0) sweep costs at most 3 iterations of delay.
            if self._probe_adds or it % 4 == 1:
                self._probe_adds = False
                # Tabu applies to re-insertion too: unlike the original
                # solver's add phase, rearm/perturb evictions stay out
                # for their tenure instead of being re-added on the next
                # probe — that is what makes those diversifications
                # actually diversify.
                addable = (self.conf == 0) & (self.tabu <= it)
                addable &= ~self.in_s
                can_add = addable.any(axis=1)
                if can_add.any():
                    # (1,0) sweep: absorb every conflict-free outsider of
                    # the affected seeds, then re-enter.
                    self._sweep_adds(np.flatnonzero(can_add), addable)
                    if target is not None and \
                            (self.best_size >= target).any():
                        return self.best
                    continue
            # Pure-swap fast path: every per-iteration quantity is one
            # [K, n] expression, no boolean-mask copies.  No ~in_s term:
            # members have conf == 0 by independence, so conf == 1
            # already excludes them.
            swapable = (self.conf == 1) & (self.tabu <= it)
            r = self._draw(n)
            vs = (r * swapable).argmax(axis=1)
            # Validity by gather, not a second [K, n] reduction: the
            # argmax lands on a candidate iff the seed has one.
            has = swapable[k_idx, vs]
            if not has.all():
                self.stall[~has] += 3
                if not has.any():
                    self._perturb()
                    continue
            rows_v = self._rows(vs)
            # Evict the unique in-S neighbour of each swap insertion.
            us = (rows_v & self.in_s).argmax(axis=1)
            rows_u = self._rows(us)
            jit4 = self._ints[it & 255]
            if has.all():
                self.in_s[k_idx, us] = False
                self.in_s[k_idx, vs] = True
                self.conf += rows_v
                self.conf -= rows_u
                self.tabu[k_idx, us] = it + self.tenure + jit4
                self.stall += 1
            else:
                hk = k_idx[has]
                self.in_s[hk, us[has]] = False
                self.in_s[hk, vs[has]] = True
                self.conf[has] += rows_v[has]
                self.conf[has] -= rows_u[has]
                self.tabu[hk, us[has]] = it + self.tenure + jit4[has]
                self.stall[has] += 1
            if (self.stall > self._thresh).any():
                self._perturb()
        return self.best

    def _draw(self, n: int) -> np.ndarray:
        """Tie-break randoms: a strided view into a pregenerated pool
        (refreshed every n draws), so the hot loop never calls the bit
        generator for [K, n] data.  The stride is re-drawn coprime to n
        at each refresh, so consecutive draws cycle through all n
        offsets (a fixed stride degenerates when n divides it)."""
        self._pool_uses += 1
        if self._pool_uses >= n or self._stride == 0:
            self._rand = self.rng.random((self.k, 2 * n),
                                         dtype=np.float32)
            self._pool_uses = 0
            self._stride = int(self.rng.integers(1, max(n, 2)))
            while _math.gcd(self._stride, n) != 1:
                self._stride += 1
        off = (self._pool_uses * self._stride) % n
        return self._rand[:, off:off + n]

    def _sweep_adds(self, states: np.ndarray, addable: np.ndarray) -> None:
        """(1,0) phase: per affected seed, shuffle the (non-tabu)
        conflict-free outsiders and insert them sequentially (earlier
        inserts may re-conflict later candidates)."""
        for k in states:
            cand = np.flatnonzero(addable[k])
            rows_c = self._rows(cand)
            if not rows_c[:, cand].any():
                # Pairwise conflict-free (the common case: a perturbation
                # evicted a sparse set): insert the whole batch at once.
                self.in_s[k, cand] = True
                self.conf[k] += rows_c.sum(axis=0, dtype=self.conf.dtype)
                self.size[k] += cand.size
            else:
                self.rng.shuffle(cand)
                for v in cand:
                    if self.conf[k, v] == 0 and not self.in_s[k, v]:
                        self.in_s[k, v] = True
                        self.conf[k] += self._row(v)
                        self.size[k] += 1
            if self.size[k] > self.best_size[k]:
                self.best_size[k] = self.size[k]
                self.best[k] = self.in_s[k]
                self.stall[k] = 0

    def rearm(self, k: int, frac: float = 0.25) -> None:
        """Diversify seed ``k`` after the caller harvested its best (e.g.
        the mapping validator rejected it): restart from the best set
        minus a random slice, tabu the evicted vertices so the seed does
        not immediately rebuild the same solution, and reset the best
        tracking so the target early-exit re-arms.

        With group moves enabled the random slice (and ``frac``) is
        replaced by a coherent cluster eviction (`_rearm_cluster`,
        capped at the kick's ``max_cluster``) — moving a coupled group
        together diversifies tightly-coupled instances where a random
        slice would be rebuilt verbatim."""
        self.in_s[k] = self.best[k]
        members = np.flatnonzero(self.in_s[k])
        if members.size:
            if self._gm is not None:
                # Clustered re-placement: evict a coherent blocking
                # cluster around one random placement instead of a
                # random slice — a diversification that actually moves
                # coupled groups (VIO + row-pinned consumers) together.
                evict = self._rearm_cluster(k, members)
                self.in_s[k, evict] = False
                self.tabu[k, evict] = self.it + self._gm.tenure + \
                    int(self._gm_rng.integers(0, 10))
            else:
                evict = self.rng.choice(
                    members, size=max(1, int(members.size * frac)),
                    replace=False)
                self.in_s[k, evict] = False
                self.tabu[k, evict] = self.it + 3 * self.tenure + \
                    self.rng.integers(0, 10)
        self._resync(k)

    def reset_seed(self, k: int, init: np.ndarray | None = None) -> None:
        """Fully restart one trajectory from ``init`` (or a fresh greedy
        construction) — the portfolio analogue of an independent SBTS
        restart, used when a harvested solution failed downstream
        validation and its basin looks exhausted."""
        self.in_s[k] = greedy_mis(self.g, self.rng, self._u8) \
            if init is None \
            else init
        self.tabu[k] = 0
        self._resync(k)

    def _resync(self, k: int) -> None:
        """Recompute seed ``k``'s derived state from ``in_s[k]`` after an
        out-of-band membership edit, and re-arm its best tracking."""
        if self._u8 is not None:
            self.conf[k] = self._u8[self.in_s[k]].sum(axis=0,
                                                      dtype=np.int32)
        else:
            self.conf[k] = self.g.conflict_counts(pack_bool(self.in_s[k]))
        self.size[k] = int(self.in_s[k].sum())
        self.best[k] = self.in_s[k]
        self.best_size[k] = self.size[k]
        self.stall[k] = 0
        self._probe_adds = True

    def _perturb(self) -> None:
        """Random ~10 % eviction for seeds whose search plateaued.  The
        per-seed thresholds are re-randomized after each firing, so in
        steady state a firing involves one or two seeds, not the whole
        lock-step portfolio at once."""
        for k in np.flatnonzero(self.stall > self._thresh):
            members = np.flatnonzero(self.in_s[k])
            if members.size:
                # ~10 % sample; duplicates dropped (cheaper than an
                # exact without-replacement draw at this size).
                pick = self.rng.integers(0, members.size,
                                         max(1, members.size // 10))
                evict = members[np.unique(pick)]
                self.in_s[k, evict] = False
                self.size[k] -= evict.size
                self.conf[k] -= self._rows(evict).sum(
                    axis=0, dtype=self.conf.dtype)
                self.tabu[k, evict] = self.it + self.tenure
            self.stall[k] = 0
            self._thresh[k] = 60 + self.rng.integers(0, 24)
            self._probe_adds = True

    # ------------------------------------------------- group-move kick
    def _eject(self, k: int, blockers: np.ndarray) -> None:
        """Remove ``blockers`` from seed ``k`` and tabu their (old)
        placements with the kick's tenure so the seed cannot
        immediately rebuild the minimum it just escaped."""
        self.in_s[k, blockers] = False
        self.conf[k] -= self._rows(blockers).sum(
            axis=0, dtype=self.conf.dtype)
        self.size[k] -= blockers.size
        self.tabu[k, blockers] = self.it + self._gm.tenure + \
            self._gm_rng.integers(0, 8, blockers.size)

    def _insert(self, k: int, v: int, fresh: np.ndarray) -> None:
        self.in_s[k, v] = True
        self.conf[k] += self._row(v)
        self.size[k] += 1
        fresh[v] = True

    def _reinsert_cluster(self, k: int, ejected: list[int],
                          budget: int, fresh: np.ndarray) -> None:
        """Re-place the ejected cluster's ops atomically, most-
        constrained-first.  A free non-tabu candidate is taken outright;
        an op with none may recursively eject the blockers of its
        cheapest candidate (second ring — e.g. the foreign occupants of
        the row its re-placed VIO now pins it to) while ``budget`` ops
        remain, except placements made by this very kick (``fresh``),
        which are never undone.  Ops left unplaced when the budget runs
        out stay uncovered for the swap/add phases to resume on;
        independence is invariant throughout."""
        it = self.it
        pending = list(ejected)
        guard = 4 * self._gm.max_cluster
        while pending and guard > 0:
            guard -= 1
            counts = [int((self.conf[k, self._op_cands[p]] == 0).sum())
                      for p in pending]
            op = pending.pop(int(np.argmin(counts)))
            c = self._op_cands[op]
            ok = (self.conf[k, c] == 0) & ~self.in_s[k, c] & \
                (self.tabu[k, c] <= it)
            free = c[ok]
            if free.size:
                self._insert(
                    k, int(free[self._gm_rng.integers(0, free.size)]),
                    fresh)
                continue
            if budget <= 0:
                continue
            cand = c[self.tabu[k, c] <= it]
            if cand.size == 0:
                continue
            costs = self.conf[k, cand] + self._gm_rng.random(cand.size)
            for v in cand[np.argsort(costs, kind="stable")[:4]]:
                v = int(v)
                blockers = np.flatnonzero(self._row(v) & self.in_s[k])
                if blockers.size > budget or fresh[blockers].any():
                    continue
                self._eject(k, blockers)
                self._insert(k, v, fresh)
                pending.extend(np.unique(self._op_idx[blockers]).tolist())
                budget -= blockers.size
                break

    def _kick_seed(self, k: int, o: int, fresh: np.ndarray) -> bool:
        """Group-move on seed ``k`` for uncovered op ``o``: choose the
        candidate of ``o`` blocked by the fewest current placements
        (``conf`` *is* the blocker-op count — an independent set holds
        at most one vertex per op), eject **all** of its blockers — the
        conflict cluster, e.g. a stalled VIO's consumers astray on other
        rows — insert the candidate, and re-place the ejected ops around
        it (with bounded second-ring ejections; `_reinsert_cluster`).
        Placements made earlier in the same kick phase (``fresh``) are
        never ejected, so successive kicks compose instead of undoing
        each other.  Returns True when a move was applied."""
        gm = self._gm
        it = self.it
        c = self._op_cands[o]
        ok = self.tabu[k, c] <= it
        if not ok.any():
            return False
        cand = c[ok]
        costs = self.conf[k, cand] + self._gm_rng.random(cand.size)
        for v in cand[np.argsort(costs, kind="stable")[:6]]:
            v = int(v)
            if self.conf[k, v] == 0:
                # Free candidate: a plain add closes it, no ejection.
                self._insert(k, v, fresh)
                return True
            blockers = np.flatnonzero(self._row(v) & self.in_s[k])
            cluster = np.unique(self._op_idx[blockers])
            if cluster.size > gm.max_cluster or fresh[blockers].any():
                continue
            self._eject(k, blockers)
            self._insert(k, v, fresh)
            self._reinsert_cluster(k, cluster.tolist(),
                                   gm.max_cluster - cluster.size, fresh)
            return True
        return False

    def _uncovered(self, k: int) -> np.ndarray:
        members = np.flatnonzero(self.in_s[k])
        covered = np.zeros(self._n_ops, dtype=bool)
        covered[self._op_idx[members]] = True
        return np.flatnonzero(~covered)

    def _group_kick(self, target: int | None = None) -> None:
        """Clustered re-placement pass: per seed, kick *every* uncovered
        op once (in random order, including ops a second-ring ejection
        newly uncovers), with the phase's own insertions protected from
        ejection — so a coherent multi-group rebuild can reach full
        coverage atomically instead of being churned away by the swap
        iterations between two single-op kicks."""
        for k in range(self.k):
            if target is not None and self.best_size[k] >= target:
                continue
            if self.stall[k] * 2 < self._gm.cadence:
                # The swap phase is still making progress on this seed;
                # kicking now would pay the pass for nothing.
                continue
            queue = self._uncovered(k)
            if queue.size == 0:
                continue
            self._gm_rng.shuffle(queue)
            fresh = np.zeros(self.g.n, dtype=bool)
            kicked = np.zeros(self._n_ops, dtype=bool)
            queue = queue.tolist()
            while queue:
                o = queue.pop()
                if kicked[o]:
                    continue
                kicked[o] = True
                self._kick_seed(k, int(o), fresh)
                if not queue:
                    # Second-ring ejections may have uncovered new ops;
                    # give each one kick in the same pass.
                    queue = [o for o in self._uncovered(k)
                             if not kicked[o]]
            if self.size[k] > self.best_size[k]:
                self.best_size[k] = self.size[k]
                self.best[k] = self.in_s[k].copy()
                self.stall[k] = 0
        self._probe_adds = True

    def _rearm_cluster(self, k: int, members: np.ndarray) -> np.ndarray:
        """Cluster eviction for :meth:`rearm`: one random placement, a
        random alternative candidate of its op, and every placement
        blocking that alternative — the coupled group that has to move
        together for the re-placement to land anywhere new."""
        p = int(members[self._gm_rng.integers(0, members.size)])
        c = self._op_cands[self._op_idx[p]]
        v = int(c[self._gm_rng.integers(0, c.size)])
        blockers = np.flatnonzero(self._row(v) & self.in_s[k])
        cluster = np.union1d(np.unique(self._op_idx[blockers]),
                             [self._op_idx[p]])
        if cluster.size > self._gm.max_cluster:
            cluster = self._gm_rng.choice(
                cluster, size=self._gm.max_cluster, replace=False)
        return members[np.isin(self._op_idx[members], cluster)]


def solve_mis_portfolio(adj, *, inits, target: int | None = None,
                        max_iters: int = 20000, tenure: int = 7,
                        seed: int = 0) -> np.ndarray:
    """Run ``len(inits)`` independent SBTS seeds (``None`` entries start
    from the randomized greedy construction) and return the per-seed best
    memberships ``bool [K, n]``, early-exiting when any seed hits
    ``target``."""
    g = as_bitset_graph(adj)
    if g.n == 0:
        return np.zeros((max(len(inits), 1), 0), dtype=bool)
    sbts = PortfolioSBTS(g, inits, tenure=tenure, seed=seed)
    return sbts.run(max_iters, target=target)


def solve_mis(adj, *, target: int | None = None,
              max_iters: int = 20000, tenure: int = 7,
              seed: int = 0, init: np.ndarray | None = None) -> np.ndarray:
    """Return a boolean membership vector of an (approximately maximum)
    independent set of the conflict graph ``adj`` (dense bool matrix or
    BitsetGraph).  ``init`` may supply an independent set to warm-start
    from (e.g. the constructive placement)."""
    g = as_bitset_graph(adj)
    if g.n == 0:
        return np.zeros(0, dtype=bool)
    bests = solve_mis_portfolio(g, inits=[init], target=target,
                                max_iters=max_iters, tenure=tenure,
                                seed=seed)
    return bests[0]


def mis_indices(membership: np.ndarray) -> np.ndarray:
    return np.flatnonzero(membership)


def ejection_repair(adj, in_s: np.ndarray,
                    op_vertices: dict[int, list[int]],
                    op_of: np.ndarray, *, depth: int = 3,
                    seed: int = 0,
                    row_cache: np.ndarray | None = None) -> np.ndarray:
    """Ejection-chain repair: try to place every op that has no selected
    candidate by inserting one of its candidates, evicting the (≤2)
    conflicting members, and recursively re-placing the evicted ops'
    alternatives up to ``depth``.  Closes the 1–2-vertex shortfalls SBTS
    plateaus on for tightly-packed instances (e.g. BusMap C4K8).

    ``row_cache`` may supply the unpacked 0/1 adjacency (e.g. a
    PortfolioSBTS's cache) so repeated repair attempts on one graph
    don't each re-unpack it."""
    g = as_bitset_graph(adj)
    rng = np.random.default_rng(seed)
    in_s = in_s.copy()
    conf = g.conflict_counts(pack_bool(in_s))
    # Unpacked row cache: the chain search touches rows many times per
    # node, so pay one unpackbits for the whole graph up front.
    u8 = row_cache if row_cache is not None else (
        g.rows_u8(np.arange(g.n)) if g.n
        else np.zeros((0, 0), dtype=np.uint8))
    doms = {op: np.asarray(ids, dtype=np.int64)
            for op, ids in op_vertices.items()}
    banned = np.zeros(g.n, dtype=bool)
    nodes = [0]  # search-node budget (keeps worst-case bounded)

    def place(op: int, d: int) -> bool:
        nonlocal conf
        nodes[0] += 1
        if nodes[0] > 20000:
            return False
        # Batched candidate scoring over the row cache: one gather gives
        # every alive candidate's current conflict count; a random key
        # added before the stable argsort is the vectorised equivalent of
        # shuffle-then-sort (fewest evictions first, random tie-break).
        dom = doms[op]
        alive = dom[~(in_s[dom] | banned[dom])]
        if alive.size == 0:
            return False
        order = np.argsort(conf[alive] + rng.random(alive.size),
                           kind="stable")
        cands = alive[order]
        n_evict = conf[cands]
        for v, ne in zip(cands, n_evict):
            if ne == 0:
                in_s[v] = True
                conf += u8[v]
                return True
            if d == 0 or ne > 2:
                continue
            evict = np.flatnonzero(u8[v] & in_s)
            evicted_ops = [int(op_of[u]) for u in evict]
            # Snapshot: recursive placements mutate state and `all` short-
            # circuits, so restore wholesale on failure.
            in_s_snap, conf_snap = in_s.copy(), conf.copy()
            for u in evict:
                in_s[u] = False
                conf -= u8[u]
            in_s[v] = True
            conf += u8[v]
            banned[v] = True
            if all(place(eo, d - 1) for eo in evicted_ops):
                banned[v] = False
                return True
            banned[v] = False
            in_s[:] = in_s_snap
            conf = conf_snap
        return False

    placed_ops = {int(op_of[v]) for v in np.flatnonzero(in_s)}
    for op in op_vertices:
        if op not in placed_ops:
            if place(op, depth):
                placed_ops.add(op)
    assert not g.any_conflict(pack_bool(in_s)), "repair broke independence"
    return in_s
