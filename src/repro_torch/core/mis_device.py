"""GPU-resident SBTS portfolio: K lock-step tabu trajectories as batched
torch operations over packed adjacency words.

`DeviceSBTS` is the ``engine="device"`` counterpart of
`mis.PortfolioSBTS` (the numpy oracle).  The whole ``[K, n_pad]`` state
lives on ``device`` and one lock-step iteration advances every
trajectory:

- **Conflict counts** come from the hand-written CUDA kernel in
  `kernels.sbts_step` (its plain torch version for CPU tensors): one
  AND + popcount contraction gives |N(v) ∩ S_k| for every
  (trajectory, vertex) pair, three times per iteration — on the
  selection, the addable set and the Luby sample.
- **The step** (`lockstep`) is the reference's per-seed update written
  over a leading K axis: ``argmax(dim=1)`` where the reference vmaps an
  argmax, indexed assignment where it uses ``.at[].set``.
- **Draws are an argument of the step.**  `draws` is the port's own
  counter-based generator: integer hashing keyed on (seed, trajectory,
  iteration, channel, lane), in int64 arithmetic that never overflows,
  so CPU and CUDA produce the same bits and a CPU run of the engine is
  bit-comparable with a CUDA run.  It does not reproduce the
  reference's threefry bits; tests that hold the step to the reference
  feed it the reference's draws instead.
- **Host syncs** happen once per ``chunk`` iterations (the best sizes
  are read back for the early exit); harvest re-seeding (`rearm`,
  `reset_seed`) keeps the reference's numpy counter RNG and copies one
  trajectory's rows between host and device.

Step semantics are the reference's (`repro.core.mis_device`): an add
phase (all safe addables plus the winners of a degree-aware Luby round,
or the top-priority clustered addable alone), else a swap phase (the
top-priority vertex with one selected neighbour replaces it, which
becomes tabu for ``tenure + U{0..3}`` iterations), then a plateau
perturbation that evicts a random ~10% slice once ``thresh``
iterations pass without a better best.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.sbts_step import selection_counts

from .bitset import BitsetGraph, pack_words, unpack_words

_LANE = 128          # pad n to a multiple of this; always a multiple of 32
_PERTURB_FRAC = 0.1  # eviction probability per member on a plateau
_M32 = 0xFFFFFFFF

#: State tensors in the order `lockstep` takes and returns them.
STATE_FIELDS = ("in_s", "tabu", "stall", "thresh", "best", "best_size")


def _pad_n(n: int) -> int:
    return max(_LANE, -(-n // _LANE) * _LANE)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: the port runs on the card unless the
    caller asks for the CPU.  A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "device engine on the host")
    return dev


# ------------------------------------------------------ the generator
def _mix32(x):
    """A 32-bit avalanche hash of values in [0, 2**32), held as int64
    tensors or Python ints.  Both multipliers are below 2**31, so no
    product reaches 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _key(*parts: int) -> int:
    """Hash a tuple of ints to one 32-bit key (on the host)."""
    h = 0x9E3779B9
    for p in parts:
        for word in (p & _M32, (p >> 32) & _M32):
            h = _mix32(h ^ word)
    return h


def draws(seed: int, k: int, n_pad: int, it: int,
          device) -> tuple[torch.Tensor, ...]:
    """The port's per-iteration randomness for K trajectories:
    ``r1``, ``r2`` float32 ``[K, n_pad]`` in [0, 1) (24-bit), ``j4``
    int32 ``[K]`` in [0, 4) and ``dth`` int32 ``[K]`` in [0, 24).  A
    pure function of (seed, trajectory, iteration, channel, lane)."""
    base = _key(int(seed), int(it))
    traj = torch.arange(k, dtype=torch.int64, device=device)
    h_k = _mix32(traj ^ base)                                   # [K]
    chan = torch.arange(4, dtype=torch.int64, device=device)
    h_kc = _mix32(h_k[None, :] ^ _mix32(chan + 0x51ED27)[:, None])
    lane = _mix32(torch.arange(n_pad, dtype=torch.int64,
                               device=device) + 0x2545F491)
    bits = _mix32(h_kc[:2, :, None] ^ lane[None, None, :])      # [2,K,n]
    r = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    j4 = (h_kc[2] & 3).to(torch.int32)
    dth = torch.remainder(h_kc[3], 24).to(torch.int32)
    return r[0], r[1], j4, dth


# ---------------------------------------------------------- the step
def _counts(rows32: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    return selection_counts(rows32, pack_words(bits))


def lockstep(rows32: torch.Tensor, state: tuple, it: int, draws: tuple,
             *, n: int, tenure: int) -> tuple:
    """One lock-step iteration of every trajectory.

    ``rows32``: int32 ``[n_pad, n_pad//32]`` adjacency words;
    ``state``: (in_s bool [K, n_pad], tabu int32 [K, n_pad], stall
    int32 [K], thresh int32 [K], best bool [K, n_pad], best_size int32
    [K]), the `STATE_FIELDS` order; ``draws``: (r1, r2, j4, dth) as `draws`
    returns them.  Returns the new state; the inputs are not modified
    (the in-place scatters below write fresh clones)."""
    in_s, tabu, stall, thresh, best, best_size = state
    r1, r2, j4, dth = draws
    k, n_pad = in_s.shape
    dev = in_s.device
    ar = torch.arange(k, device=dev)
    valid = (torch.arange(n_pad, device=dev) < n)[None, :]
    free = tabu <= it

    conf = _counts(rows32, in_s)
    addable = valid & ~in_s & (conf == 0) & free
    aconf = _counts(rows32, addable)
    # float32 throughout, as the reference computes the Luby threshold.
    samp = addable & (aconf > 0) \
        & (r1 < 1.0 / (1.0 + aconf.to(torch.float32)))
    sconf = _counts(rows32, samp)

    # ---- add phase: safe set + Luby winners (+ forced fallback)
    any_add = addable.any(dim=1)
    safe = addable & (aconf == 0)
    winners = samp & (sconf == 0)
    clustered = addable & ~safe
    v_add = torch.where(clustered, r1, -1.0).argmax(dim=1)
    force = clustered.any(dim=1) & ~safe.any(dim=1) & ~winners.any(dim=1)
    add_mask = safe | winners
    add_mask[ar, v_add] |= force                 # in place, on a fresh mask
    in_s_add = in_s | add_mask

    # ---- swap phase: conf==1 vertex in, its unique neighbour out
    swapable = valid & ~in_s & (conf == 1) & free
    r_swap = torch.where(swapable, r1, -1.0)
    v_swap = r_swap.argmax(dim=1)
    has_swap = r_swap[ar, v_swap] > 0.0
    row_v = unpack_words(rows32[v_swap])
    # argmax rejects bool: cast first; ties (and all-False) give the
    # first index, as jnp.argmax does.
    u_out = (row_v & in_s).to(torch.uint8).argmax(dim=1)
    # Scatters in place, on clones; written as where() over every
    # trajectory rather than a boolean index, which would sync the host.
    in_s_swap = in_s.clone()
    in_s_swap[ar, u_out] = in_s[ar, u_out] & ~has_swap
    in_s_swap[ar, v_swap] = in_s_swap[ar, v_swap] | has_swap
    tabu_swap = tabu.clone()
    tabu_swap[ar, u_out] = torch.where(has_swap, it + tenure + j4,
                                       tabu[ar, u_out])
    stall_swap = stall + torch.where(has_swap, 1, 3).to(torch.int32)

    # ---- pick the phase, update the best
    add_k = any_add[:, None]
    in_s2 = torch.where(add_k, in_s_add, in_s_swap)
    tabu2 = torch.where(add_k, tabu, tabu_swap)
    stall2 = torch.where(any_add, stall, stall_swap)
    size2 = in_s2.sum(dim=1, dtype=torch.int32)
    better = size2 > best_size
    best2 = torch.where(better[:, None], in_s2, best)
    bsz2 = torch.maximum(best_size, size2)
    stall3 = torch.where(better, 0, stall2).to(torch.int32)

    # ---- plateau perturbation
    pert = stall3 >= thresh
    evict = in_s2 & (r2 < _PERTURB_FRAC)
    top = torch.where(in_s2, r2, -1.0).argmax(dim=1)
    evict[ar, top] = in_s2.any(dim=1)            # in place, on a fresh mask
    pert_k = pert[:, None]
    in_s3 = torch.where(pert_k, in_s2 & ~evict, in_s2)
    tabu3 = torch.where(pert_k & evict,
                        (it + tenure + j4)[:, None].to(torch.int32), tabu2)
    stall4 = torch.where(pert, 0, stall3).to(torch.int32)
    thresh2 = torch.where(pert, 60 + dth, thresh).to(torch.int32)
    return in_s3, tabu3, stall4, thresh2, best2, bsz2


# -------------------------------------------------------- the engine
class DeviceSBTS:
    """GPU-resident drop-in for the `PortfolioSBTS` harvest-loop surface:
    ``run`` / ``best`` / ``best_size`` / ``it`` / ``rearm`` /
    ``reset_seed`` / ``row_cache``.  ``device=None`` is the GPU (see
    `resolve_device`); ``device="cpu"`` runs the same engine on the host
    through the kernel's plain version.  ``inits`` entries must be
    independent sets (e.g. `conflict.constructive_init` results);
    ``None`` entries and the seeds beyond ``len(inits)`` start cold.

    The state tensors (`STATE_FIELDS`) live on the device in
    ``self.state``; ``in_s`` / ``tabu`` / ``stall`` / ``thresh`` /
    ``best_size`` / ``best`` read them back as numpy arrays."""

    def __init__(self, g: BitsetGraph, inits=None, *, k: int = 1024,
                 tenure: int = 7, seed: int = 0, chunk: int = 64,
                 device=None):
        self.device = resolve_device(device)
        self.g = g
        n = g.n
        self.k = int(max(k, len(inits) if inits else 0))
        self.tenure = int(tenure)
        self.seed = int(seed)
        self.chunk_size = int(chunk)
        self.it = 0
        self._n_pad = _pad_n(n)
        in_s = np.zeros((self.k, self._n_pad), dtype=bool)
        for i, init in enumerate(inits or []):
            if init is not None:
                in_s[i, :n] = np.asarray(init, dtype=bool)
        self._set_state(
            in_s=in_s,
            tabu=np.zeros((self.k, self._n_pad), dtype=np.int32),
            stall=np.zeros(self.k, dtype=np.int32),
            thresh=(60 + np.arange(self.k) % 24).astype(np.int32),
            best=in_s.copy(),
            best_size=in_s.sum(axis=1).astype(np.int32))
        self._rows32 = g.rows_i32(self._n_pad, self.device) \
            if n and self.k else None

    def _set_state(self, **arrays) -> None:
        self.state = tuple(
            torch.as_tensor(np.ascontiguousarray(arrays[f]),
                            device=self.device) for f in STATE_FIELDS)

    def _host(self, field: str) -> np.ndarray:
        """A host copy of one state tensor (never a view of the state,
        which `_resync` writes in place)."""
        t = self.state[STATE_FIELDS.index(field)]
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    # ------------------------------------------------------- results
    in_s = property(lambda self: self._host("in_s"))
    tabu = property(lambda self: self._host("tabu"))
    stall = property(lambda self: self._host("stall"))
    thresh = property(lambda self: self._host("thresh"))
    best_size = property(lambda self: self._host("best_size"))

    @property
    def best(self) -> np.ndarray:
        """Per-seed best memberships ``bool [K, n]``."""
        return self._host("best")[:, :self.g.n]

    def row_cache(self) -> np.ndarray:
        """Unpacked 0/1 adjacency for host-side repair consumers —
        same contract as `PortfolioSBTS.row_cache`."""
        return self.g.rows_u8(np.arange(self.g.n))

    # ----------------------------------------------------------- run
    def run(self, max_iters: int, target: int | None = None,
            cancel=None, tracer=None) -> np.ndarray:
        """Advance every trajectory up to ``max_iters`` lock-step
        iterations; early-exit (at chunk granularity) once any seed's
        best reaches ``target``.  ``cancel`` is polled between chunks.
        Returns per-seed best memberships ``bool [K, n]``."""
        from repro_torch.obs.trace import live
        iters_counter = live(tracer).counter("portfolio.iters")
        if self.g.n == 0 or self.k == 0:
            return self.best
        if target is not None and (self.best_size >= target).any():
            return self.best
        done = 0
        while done < max_iters:
            if cancel is not None and cancel.is_set():
                break
            n_steps = min(self.chunk_size, max_iters - done)
            for i in range(n_steps):
                it = self.it + i
                self.state = lockstep(
                    self._rows32, self.state, it,
                    draws(self.seed, self.k, self._n_pad, it, self.device),
                    n=self.g.n, tenure=self.tenure)
            self.it += n_steps
            done += n_steps
            iters_counter.inc(n_steps)
            if target is not None and \
                    bool((self.state[5] >= target).any()):
                break
        return self.best

    # ------------------------------------------- harvest re-seeding
    def _rng(self, k: int) -> np.random.Generator:
        """Counter-based host RNG: a pure function of
        (seed, trajectory, iteration) — resume-safe like the device
        streams."""
        return np.random.default_rng((self.seed, k, self.it))

    def rearm(self, k: int, frac: float = 0.25) -> None:
        """Diversify seed ``k`` from its harvested best: evict a
        random slice, tabu it out, reset the best tracking (mirrors
        `PortfolioSBTS.rearm`)."""
        in_s = self.state[4][k].cpu().numpy()
        tabu = self.state[1][k].cpu().numpy()
        members = np.flatnonzero(in_s)
        if members.size:
            rng = self._rng(k)
            evict = rng.choice(
                members, size=max(1, int(members.size * frac)),
                replace=False)
            in_s[evict] = False
            tabu[evict] = self.it + 3 * self.tenure + rng.integers(0, 10)
        self._resync(k, in_s, tabu)

    def reset_seed(self, k: int, init: np.ndarray | None = None) -> None:
        """Fully restart trajectory ``k`` from ``init`` (or cold)."""
        in_s = np.zeros(self._n_pad, dtype=bool)
        if init is not None:
            in_s[:self.g.n] = np.asarray(init, dtype=bool)
        self._resync(k, in_s, np.zeros(self._n_pad, dtype=np.int32))

    def _resync(self, k: int, in_s: np.ndarray, tabu: np.ndarray) -> None:
        """Write trajectory ``k``'s rows back to the device (in place)."""
        row = torch.as_tensor(in_s, device=self.device)
        s_in, s_tabu, stall, _thresh, best, best_size = self.state
        s_in[k] = row
        s_tabu[k] = torch.as_tensor(tabu, device=self.device)
        stall[k] = 0
        best[k] = row
        best_size[k] = int(in_s.sum())


def load_state(engine: DeviceSBTS, arrays: dict) -> None:
    """Load a trajectory state held as numpy arrays — ``in_s``, ``tabu``,
    ``stall``, ``thresh``, ``best``, ``best_size`` with the reference
    engine's shapes and dtypes (``[K, n_pad]`` padded rows) — onto
    ``engine``'s device.  An ``it`` entry, if present, sets the
    iteration counter."""
    shapes = {f: tuple(t.shape) for f, t in zip(STATE_FIELDS,
                                                 engine.state)}
    for f in STATE_FIELDS:
        a = np.asarray(arrays[f])
        if a.shape != shapes[f]:
            raise ValueError(f"{f}: shape {a.shape}, engine holds "
                             f"{shapes[f]}")
    engine._set_state(**{
        f: np.asarray(arrays[f],
                      dtype=bool if f in ("in_s", "best") else np.int32)
        for f in STATE_FIELDS})
    if "it" in arrays:
        engine.it = int(arrays["it"])


def differential_vs_numpy(g: BitsetGraph, *, inits=None, iters: int = 512,
                          k: int = 8, seed: int = 0,
                          target: int | None = None,
                          device=None) -> dict:
    """Run `DeviceSBTS` and `mis.PortfolioSBTS` on the same graph at equal
    seed count and equal lock-step iteration budget and report the
    shared invariants: every best an independent set on both engines,
    and each engine's best coverage."""
    from .bitset import pack_bool
    from .mis import PortfolioSBTS

    if inits is None:
        inits = [None] * k
    dev = DeviceSBTS(g, inits, k=k, seed=seed, device=device)
    ref = PortfolioSBTS(g, list(inits), seed=seed)
    dev_best = dev.run(iters, target=target)
    ref_best = ref.run(iters, target=target)
    dev_ok = all(not g.any_conflict(pack_bool(row)) for row in dev_best)
    ref_ok = all(not g.any_conflict(pack_bool(row)) for row in ref_best)
    return dict(
        n=g.n, k=k, iters=iters,
        device_cov=int(dev.best_size.max()) if dev.k else 0,
        numpy_cov=int(ref.best_size.max()) if ref.k else 0,
        device_independent=dev_ok, numpy_independent=ref_ok)
