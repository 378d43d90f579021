"""Bandwidth-allocating sharding planner — BandMap's insight applied to the
TPU mesh (DESIGN.md §2).

The CGRA story: data with spatial reuse degree RD > M forces either
routing PEs (store-and-forward, BusMap) or a *quantitative port/bandwidth
allocation* (multicast, BandMap).  On the mesh the same dichotomy appears
per tensor per step:

- **multicast** — one all-gather/broadcast on the mesh axis whose members
  reuse the tensor (XLA's all-gather uses all links of the axis at once —
  the crossbar-multicast analogue), or replication (RD = axis, zero
  per-step traffic, paid in memory);
- **relay**    — point-to-point / ring schedules (collective-permute
  chains) or, degenerately, re-gathering a tensor some device already
  holds: the "routing PE" of the mesh, spending link bandwidth and a PE
  (device) buffer to re-broadcast.

`plan()` builds a per-step **transfer DFG** (the same `core.dfg.DFG`
class the CGRA mapper uses; every tensor class is a VIO whose consumers
are device groups), computes RD per VIO, and allocates bandwidth:
logical-axis sharding rules + a collective strategy per tensor, plus a
bytes-per-step prediction the roofline pass checks against the compiled
HLO (§Dry-run / §Perf).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.models.transformer import ModelConfig

from .dfg import DFG, OpKind

# bytes per element
BF16 = 2
F32 = 4


@dataclasses.dataclass
class Transfer:
    """One tensor class crossing device boundaries each step."""
    tensor: str
    bytes_total: int          # full (unsharded) tensor bytes
    rd: int                   # spatial reuse degree: #devices needing it
    axis: str                 # mesh axis whose members reuse it
    strategy: str             # multicast | replicate | relay | reduce
    bytes_per_step: int       # predicted link bytes per device per step
    note: str = ""


@dataclasses.dataclass
class Plan:
    arch: str
    shape: str
    mesh_axes: dict           # axis -> size
    rules: dict               # logical axis -> mesh axis (str|tuple|None)
    transfers: list
    grad_compression: bool = False

    @property
    def collective_bytes(self) -> int:
        return sum(t.bytes_per_step for t in self.transfers)

    def summary(self) -> str:
        lines = [f"plan[{self.arch} × {self.shape}] "
                 f"mesh={self.mesh_axes} rules={self.rules}"]
        for t in sorted(self.transfers, key=lambda t: -t.bytes_per_step):
            lines.append(
                f"  {t.tensor:28s} RD={t.rd:<4d} {t.strategy:10s} "
                f"axis={t.axis:6s} {t.bytes_per_step/2**20:10.1f} MiB/step"
                f"  {t.note}")
        return "\n".join(lines)


def schedule_transfer_rounds(plan: "Plan", *, seed: int = 0,
                             max_rounds: int = 64) -> list[list[str]]:
    """Decompose a plan's byte-moving transfers into bandwidth rounds.

    Transfers on the same mesh axis contend for that axis's links — the
    mesh analogue of two ops driving one bus instance — so a round is an
    independent set of the contention graph.  We reuse the CGRA binder's
    packed-bitset MIS engine: peel a maximum independent set per round
    until every transfer is placed.  Returns tensor-name rounds, densest
    first; the round count is the plan's serialization depth (1 = all
    collectives can overlap)."""
    from .bitset import BitsetGraph
    from .mis import solve_mis

    act = [t for t in plan.transfers if t.bytes_per_step > 0]
    rounds: list[list[str]] = []
    remaining = list(range(len(act)))
    for _ in range(max_rounds):
        if not remaining:
            break
        g = BitsetGraph(len(remaining))
        for a in range(len(remaining)):
            for b in range(a + 1, len(remaining)):
                if act[remaining[a]].axis == act[remaining[b]].axis:
                    g.add_edge(a, b)
        # Greedy construction already yields the maximum IS for a union
        # of cliques; a short tabu budget covers non-clique extensions
        # without burning the solver's 20k-iteration default per round.
        sol = solve_mis(g, target=len(remaining), max_iters=200,
                        seed=seed)
        picked = {remaining[i] for i in np.flatnonzero(sol)}
        rounds.append([act[i].tensor for i in
                       sorted(picked, key=lambda i: -act[i].bytes_per_step)])
        remaining = [i for i in remaining if i not in picked]
    if remaining:  # max_rounds exhausted: serialize the tail
        rounds.extend([[act[i].tensor] for i in remaining])
    return rounds


def _param_bytes(cfg: ModelConfig) -> int:
    from repro_torch.models.model import count_params
    return count_params(cfg) * F32


def _layer_classes(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(name, bytes) of per-layer weight classes (full stack totals)."""
    d, L = cfg.d_model, cfg.n_layers
    cls = []
    if cfg.family in ("dense", "moe"):
        if cfg.attn_kind == "mla":
            attn = d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim) \
                + d * cfg.kv_lora + d * cfg.qk_rope_dim \
                + cfg.kv_lora * cfg.n_heads * (cfg.qk_nope_dim
                                               + cfg.v_head_dim) \
                + cfg.n_heads * cfg.v_head_dim * d
        else:
            attn = d * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * cfg.head_dim * d
        cls.append(("attn_w", attn * L * F32))
        if cfg.family == "moe":
            cls.append(("expert_w",
                        3 * cfg.n_experts * d * cfg.moe_d_ff * L * F32))
            if cfg.n_shared_experts:
                cls.append(("shared_w",
                            3 * d * cfg.moe_d_ff * cfg.n_shared_experts
                            * L * F32))
        else:
            mult = 3 if cfg.gated_mlp else 2
            cls.append(("mlp_w", mult * d * cfg.d_ff * L * F32))
    elif cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * d
        ssm = d * (2 * d_inner + 2 * cfg.ssm_groups * cfg.d_state
                   + d_inner // cfg.ssm_head_dim) + d_inner * d
        cls.append(("ssm_w", ssm * L * F32))
        if cfg.family == "hybrid":
            attn = d * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * cfg.head_dim * d + 3 * d * cfg.d_ff
            cls.append(("shared_attn_w", attn * F32))   # ONE copy
    else:  # encdec
        attn = d * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * cfg.head_dim * d
        mult = 3 if cfg.gated_mlp else 2
        cls.append(("attn_w",
                    attn * (cfg.n_layers * 2 + cfg.n_enc_layers) * F32))
        cls.append(("mlp_w", mult * d * cfg.d_ff
                    * (cfg.n_layers + cfg.n_enc_layers) * F32))
    cls.append(("embed_w", cfg.vocab * d * F32 *
                (1 if cfg.tie_embeddings else 2)))
    return cls


def build_transfer_dfg(cfg: ModelConfig, kind: str, seq: int, batch: int,
                       mesh_axes: dict) -> tuple[DFG, dict]:
    """Transfer DFG: one VIO per reused tensor class; consumers are device
    groups.  RD(VIO) is literally `DFG.rd` — the paper's quantity."""
    dp = mesh_axes.get("data", 1) * mesh_axes.get("pod", 1)
    tp = mesh_axes.get("model", 1)
    dfg = DFG()
    meta: dict[int, dict] = {}

    def vio(name, nbytes, rd, axis):
        v = dfg.add_op(OpKind.VIN, name)
        consumers = [dfg.add_op(OpKind.COMPUTE, f"{name}.c{i}")
                     for i in range(rd)]
        for c in consumers:
            dfg.add_edge(v, c)
        meta[v] = dict(name=name, bytes=nbytes, axis=axis)
        return v

    for name, nbytes in _layer_classes(cfg):
        if kind == "train":
            # FSDP-sharded weights: every data-axis member re-reads the
            # full tensor every step -> RD = dp (highest-RD VIOs).
            vio(f"{name}.fsdp_gather", nbytes, dp, "data")
            vio(f"{name}.grad_reduce", nbytes, dp, "data")
        else:
            vio(f"{name}.serve_read", nbytes, tp, "model")

    tok_bytes = batch * seq * cfg.d_model * BF16
    if kind == "train" and tp > 1:
        vio("tp_activations", tok_bytes, tp, "model")
    if cfg.family == "moe" and kind != "decode":
        vio("moe_dispatch", tok_bytes * cfg.top_k, min(tp, cfg.n_experts),
            "model")
    if kind == "decode":
        step_bytes = batch * cfg.d_model * BF16
        vio("tp_partial_out", step_bytes, tp, "model")
        if cfg.family == "encdec":
            vio("cross_kv", cfg.enc_seq * batch
                * cfg.n_heads * cfg.head_dim * 2 * BF16, tp, "model")
    return dfg, meta


def plan(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh,
         *, optimized: bool = False, arch: str = "", shape: str = "") -> Plan:
    """Allocate bandwidth for every transfer-DFG VIO and emit sharding
    rules.  ``optimized=False`` is the paper-faithful baseline (BandMap's
    straightforward policy); ``optimized=True`` adds the beyond-paper
    knobs recorded in EXPERIMENTS §Perf."""
    mesh_axes = dict(mesh.shape)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    dp = math.prod(mesh_axes[a] for a in dp_axes)
    tp = mesh_axes.get("model", 1)

    dfg, meta = build_transfer_dfg(cfg, kind, seq, batch, mesh_axes)

    # ---------------- bandwidth allocation (the BandMap policy) ----------
    # M = "PEs per bus" analogue: members of one mesh axis reachable by a
    # single multicast drive.  RD > M would need multiple "ports" — on the
    # mesh, hierarchical collectives (per-axis stages).
    transfers: list[Transfer] = []
    for v in dfg.v_i:
        m = meta[v]
        rd = dfg.rd(v)
        axis_size = mesh_axes.get(m["axis"], 1)
        axis_links = max(axis_size - 1, 1)
        name, nbytes = m["name"], m["bytes"]
        if name.endswith(".grad_reduce"):
            # reduce: ring all-reduce 2·(n-1)/n per link; optionally int8
            per = int(2 * nbytes * axis_links / max(axis_size, 1))
            if optimized and "pod" in mesh_axes:
                per = per // 4 + nbytes // 4   # int8 across-pod stage
            transfers.append(Transfer(name, nbytes, rd, m["axis"],
                                      "reduce", per,
                                      "ring all-reduce of grads"))
        elif name.endswith(".fsdp_gather"):
            per = int(nbytes * axis_links / max(axis_size, 1))
            transfers.append(Transfer(name, nbytes, rd, m["axis"],
                                      "multicast", per,
                                      "FSDP all-gather (fwd+bwd reuse)"))
        elif name.endswith(".serve_read"):
            # weights TP-sharded and resident: RD satisfied by placement
            transfers.append(Transfer(name, nbytes, rd, m["axis"],
                                      "replicate", 0,
                                      "resident shard, no per-step bytes"))
        elif name == "moe_dispatch":
            per = int(nbytes / max(axis_size, 1))
            transfers.append(Transfer(name, nbytes, rd, m["axis"],
                                      "relay", per, "token all-to-all"))
        else:
            per = int(nbytes * axis_links / max(axis_size, 1))
            transfers.append(Transfer(name, nbytes, rd, m["axis"],
                                      "multicast", per,
                                      "TP partial-sum all-reduce"))

    # ---------------- sharding rules ------------------------------------
    rules: dict = {
        "batch": dp_axes if batch % dp == 0 else None,
        "seq": None,
        "embed": None,
        "vocab": "model",
        "heads": "model", "kv_heads": "model", "head_dim": None,
        "heads_merged": "model",
        "mlp": "model", "expert": None,
        "kv_lora": None,
        "ssm_inner": "model", "ssm_heads": "model", "ssm_state": None,
        "conv_w": None, "layer": None,
    }
    if kind == "train":
        rules["embed"] = "data"        # FSDP on the in-pod data axis
    if batch % dp != 0:
        # long_500k (batch 1): shard the sequence/cache over data —
        # flash-decoding style; the softmax reduce is the multicast.
        rules["seq"] = "data"
        rules["batch"] = None
    if optimized and kind == "decode" and rules["seq"] is None:
        # Flash-decoding: shard the KV-cache sequence over the model axis
        # (the per-step cache re-read is the dominant memory term; kv
        # heads that don't divide 16 would otherwise replicate the whole
        # cache — qwen1.5's 20 heads, mixtral's 8).  Rules drop duplicate
        # axes, so kv_heads→model yields to seq→model automatically.
        rules["seq"] = "model"
    if optimized and kind == "decode":
        # Secondary head_dim sharding: archs whose head count doesn't
        # divide the model axis (qwen1.5: 20) fall back to replicated
        # attention weights — shard the head_dim instead (128 % 16 == 0
        # everywhere).  The duplicate-axis drop makes this a no-op when
        # heads already took the model axis.
        rules["head_dim"] = "model"
    if optimized and kind == "train":
        rules["seq"] = "model"         # Megatron-SP residuals
    return Plan(arch=arch or cfg.name, shape=shape or kind,
                mesh_axes=mesh_axes, rules=rules, transfers=transfers,
                grad_compression=optimized and "pod" in mesh_axes)


def mesh_stub(axes: dict):
    """Planner-facing mesh stand-in: `plan` only reads ``mesh.shape``,
    so callers with no device mesh (the serving driver's plan report)
    pass this instead (the reference's ``launch/mesh.mesh_stub``)."""
    import types
    return types.SimpleNamespace(shape=dict(axes))
