"""Elastic re-mesh: continue training on a degraded device set.

When hosts die, the coordinator computes the largest rectangular mesh
that fits the survivors, re-plans sharding with the SAME planner the
dry-run uses (checkpoints are mesh-agnostic; see checkpoint/ckpt.py), and
resumes from the latest checkpoint.  Scale-UP (recovered hosts) is the
same path with a larger target mesh.

Keeping the mesh rectangular and the model axis intact is deliberate:
TP (model axis) collectives are latency-critical and sized to the
divisibility of heads/d_ff, while the data axis only changes the FSDP
shard count and the per-host batch slice — so we always shrink the
data/pod axes first and never the model axis.
"""

from __future__ import annotations

import math


def degraded_mesh_shape(shape: dict, n_failed_hosts: int,
                        chips_per_host: int = 4) -> dict:
    """Largest viable mesh after losing hosts (shrink pod, then data)."""
    out = dict(shape)
    lost_chips = n_failed_hosts * chips_per_host
    total = math.prod(shape.values())
    remaining = total - lost_chips
    if remaining <= 0:
        raise ValueError("no devices left")
    # shrink pod axis first (whole pods), then the data axis.
    while "pod" in out and out["pod"] > 1 and \
            math.prod(out.values()) > remaining:
        out["pod"] -= 1
    while out.get("data", 1) > 1 and math.prod(out.values()) > remaining:
        out["data"] -= 1
    if math.prod(out.values()) > remaining:
        raise ValueError(f"cannot fit a mesh into {remaining} chips")
    return out


def plan_elastic_restart(cfg, kind: str, seq: int, global_batch: int,
                         old_shape: dict, n_failed_hosts: int,
                         chips_per_host: int = 4):
    """Returns (new_shape, new_batch, notes).  The global batch is kept
    whenever the new data axis still divides it, else reduced to the
    nearest multiple (recorded so the trainer can rescale LR)."""
    new_shape = degraded_mesh_shape(old_shape, n_failed_hosts,
                                    chips_per_host)
    dp = new_shape.get("data", 1) * new_shape.get("pod", 1)
    new_batch = global_batch
    notes = []
    if global_batch % dp:
        new_batch = max(dp, (global_batch // dp) * dp)
        notes.append(f"global_batch {global_batch} -> {new_batch} "
                     f"(data axis {dp})")
    if new_shape != old_shape:
        notes.append(f"mesh {old_shape} -> {new_shape}")
    return new_shape, new_batch, notes
