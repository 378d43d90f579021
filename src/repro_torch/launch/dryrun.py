"""Multi-pod dry run: prove the distribution plan coherent for every (arch
× shape × mesh) cell and extract the roofline terms — the port's
counterpart of the reference's ``launch/dryrun.py``.

Usage (CPU only: the trace runs on the ``meta`` device and allocates
nothing, so no card is needed):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \
      --shape train_4k --mesh single [--plan optimized] \
      [--out artifacts/dryrun_torch]

The reference lowers and compiles each cell against 512 placeholder
host devices.  The port has no such devices and no compiler: `trace_cell`
(the counterpart of ``lower_cell``) builds the model, the optimizer
state, the batch and the cache on ``meta``, installs the planner's rules
(`launch.sharding.use_rules`) and runs the train, prefill or decode step
under `launch.op_analysis` — train runs the forward, the remat
recompute, the backward and the AdamW update.  Every parameter, state,
cache and batch leaf gets its spec from the rules, and the per-device
bytes of the step's arguments and outputs follow from those specs
(`sharding.shard_shape`).  The trace is global, one logical device: its
dot FLOPs and bytes are divided by the mesh's chips for the per-device
terms, and the collective term is the planner's prediction.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.configs import SHAPES, applicable, get_config, input_specs
from repro_torch.core import planner as planner_mod
from repro_torch.launch import op_analysis
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, mesh_device_count
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import AdamW

# Roofline denominators: one NVIDIA H100 80GB HBM3 (SXM5) at 700 W, from
# NVIDIA's H100 Tensor Core GPU datasheet (the port's card, not the
# reference's TPU v5e).
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
# NVLink 4: 900 GB/s a card, 450e9 B/s a direction.  It joins the cards
# of one 8-card node only; the production meshes span many nodes, so the
# collective term is a floor.
LINK_BW = 450e9

#: The reference's per-step metrics: replicated scalars of 4 bytes.
TRAIN_METRICS = ("ce", "aux", "zloss", "ntokens", "loss", "grad_norm",
                 "step")


# ------------------------------------------------------------ cache axes
def cache_axes_for_path(path: str, shape: tuple) -> tuple:
    p = path.lower()
    nd = len(shape)
    if "/c_kv/" in p:
        return ("layer", "batch", "seq", "kv_lora")
    if "/k_pe/" in p:
        return ("layer", "batch", "seq", None)
    if "/conv/" in p:
        return ("layer", "batch", None, "ssm_inner")
    if "/ssm/" in p:
        return ("layer", "batch", "ssm_heads", None, "ssm_state")
    if "cross_kv" in p:
        return ("layer", "batch", "seq", "heads", "head_dim")
    if p.endswith("/k/") or p.endswith("/v/"):
        return ("layer", "batch", "seq", "kv_heads", "head_dim")
    if "/pos/" in p:
        return ("layer",)[: nd]
    return (None,) * nd


def batch_axes_for_path(path: str, shape: tuple) -> tuple:
    if "embeds" in path:
        return ("batch", "seq", "embed")
    return ("batch", "seq")[: len(shape)]


def tree_shardings(tree: dict, axes_fn, rules: sh.Rules) -> dict:
    """Path string -> (shape, dtype, spec) of every leaf of a batch or
    cache tree (`sharding.tree_leaves_with_path`)."""
    return {path: (shape, dtype, rules.spec_for(axes_fn(path, shape), shape))
            for path, shape, dtype in sh.tree_leaves_with_path(tree)}


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top-k of routed experts)."""
    n = M.count_params(cfg)
    if cfg.family == "moe" and cfg.n_experts:
        routed = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff \
            * cfg.n_layers
        n -= routed * (cfg.n_experts - cfg.top_k) // cfg.n_experts
    return n


def model_flops(cfg: ModelConfig, kind: str, tokens: int) -> float:
    """Useful FLOPs: 6·N_active·D for training, 2·N_active·D forward."""
    n_act = active_params(cfg)
    return (6.0 if kind == "train" else 2.0) * n_act * tokens


# --------------------------------------------------------------- tracing
def build_step(cfg: ModelConfig, kind: str, rules, optimizer):
    """The step of ``kind`` under ``rules``: train takes (state, batch),
    prefill and decode (model, batch, cache)."""
    if kind == "train":
        train_step = M.make_train_step(cfg, optimizer)

        def fn(state, batch):
            with sh.use_rules(rules):
                return train_step(state, batch)
        return fn
    step = M.prefill_step if kind == "prefill" else M.serve_step

    def fn(model, batch, cache):
        with sh.use_rules(rules):
            return step(cfg, model, batch, cache)
    return fn


def per_device_bytes(leaves: dict, mesh_shape: dict) -> int:
    """The bytes one device holds of ``leaves`` (path -> (shape, dtype,
    spec))."""
    return sum(math.prod(sh.shard_shape(shape, spec, mesh_shape)) *
               torch.empty((), dtype=dtype).element_size()
               for shape, dtype, spec in leaves.values())


def state_shardings(params: dict, opt_state: dict, rules) -> dict:
    """Path -> (shape, dtype, spec) of a train state's leaves: the
    parameters and AdamW's ``mu`` and ``nu`` as the reference's stacked
    leaves, AdamW's ``count`` and the step counter (0-d int32,
    replicated)."""
    leaves = sh.stacked_shardings(params.items(), rules)
    for key in ("mu", "nu"):
        leaves.update(sh.stacked_shardings(opt_state[key].items(), rules,
                                           (key,)))
    leaves["/count/"] = ((), torch.int32, ())
    leaves["/step/"] = ((), torch.int32, ())
    return leaves


def trace_cell(arch: str, shape: str, *, multi_pod: bool,
               optimized: bool = False) -> dict:
    """Trace one cell on the meta device; returns the result record with
    the reference's ``lower_cell`` keys (``lower_s`` is the trace's
    wall; nothing is compiled, so ``compile_s`` is None)."""
    cell = SHAPES[shape]
    cfg = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    if optimized:
        # The reference's optimized variant: capacity MoE, bf16 logits
        # (bf16 backward cotangents), absorbed-MLA decode.
        cfg = dataclasses.replace(
            cfg, moe_impl="capacity", logits_dtype="bfloat16",
            mla_absorbed=True)
    ok, reason = applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "skipped": True, "reason": reason}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_device_count(mesh)
    plan = planner_mod.plan(cfg, cell.kind, cell.seq_len, cell.global_batch,
                            mesh, optimized=optimized, arch=arch,
                            shape=shape)
    rules = sh.Rules(plan.rules, mesh)
    specs = input_specs(cfg, cell)
    optimizer = AdamW()
    model = T.build_model(cfg, device=torch.device("meta"))
    params = dict(model.named_parameters())
    batch = tree_shardings(specs["batch"], batch_axes_for_path, rules)
    t0 = time.time()

    if cell.kind == "train":
        model.requires_grad_()
        opt_state = M.opt_state_specs(params)
        step = torch.zeros((), dtype=torch.int32, device="meta")
        args = state_shardings(params, opt_state, rules)
        state_bytes = per_device_bytes(args, mesh.shape)
        fn = build_step(cfg, "train", rules, optimizer)
        ana = op_analysis.analyze(fn, (model, opt_state, step),
                                  specs["batch"])
        out_bytes = state_bytes + 4 * len(TRAIN_METRICS)
    else:
        cache = {"/cache" + p: v for p, v in tree_shardings(
            specs["cache"], cache_axes_for_path, rules).items()}
        args = {**sh.stacked_shardings(params.items(), rules), **cache}
        fn = build_step(cfg, cell.kind, rules, optimizer)
        ana = op_analysis.analyze(fn, model, specs["batch"], specs["cache"])
        logits = ana["out"][-2 if cell.kind == "decode" else 0]
        outs = {"/logits/": (tuple(logits.shape), logits.dtype, rules.spec_for(
            ("batch", "seq", "vocab"), tuple(logits.shape)))}
        if cell.kind == "decode":
            nxt = ana["out"][0]
            outs["/next/"] = (tuple(nxt.shape), nxt.dtype, rules.spec_for(
                ("batch", "seq"), tuple(nxt.shape)))
        out_bytes = per_device_bytes({**outs, **cache}, mesh.shape)
    arg_bytes = per_device_bytes({**args, **{"/batch" + p: v for p, v in
                                             batch.items()}}, mesh.shape)
    t_trace = time.time() - t0

    flops_dev = ana["dot_flops"] / chips
    bytes_dev = ana["hbm_bytes"] / chips
    coll_dev = float(plan.collective_bytes)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mf = model_flops(cfg, cell.kind, tokens)

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "optimized": optimized, "chips": chips, "skipped": False,
        "lower_s": round(t_trace, 1), "compile_s": None,
        "per_device": {
            "hlo_flops": flops_dev, "hlo_bytes": bytes_dev,
            "collective_bytes": coll_dev,
            "collective_detail": {
                "bytes": ana["collective_bytes"],
                "counts": ana["collective_counts"]},
            "cost_analysis_flops_uncorrected": None,
            "cost_analysis_bytes_uncorrected": None,
            "source": ("hlo_flops and hlo_bytes: the global op-level "
                       "trace's dot FLOPs and bytes (launch.op_analysis) "
                       "divided by the mesh's chips; collective_bytes: "
                       "the planner's predicted bytes a device a step "
                       "(plan.collective_bytes); the trace holds no "
                       "collective"),
        },
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": None,
        },
        "roofline": {
            **{k: float(v) for k, v in terms.items()},
            "dominant": dominant,
            "model_flops_total": mf,
            "hlo_flops_total": ana["dot_flops"],
            "useful_flops_ratio": mf / max(ana["dot_flops"], 1.0),
            "roofline_fraction": max(terms.values()) and
            compute_s / max(terms.values()),
            "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
            "hardware": "NVIDIA H100 80GB HBM3, 700 W (datasheet rates)",
        },
        "kernels": ana["kernels"],
        "top_ops": [list(r) for r in ana["counter"].top_ops(10)],
        "activations": list(rules.constrained.values()),
        "planner": {
            "rules": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in plan.rules.items()},
            "predicted_collective_bytes": plan.collective_bytes,
            "transfers": [dataclasses.asdict(t) for t in plan.transfers],
        },
    }
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--plan", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    rec = trace_cell(args.arch, args.shape,
                     multi_pod=args.mesh == "multi",
                     optimized=args.plan == "optimized")
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{args.mesh}" + \
        ("__opt" if args.plan == "optimized" else "")
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec.get("skipped"):
        print(f"SKIP {tag}: {rec['reason']}")
    else:
        r = rec["roofline"]
        print(f"PASS {tag}: trace={rec['lower_s']}s "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s dom={r['dominant']} "
              f"useful={r['useful_flops_ratio']:.2f}")
    return rec


if __name__ == "__main__":
    main()
