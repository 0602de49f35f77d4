"""Analytic plan estimator: the roofline cost of one training or serving step
under a distribution plan, with no trace and no compile.

The counterpart of ``repro.launch.hlo_cost.estimate_plan``: the same knobs,
the same terms and the same returned keys, priced on a ``Hardware`` record
(``roofline.H100`` by default).  Pure Python, microseconds a call, which is
what makes plan search a cheap objective; the traced dry run
(``launch.dryrun --trace``) and the card's step are its checks.

Where the reference charges every collective at its one link rate, each
term here goes at the rate of its group: tensor-parallel collectives span
``tp`` consecutive devices, the gradient sync over the data axis spans the
whole mesh, and an expert-parallel all-to-all spans its ``g`` devices
(``roofline.within_node``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.roofline import (H100, Hardware, model_flops,
                                         roofline_terms, wire_bytes,
                                         within_node)

# extra forward passes paid to rematerialize activations in the backward
_REMAT_FLOP_MULT = {"none": 1.0, "dots": 7.0 / 6.0, "full": 8.0 / 6.0}
# HBM-traffic factor for activations (reads+writes per token*d_model*layer)
_REMAT_ACT_TRAFFIC = {"none": 18.0, "dots": 12.0, "full": 8.0}
# activations *stored* until the backward (drives the memory model)
_REMAT_ACT_STORED = {"none": 8.0, "dots": 4.0, "full": 1.5}


def estimate_plan(cfg, shape, plan: Dict, n_devices: int = 256,
                  hw: Hardware = H100) -> Dict:
    """Analytic roofline estimate of one training/serving step under a plan.

    ``plan`` knobs (all optional):
      tp (int, default 1)            tensor-parallel group size
      zero ("zero1" | "zero3")       grad sync: one all-reduce per step vs
                                     per-microbatch param regather + RS
      remat ("none"|"dots"|"full")   recompute policy
      micro (int, default 1)         gradient-accumulation microbatches
      seq_parallel (bool)            AG+RS instead of AR on the TP axis
      ep (bool)                      MoE expert parallelism (all-to-all)
      capacity_factor (float)        MoE token capacity

    Returns roofline terms plus ``t_step_s`` (the scalar objective),
    ``hbm_gb`` and ``fits`` (the memory constraint against
    ``hw.hbm_bytes``): deterministic, microseconds per call.
    """
    tp = max(int(plan.get("tp", 1)), 1)
    zero = plan.get("zero", "zero1")
    remat = plan.get("remat", "full")
    micro = max(int(plan.get("micro", 1)), 1)
    seq_parallel = bool(plan.get("seq_parallel", False))
    ep = bool(plan.get("ep", False))
    cf = float(plan.get("capacity_factor", 0.0)) or cfg.capacity_factor

    if n_devices % tp:
        return {"feasible": False, "reason": f"tp={tp} !| {n_devices}",
                "t_step_s": float("inf"), "fits": False}
    dp = n_devices // tp
    train = shape.kind == "train"

    P = float(cfg.param_count()["total"])
    tokens = float(shape.global_batch) * (shape.seq_len if train or
                                          shape.kind == "prefill" else 1)
    tokens_chip = tokens / n_devices
    d, L = float(cfg.d_model), float(cfg.n_layers)

    # -- compute ------------------------------------------------------------
    flops_chip = (model_flops(cfg, shape)
                  * (_REMAT_FLOP_MULT[remat] if train else 1.0) / n_devices)

    # -- HBM traffic per device ---------------------------------------------
    act_traffic = _REMAT_ACT_TRAFFIC[remat] if train else 6.0
    bytes_act = 2.0 * tokens_chip * d * L * act_traffic
    passes = (2.0 + 2.0 * (_REMAT_FLOP_MULT[remat] - 1.0)) if train else 1.0
    bytes_weights = 2.0 * (P / tp) * passes * (micro if train else 1.0)
    # optimizer update: fp32 m/v read+write + master-param update, sharded
    # over dp either way (zero1 shards moments too: same traffic term)
    bytes_opt = (P / (dp * tp)) * (4 * 4 + 4 * 2) if train else 0.0
    hbm_bytes = bytes_act + bytes_weights + bytes_opt

    # -- wire per device, split by link -------------------------------------
    wire = {True: 0.0, False: 0.0}     # within a node?
    grad_bytes = 2.0 * P / tp
    if train and dp > 1:
        if zero == "zero3":
            # per-microbatch bf16 param all-gather + grad reduce-scatter
            w = micro * (wire_bytes("all-gather", grad_bytes, dp)
                         + wire_bytes("reduce-scatter", grad_bytes / dp, dp))
        else:
            w = wire_bytes("all-reduce", grad_bytes, dp)
        wire[within_node(n_devices, hw)] += w
    if tp > 1:
        # Megatron TP: 2 collectives per layer per pass over the sharded
        # activations; seq-parallel swaps AR for AG+RS (~0.75x wire)
        act_layer = 2.0 * (tokens / dp) * d
        n_coll = 2.0 * (3.0 if train else 1.0)
        wire[within_node(tp, hw)] += L * n_coll * wire_bytes(
            "all-reduce", act_layer, tp) * (0.75 if seq_parallel else 1.0)
    n_moe = sum(1 for s in cfg.period if s.ffn == "moe") * (
        cfg.n_periods if cfg.n_experts else 0)
    if ep and n_moe:
        a2a = 2.0 * tokens_chip * d * max(cf, 1.0) * max(cfg.top_k, 1)
        g = min(cfg.n_experts, n_devices)
        wire[within_node(g, hw)] += n_moe * 2.0 * wire_bytes("all-to-all",
                                                             a2a, g)

    terms = roofline_terms(flops_chip, hbm_bytes, wire[True], hw,
                           cross_node_wire_bytes=wire[False])
    # compute and HBM overlap; collectives only partially hide behind
    # compute: charge them serially (pessimistic)
    t_step = max(terms["t_compute_s"], terms["t_memory_s"]) + terms[
        "t_collective_s"]

    # -- memory model -------------------------------------------------------
    params_res = 2.0 * P / tp / (dp if (train and zero == "zero3") else 1.0)
    opt_res = (12.0 * P / (dp * tp)) if train else 0.0
    act_res = (2.0 * (tokens_chip / micro) * d * L
               * _REMAT_ACT_STORED[remat]) if train else (
        2.0 * tokens_chip * d * L * 0.5)
    hbm_gb = (params_res + opt_res + act_res) / 1e9
    return {
        "feasible": True,
        "t_step_s": t_step,
        "t_compute_s": terms["t_compute_s"],
        "t_memory_s": terms["t_memory_s"],
        "t_collective_s": terms["t_collective_s"],
        "dominant": terms["dominant"],
        "hbm_gb": hbm_gb,
        "fits": hbm_gb * 1e9 <= hw.hbm_bytes,
        "plan": {"tp": tp, "zero": zero, "remat": remat, "micro": micro,
                 "seq_parallel": seq_parallel, "ep": ep,
                 "capacity_factor": cf},
    }
