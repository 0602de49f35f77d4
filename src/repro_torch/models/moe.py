"""Mixture-of-Experts with sort-based capacity dispatch.

The counterpart of ``repro.models.moe``, in plain PyTorch on both devices
(the JAX package has no kernel here): fp32 routing (softmax, top-k, the
top-k weights renormalised), the Switch load-balance and router-z
auxiliaries, then a per-row dispatch driven by a stable sort of the expert
assignments.  Each expert takes at most C = capacity tokens; the earliest
tokens win (stable sort) and the rest are dropped (weight 0).  Experts run
as batched products over (E, C) rows, and the combine gathers each slot's
output back, unsorts it and sums the top-k weighted outputs.  qwen2-moe's
always-on shared experts add a sigmoid-gated dense MLP.

The reference's ``.at[].set`` / ``.at[].add`` scatters are ``index_put_`` /
``index_add_``; overflow slots all write the sentinel column E * C, which is
sliced off, so the order of their duplicate writes does not matter.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Runtime, act_fn, dense_init
from repro_torch.models.mlp import mlp, mlp_init

# leaves the reference keeps in fp32 whatever the parameter dtype
FP32_PARAMS = ("router",)


def moe_capacity(cfg: ArchConfig, rt: Runtime, S: int) -> int:
    cf = rt.moe_capacity_factor or cfg.capacity_factor
    c = int(-(-S * cfg.top_k * cf // cfg.n_experts))  # ceil
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d, (d, E), torch.float32),
        "wg": dense_init(gen, d, (E, d, f), rt.param_dtype),
        "wu": dense_init(gen, d, (E, d, f), rt.param_dtype),
        "wd": dense_init(gen, f, (E, f, d), rt.param_dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, rt,
                               d_ff=cfg.n_shared_experts * cfg.moe_d_ff)
        p["shared_gate"] = dense_init(gen, d, (d, 1), rt.param_dtype)
    return p


def moe(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), {moe_lb_loss, moe_router_z,
    moe_drop_frac})."""
    cd = rt.compute_dtype
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, rt, S)
    N = S * K
    dev = x.device

    # ---- routing (fp32) ----------------------------------------------------
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)              # (B, S, K)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    # ---- aux losses (Switch LB + router z) ----------------------------------
    me = probs.mean(dim=(0, 1))                              # (E,)
    ce_frac = torch.zeros(E, device=dev).index_add_(
        0, top_e.reshape(-1),
        torch.full((B * S * K,), 1.0 / (B * S * K), device=dev))
    lb_loss = E * (me * ce_frac).sum()
    router_z = torch.logsumexp(logits, dim=-1).square().mean()

    # ---- sort-based dispatch (per batch row) --------------------------------
    fid = top_e.reshape(B, N)                                # expert per slot
    fw = top_w.reshape(B, N)
    order = torch.argsort(fid, dim=-1, stable=True)          # (B, N)
    sid = torch.gather(fid, 1, order)
    stok = order // K                                        # token, sorted
    sw = torch.gather(fw, 1, order)
    arange_e = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(sid, arange_e)               # left
    rank = torch.arange(N, device=dev)[None, :] - torch.gather(starts, 1, sid)
    keep = rank < C
    slot = torch.where(keep, sid * C + rank, torch.full_like(sid, E * C))

    rows = torch.arange(B, device=dev)[:, None].expand(B, N)
    # slot -> source token (the sentinel column gathers token 0, weight 0)
    slot_tok = torch.zeros((B, E * C + 1), dtype=torch.long, device=dev)
    slot_tok.index_put_((rows, slot), stok)
    xg = x[torch.arange(B, device=dev)[:, None], slot_tok[:, :E * C]]
    xg = xg.reshape(B, E, C, d).to(cd)

    # ---- expert compute ------------------------------------------------------
    gate = torch.einsum("becd,edf->becf", xg, p["wg"].to(cd))
    up = torch.einsum("becd,edf->becf", xg, p["wu"].to(cd))
    h = act_fn(cfg.act)(gate) * up
    yg = torch.einsum("becf,efd->becd", h, p["wd"].to(cd)).reshape(
        B, E * C, d)

    # ---- combine (gather back, unsort, weighted sum over k) -----------------
    y_sorted = torch.gather(
        yg, 1, slot.clamp(max=E * C - 1)[..., None].expand(B, N, d))
    y_sorted = y_sorted * (sw * keep).to(cd)[..., None]
    inv_order = torch.argsort(order, dim=-1)
    y_flat = torch.gather(y_sorted, 1, inv_order[..., None].expand(B, N, d))
    y = y_flat.reshape(B, S, K, d).sum(dim=2)

    if "shared" in p:
        g = torch.sigmoid(x.to(cd) @ p["shared_gate"].to(cd))
        y = y + g * mlp(p["shared"], x, cfg, rt)

    aux = {"moe_lb_loss": lb_loss, "moe_router_z": router_z,
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y, aux
