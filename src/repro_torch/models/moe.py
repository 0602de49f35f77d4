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

On a mesh (``x`` a DTensor, ``rt.sc`` set) the routing, the dispatch and
the combine run on each rank's batch shard through ``local_map``: they are
per batch row, and DTensor has no sharding rule for the stable sort,
``searchsorted`` or the index writes (``common.on_batch_shards``).  The
router enters whole (FSDP's regather) and its gradient comes back as a
partial sum over the data axes.  The expert products run as DTensor ops
on the placed weights, the reference's layout: the contraction over d
whole (FSDP's regather), the experts' hidden width over the model axis, or
with
``moe_expert_parallel`` the experts themselves (each rank's slice of the
dispatched tokens goes in, the outputs are gathered over the model axis
for the combine; no all-to-all).  The auxiliaries stay global: each shard
returns its sums (router probabilities and assignments per expert, squared
log-normalizers, kept slots), reduced over the data axes before the
means and the load-balance product.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.checks import is_dtensor
from repro_torch.models.common import (Runtime, act_fn, dense_init,
                                       on_batch_shards)
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


def _route(x: torch.Tensor, router: torch.Tensor, *, cfg: ArchConfig,
           C: int, cd: torch.dtype):
    """Routing and sort-based dispatch of x (B, S, d), per batch row.

    Returns the dispatched tokens xg (B, E, C, d) in ``cd``, each slot's
    column in the (E * C) expert rows (the sentinel E * C for a dropped
    slot), its combine weight (0 when dropped), the inverse of the sort,
    and the sums over these rows that the auxiliaries need: router
    probabilities and assignments per expert (E,), squared
    log-normalizers and kept slots."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = S * K
    dev = x.device

    # ---- routing (fp32) ----------------------------------------------------
    logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)              # (B, S, K)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    prob_sum = probs.sum(dim=(0, 1))                         # (E,)
    assigned = torch.zeros(E, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(B * S * K, device=dev))
    z_sum = torch.logsumexp(logits, dim=-1).square().sum()

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
    inv_order = torch.argsort(order, dim=-1)
    return (xg, slot, sw * keep, inv_order, prob_sum, assigned, z_sum,
            keep.float().sum())


def _combine(yg: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
             inv_order: torch.Tensor, *, K: int) -> torch.Tensor:
    """Each slot's expert output gathered back from yg (B, E, C, d),
    weighted, unsorted and summed over its token's top-k: (B, S, d)."""
    B, E, C, d = yg.shape
    N = slot.shape[1]
    yg = yg.reshape(B, E * C, d)
    y_sorted = torch.gather(
        yg, 1, slot.clamp(max=E * C - 1)[..., None].expand(B, N, d))
    y_sorted = y_sorted * w.to(yg.dtype)[..., None]
    y_flat = torch.gather(y_sorted, 1, inv_order[..., None].expand(B, N, d))
    return y_flat.reshape(B, N // K, K, d).sum(dim=2)


def _experts(p: dict, xg: torch.Tensor, cfg: ArchConfig,
             rt: Runtime) -> torch.Tensor:
    """The experts' SwiGLU over the dispatched tokens xg (B, E, C, d) ->
    (B, E, C, d).  On a mesh the weights are placed as the reference's
    layout uses them (see the module's docstring) and the output comes
    back whole over the model axis."""
    cd, sc = rt.compute_dtype, rt.sc
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    bs = sc.div(xg.shape[0], sc.dp_axes)
    if is_dtensor(xg):
        E, f = cfg.n_experts, cfg.moe_d_ff
        e_ax = sc.div(E, sc.tp_axis) if rt.moe_expert_parallel else None
        f_ax = None if e_ax is not None else sc.div(f, sc.tp_axis)
        xg = sc.constrain(xg, bs, e_ax, None, None)
        wg = sc.constrain(wg, e_ax, None, f_ax)
        wu = sc.constrain(wu, e_ax, None, f_ax)
        wd = sc.constrain(wd, e_ax, f_ax, None)
    gate = torch.einsum("becd,edf->becf", xg, wg.to(cd))
    up = torch.einsum("becd,edf->becf", xg, wu.to(cd))
    h = act_fn(cfg.act)(gate) * up
    yg = torch.einsum("becf,efd->becd", h, wd.to(cd))
    return sc.constrain(yg, bs, None, None, None)


def _shared_gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x @ w)


def moe(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), {moe_lb_loss, moe_router_z,
    moe_drop_frac})."""
    cd = rt.compute_dtype
    B, S = x.shape[:2]
    E, K = cfg.n_experts, cfg.top_k
    route = functools.partial(_route, cfg=cfg, C=moe_capacity(cfg, rt, S),
                              cd=cd)
    combine = functools.partial(_combine, K=K)
    sc = rt.sc
    outs = on_batch_shards(route, sc, (x,), (p["router"],),
                           out=(4, 2, 2, 2) + ("sum",) * 4)
    xg, slot, w, inv_order = outs[:4]
    # the per-shard sums reduced over the data axes (plain tensors pass)
    prob_sum, assigned, z_sum, kept = (
        sc.constrain(t, *(None,) * t.dim()) for t in outs[4:])
    y = on_batch_shards(combine, sc,
                        (_experts(p, xg, cfg, rt), slot, w, inv_order))

    if "shared" in p:
        # on a mesh the gate runs on each rank's rows and the shared
        # experts' output is placed as the residual, whole over the model
        # axis (DTensor would otherwise split both over the sequence)
        g = on_batch_shards(_shared_gate, sc, (x.to(cd),),
                            (p["shared_gate"].to(cd),), out=(3,))
        y = y + g * sc.act(mlp(p["shared"], x, cfg, rt), B, None, None)

    n_tok = B * S
    me, ce_frac = prob_sum / n_tok, assigned / (n_tok * K)
    aux = {"moe_lb_loss": E * (me * ce_frac).sum(),
           "moe_router_z": z_sum / n_tok,
           "moe_drop_frac": 1.0 - kept / (n_tok * K)}
    return y, aux
