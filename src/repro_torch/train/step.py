"""Train, prefill and decode step factories.

The counterpart of ``repro.train.step``.  ``make_train_step`` returns a
``(state, batch) -> (state, metrics)`` function: gradients accumulated in
fp32 over microbatches, optional int8 error-feedback compression, global
norm clipping and AdamW.  The state is updated in place (parameters and
moments are not copied); the same dict is returned.  Every config trains;
whisper's batch carries ``frames`` beside the tokens and labels.

The serving steps return the greedy next token (int32, argmax of the
logits), the cache, and the fp32 logits it was chosen from, so a caller can
check them without computing them again.

On a mesh (``rt.sc.device_mesh`` set, the state, batch and cache placed as
``DTensor``s by ``launch.sharding``) the same steps run sharded: each runs
under DTensor's ``implicit_replication`` (the models' position tables and
masks are plain tensors, replicated), gradients are placed as the moments
are before AdamW, and the serving steps replicate the vocabulary before
the argmax.  Nothing is read back to the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            forward_train, init_params)
from repro_torch.optim.adamw import (AdamWConfig, opt_init, opt_update,
                                     placed_as)
from repro_torch.tree import tree_leaves, tree_map

METRIC_KEYS = ("loss", "ce", "tokens", "moe_lb_loss", "moe_router_z",
               "moe_drop_frac")


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_compression: str = "none"  # none | int8_ef


def on_mesh(rt: Runtime):
    """The context a step runs in: DTensor's implicit replication of plain
    tensors on a mesh, nothing otherwise."""
    if rt.sc.device_mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def auto_microbatches(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime,
                      act_budget_bytes: float = 2.5e9) -> int:
    """Microbatches so the period-boundary activations (~ n_layers x B_micro
    x S x d x 2 bytes with remat "full") of one data-parallel rank's batch
    fit the budget."""
    dp = max(rt.sc.dp, 1)
    b_local = max(shape.global_batch // dp, 1)
    per_b = cfg.n_layers * shape.seq_len * cfg.d_model * 2
    n = 1
    while b_local % (2 * n) == 0 and (b_local // n) * per_b > act_budget_bytes:
        n *= 2
    return max(n, 1)


def make_train_step(cfg: ArchConfig, rt: Runtime, hyper: TrainHyper,
                    n_microbatches: int = 1) -> Callable:
    n_micro = max(n_microbatches, 1)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        with on_mesh(rt):
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        moments = tree_leaves(state["opt"]["m"])
        leaves = tree_leaves(params)
        g_acc = [None] * len(leaves)
        metrics = {k: 0.0 for k in METRIC_KEYS}
        for mi in range(n_micro):
            # microbatch mi holds rows mi, mi + n, mi + 2n, ...: the
            # reference's (B/n, n) layout
            mb = {k: t.reshape((t.shape[0] // n_micro, n_micro)
                               + t.shape[1:])[:, mi]
                  for k, t in batch.items()}
            for leaf in leaves:
                leaf.requires_grad_(True)
            try:
                with torch.enable_grad():
                    loss, m = forward_train(params, mb, cfg, rt)
                    grads = list(torch.autograd.grad(loss, leaves,
                                                     allow_unused=True))
            finally:
                for leaf in leaves:
                    leaf.requires_grad_(False)
            for i in range(len(leaves)):
                g = (torch.zeros_like(leaves[i], dtype=torch.float32)
                     if grads[i] is None else grads[i].float() / n_micro)
                g = placed_as(g, moments[i])
                grads[i] = None
                g_acc[i] = g if g_acc[i] is None else g_acc[i] + g
            for k in METRIC_KEYS:
                metrics[k] = metrics[k] + m[k].detach() / n_micro
        it = iter(g_acc)
        grads = tree_map(lambda _: next(it), params)
        if hyper.grad_compression == "int8_ef":
            from repro_torch.optim.compression import ef_compress_tree
            grads, state["ef"] = ef_compress_tree(grads, state["ef"])
        _, _, opt_metrics = opt_update(hyper.opt, params, grads,
                                       state["opt"])
        return state, {**metrics, **opt_metrics}

    return train_step


def init_train_state(gen: torch.Generator, cfg: ArchConfig, rt: Runtime,
                     grad_compression: str = "none") -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on its device, zero moments, step 0 (and
    a zero error-feedback buffer with ``int8_ef``)."""
    params = init_params(gen, cfg, rt)
    state = {"params": params, "opt": opt_init(params)}
    if grad_compression == "int8_ef":
        state["ef"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return state


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #
def make_decode_step(cfg: ArchConfig, rt: Runtime) -> Callable:
    def decode_step(params, tokens, cache, cache_len: int):
        with on_mesh(rt):
            logits, cache = forward_decode(params, tokens, cache, cache_len,
                                           cfg, rt)
            return _greedy(logits, rt), cache, logits

    return decode_step


def _greedy(logits: torch.Tensor, rt: Runtime) -> torch.Tensor:
    sc = rt.sc
    logits = sc.constrain(logits, sc.batch_spec(logits.shape[0]), None)
    return logits.argmax(dim=-1).int()


def make_prefill_step(cfg: ArchConfig, rt: Runtime,
                      cache_size: Optional[int] = None) -> Callable:
    def prefill_step(params, batch):
        with on_mesh(rt):
            logits, cache = forward_prefill(params, batch, cfg, rt,
                                            cache_size=cache_size)
            return _greedy(logits, rt), cache, logits

    return prefill_step
