"""AdamW with fp32 moments over bf16 or fp32 params, global-norm clipping and
a warmup + cosine / linear / constant schedule.

The counterpart of ``repro.optim.adamw``.  The JAX package is functional;
the port updates parameters and moments in place (under ``no_grad``), which
keeps one copy of each in device memory.  Two details follow the reference
exactly:
  * the schedule is read at the step count *before* the increment;
  * weight decay skips leaves of fewer than two dimensions *in the JAX
    package's stacked layout*, where every block leaf has a leading
    ``n_periods`` axis and every encoder leaf a leading ``encoder_layers``
    axis.  So the top-level ``final_norm`` and ``enc_norm`` are not
    decayed, and every block and encoder leaf is, norm scales and biases
    included (the reference's rule meets the stacked axis; the port copies
    it so that a train step agrees).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.checks import is_dtensor
from repro_torch.tree import tree_items, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``, computed in float32 as the reference
    computes it."""
    s = _f32(step)
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1 - frac)
    else:
        decay = _f32(1.0)
    return float(cfg.lr * warm * decay)


def opt_init(params) -> Dict[str, Any]:
    """fp32 zero moments shaped like ``params``, and step 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, on the leaves' device
    (DTensor leaves sum their shards and reduce there)."""
    sq = [l.float().square().sum() for l in tree_leaves(tree)]
    return torch.sqrt(functools.reduce(operator.add, sq))


def decays(path) -> bool:
    """Whether the leaf at ``path`` (a path in the port's tree) has two or
    more dimensions in the JAX package's stacked layout: every block and
    encoder leaf does; a top-level leaf by its own shape (decided by the
    caller)."""
    return len(path) > 0 and path[0] in ("blocks", "enc_blocks")


def placed_as(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` in ``ref``'s placements (ZeRO-1 places the moments
    otherwise than the parameters); a plain tensor unchanged."""
    if is_dtensor(t) and tuple(t.placements) != tuple(
            ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


@torch.no_grad()
def opt_update(cfg: AdamWConfig, params, grads, opt_state
               ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, in place: clip ``grads`` by their global norm, update
    the moments and the parameters.  Returns (params, opt_state, {grad_norm,
    lr})."""
    step = int(opt_state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule_lr(cfg, step)
    b1c = float(1 - _f32(cfg.b1) ** (_f32(step) + 1))
    b2c = float(1 - _f32(cfg.b2) ** (_f32(step) + 1))
    gl = dict(tree_items(grads))
    ml = dict(tree_items(opt_state["m"]))
    vl = dict(tree_items(opt_state["v"]))
    for path, p in tree_items(params):
        g = gl[path].float() * scale
        m, v = ml[path], vl[path]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
        pf = placed_as(p.float(), m)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(path) or p.dim() >= 2:
            delta = delta + cfg.weight_decay * pf
        p.copy_(placed_as((pf - lr * delta).to(p.dtype), p))
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
