"""Dense MLPs: SwiGLU (llama family) and plain GeLU (whisper)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Runtime, act_fn, dense_init


def mlp_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime,
             d_ff: int = 0) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, d, (d, ff), rt.param_dtype),
        "w_down": dense_init(gen, ff, (ff, d), rt.param_dtype),
    }
    if cfg.act == "silu":
        p["w_gate"] = dense_init(gen, d, (d, ff), rt.param_dtype)
    return p


def mlp(p: dict, x: torch.Tensor, cfg: ArchConfig,
        rt: Runtime) -> torch.Tensor:
    cd = rt.compute_dtype
    xc = x.to(cd)
    up = xc @ p["w_up"].to(cd)
    if "w_gate" in p:
        h = act_fn(cfg.act)(xc @ p["w_gate"].to(cd)) * up
    else:
        h = act_fn(cfg.act)(up)
    sc = rt.sc
    h = sc.constrain(h, sc.div(x.shape[0], sc.dp_axes), None,
                     sc.div(up.shape[-1], sc.tp_axis))
    return h @ p["w_down"].to(cd)
