"""Model assembly for serving the dense decoder family: embeddings -> layers
-> last-position logits and a KV cache.

The counterpart of ``repro.models.transformer`` for configs whose period is
``LayerSpec("attn", "dense")`` (smollm-135m, phi3-mini-3.8b, yi-34b,
command-r-35b and internvl2-76b with its stubbed vision prefix).  The JAX
package stacks every layer's parameters on a leading ``n_periods`` axis and
scans over it; the port keeps one parameter dict per layer in
``params["blocks"]`` and one cache dict per layer, and loops.

Entry points:
  * ``forward_prefill`` -> (last-position logits, cache)
  * ``forward_decode``  -> (logits, cache updated in place)
Mamba, mLSTM, sLSTM, MoE, cross-attention and the audio encoder, and
``forward_train``, come with the training slice (ROADMAP queue 1 item 13b).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (Runtime, dense_init, logits_for,
                                       norm_apply, norm_init,
                                       sinusoidal_position_at,
                                       sinusoidal_positions)
from repro_torch.models.mlp import mlp, mlp_init


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice of the port does not serve yet."""
    missing = sorted({what for spec in cfg.period for what, on in (
        (spec.mixer, spec.mixer != "attn"), ("moe", spec.ffn == "moe"),
        ("ffn=none", spec.ffn == "none"),
        ("cross_attn", spec.cross_attn)) if on})
    if cfg.encoder_layers:
        missing.append("encoder_layers")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {', '.join(missing)} yet; "
            "it serves dense attention decoders, and the rest comes with the "
            "model-stack training slice (ROADMAP queue 1 item 13b)")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _layer_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    dev = gen.device
    return {"mixer_norm": norm_init(cfg.norm, cfg.d_model, rt.param_dtype,
                                    dev),
            "mixer": attn_mod.attn_init(gen, cfg, rt),
            "ffn_norm": norm_init(cfg.norm, cfg.d_model, rt.param_dtype,
                                  dev),
            "ffn": mlp_init(gen, cfg, rt)}


def init_params(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    """Random parameters drawn from ``gen`` on its device."""
    check_supported(cfg)
    d, Vp = cfg.d_model, cfg.padded_vocab()
    params: dict = {
        "embed": dense_init(gen, d, (Vp, d), rt.param_dtype),
        "final_norm": norm_init(cfg.norm, d, rt.param_dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, (d, Vp), rt.param_dtype)
    params["blocks"] = [_layer_init(gen, cfg, rt)
                        for _ in range(cfg.n_layers)]
    return params


# --------------------------------------------------------------------------- #
# Embedding / head helpers
# --------------------------------------------------------------------------- #
def _embed_tokens(params: dict, tokens: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    return params["embed"][tokens.long()].to(rt.compute_dtype)


def _head_weights(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _add_sinusoidal(x: torch.Tensor) -> torch.Tensor:
    pos = sinusoidal_positions(x.shape[1], x.shape[2], x.device)
    return x + pos[None].to(x.dtype)


def _uses_sinusoidal(cfg: ArchConfig) -> bool:
    return not cfg.rope and cfg.family not in ("hybrid", "ssm")


# --------------------------------------------------------------------------- #
# Prefill / decode (serving)
# --------------------------------------------------------------------------- #
def init_cache(cfg: ArchConfig, rt: Runtime, B: int, S: int,
               device) -> List[Dict[str, torch.Tensor]]:
    """One zeroed {"k", "v"} (B, S, KV, hd) cache per layer."""
    check_supported(cfg)
    return [attn_mod.attn_cache_init(cfg, rt, B, S, device)
            for _ in range(cfg.n_layers)]


def forward_prefill(params: dict, batch: Dict[str, torch.Tensor],
                    cfg: ArchConfig, rt: Runtime,
                    cache_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Run the prompt (``batch["tokens"]`` (B, S), and ``batch["patches"]``
    (B, vision_tokens, d) for a VLM, prepended) through every layer.

    Returns the (B, Vp) fp32 logits of the last position and a cache of
    ``max(cache_size, prefix + S)`` positions holding the prompt's keys and
    values (the rest zeros)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = _embed_tokens(params, tokens, rt)
    if cfg.vision_tokens:
        x = torch.cat([batch["patches"].to(rt.compute_dtype), x], dim=1)
    if _uses_sinusoidal(cfg):
        x = _add_sinusoidal(x)

    S = x.shape[1]
    cache = init_cache(cfg, rt, B, max(cache_size or 0, S), x.device)
    for p, c in zip(params["blocks"], cache):
        h = norm_apply(cfg.norm, x, p["mixer_norm"])
        mixed, (k, v) = attn_mod.attention_with_kv(p["mixer"], h, cfg, rt)
        c["k"][:, :S] = k
        c["v"][:, :S] = v
        x = x + mixed
        x = x + mlp(p["ffn"], norm_apply(cfg.norm, x, p["ffn_norm"]), cfg,
                    rt)
    x = norm_apply(cfg.norm, x, params["final_norm"])
    logits = logits_for(x[:, -1:], _head_weights(params, cfg), rt,
                        cfg.vocab_size)
    return logits[:, 0], cache


def forward_decode(params: dict, tokens: torch.Tensor,
                   cache: List[Dict[str, torch.Tensor]], cache_len: int,
                   cfg: ArchConfig, rt: Runtime
                   ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """tokens (B, 1) at position ``cache_len``; cache from
    ``forward_prefill`` or ``init_cache``, updated in place.  Returns the
    (B, Vp) fp32 logits and the cache."""
    check_supported(cfg)
    x = _embed_tokens(params, tokens, rt)
    if _uses_sinusoidal(cfg):
        pos_row = sinusoidal_position_at(cache_len, x.shape[-1], x.device)
        x = x + pos_row[None, None].to(x.dtype)
    for p, c in zip(params["blocks"], cache):
        h = norm_apply(cfg.norm, x, p["mixer_norm"])
        x = x + attn_mod.attn_decode(p["mixer"], h, c, cache_len, cfg, rt)
        x = x + mlp(p["ffn"], norm_apply(cfg.norm, x, p["ffn_norm"]), cfg,
                    rt)
    x = norm_apply(cfg.norm, x, params["final_norm"])
    logits = logits_for(x, _head_weights(params, cfg), rt, cfg.vocab_size)
    return logits[:, 0], cache
