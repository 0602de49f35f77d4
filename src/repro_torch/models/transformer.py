"""Model assembly: embeddings -> layers -> loss, or last-position logits and
a cache.

The counterpart of ``repro.models.transformer`` for every config: dense
attention decoders (smollm-135m, phi3-mini-3.8b, yi-34b, command-r-35b and
internvl2-76b with its stubbed vision prefix), MoE decoders
(qwen2-moe-a2.7b, olmoe-1b-7b), the Mamba + attention hybrid with MoE
(jamba-v0.1-52b), xLSTM (xlstm-1.3b: a period of 8 layers, 7 mLSTM and 1
sLSTM, no FFN) and the encoder-decoder whisper-large-v3 (a bidirectional
encoder over stubbed frame embeddings, a causal decoder whose layers also
cross-attend to the encoder output).  The JAX package stacks each period
position's parameters on a leading ``n_periods`` axis, and the encoder's on
a leading ``encoder_layers`` axis, and scans over them; the port keeps one
parameter dict per layer in the lists ``params["blocks"]`` (layer l has
spec ``cfg.period[l % P]``) and ``params["enc_blocks"]``, one cache dict
per layer, and loops.

Entry points:
  * ``forward_train``   -> (loss, metrics)
  * ``forward_prefill`` -> (last-position logits, cache)
  * ``forward_decode``  -> (logits, cache updated in place)
  * ``encode_audio``    -> the encoder output (whisper)
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels.checks import is_dtensor
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (Runtime, chunked_cross_entropy,
                                       dense_init, logits_for,
                                       norm_apply, norm_init,
                                       sinusoidal_position_at,
                                       sinusoidal_positions)
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.moe import moe, moe_init

AUX_KEYS = ("moe_lb_loss", "moe_router_z", "moe_drop_frac")
# the encoder layer of an encoder-decoder (whisper): attention + dense FFN
ENC_SPEC = LayerSpec("attn", "dense")


def layer_specs(cfg: ArchConfig) -> List[LayerSpec]:
    """The spec of every layer, in order."""
    return [cfg.period[i % len(cfg.period)] for i in range(cfg.n_layers)]


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _layer_init(gen: torch.Generator, spec: LayerSpec, cfg: ArchConfig,
                rt: Runtime) -> dict:
    dev = gen.device
    p = {"mixer_norm": norm_init(cfg.norm, cfg.d_model, rt.param_dtype, dev)}
    if spec.mixer == "attn":
        p["mixer"] = attn_mod.attn_init(gen, cfg, rt)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, rt)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm_mod.mlstm_init(gen, cfg, rt)
    else:
        p["mixer"] = xlstm_mod.slstm_init(gen, cfg, rt)
    if spec.cross_attn:
        p["cross_norm"] = norm_init(cfg.norm, cfg.d_model, rt.param_dtype,
                                    dev)
        p["cross"] = attn_mod.attn_init(gen, cfg, rt)
    if spec.ffn != "none":
        p["ffn_norm"] = norm_init(cfg.norm, cfg.d_model, rt.param_dtype, dev)
        p["ffn"] = (mlp_init(gen, cfg, rt) if spec.ffn == "dense"
                    else moe_init(gen, cfg, rt))
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    """Random parameters drawn from ``gen`` on its device."""
    d, Vp = cfg.d_model, cfg.padded_vocab()
    params: dict = {
        "embed": dense_init(gen, d, (Vp, d), rt.param_dtype),
        "final_norm": norm_init(cfg.norm, d, rt.param_dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, (d, Vp), rt.param_dtype)
    params["blocks"] = [_layer_init(gen, spec, cfg, rt)
                        for spec in layer_specs(cfg)]
    if cfg.encoder_layers:
        params["enc_blocks"] = [_layer_init(gen, ENC_SPEC, cfg, rt)
                                for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = norm_init(cfg.norm, d, rt.param_dtype,
                                       gen.device)
    return params


# --------------------------------------------------------------------------- #
# Embedding / head helpers
# --------------------------------------------------------------------------- #
def _embed_tokens(params: dict, tokens: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    table = params["embed"]
    if is_dtensor(table):
        x = _embed_on_mesh(table, tokens, rt)
    else:
        x = table[tokens.long()]
    return rt.sc.act(x.to(rt.compute_dtype), tokens.shape[0], None, None)


def _embed_on_mesh(table: torch.Tensor, tokens: torch.Tensor,
                   rt: Runtime) -> torch.Tensor:
    """The lookup on a mesh, through ``local_map``: the table gathered
    whole (FSDP's regather), each rank's rows of its batch shard looked up
    locally.  The table's gradient is a partial sum over the batch's data
    axes (DTensor's own index backward cannot place it)."""
    from torch.distributed.tensor.experimental import local_map
    sc = rt.sc
    bs = sc.div(tokens.shape[0], sc.dp_axes)
    tokens = sc.constrain(tokens, bs, None)
    tok_pl = sc.placements((bs, None))
    run = local_map(
        lambda t, i: t[i.long()],
        out_placements=sc.placements((bs, None, None)),
        in_placements=(sc.placements((None, None)), tok_pl),
        in_grad_placements=(sc.partial_over(bs), tok_pl),
        device_mesh=sc.device_mesh)
    return run(sc.constrain(table, None, None), tokens)


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
# Train
# --------------------------------------------------------------------------- #
def _ffn(spec: LayerSpec, p: dict, x: torch.Tensor, cfg: ArchConfig,
         rt: Runtime) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x plus the layer's FFN (dense or MoE) of its normed input, and the
    MoE auxiliaries (None for a dense FFN or none)."""
    if spec.ffn == "none":
        return x, None
    h = _sublayer_input(norm_apply(cfg.norm, x, p["ffn_norm"]), rt)
    if spec.ffn == "dense":
        return _add_residual(x, mlp(p["ffn"], h, cfg, rt), rt), None
    y, aux = moe(p["ffn"], h, cfg, rt)
    return _add_residual(x, y, rt), aux


def _residual(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The residual stream between sublayers: batch over the data axes and,
    with ``seq_parallel`` (Megatron-SP), the sequence over the model axis;
    replicated over the model axis otherwise (a DTensor add would else
    reduce a sublayer's partial sum to sequence shards of its own
    choosing)."""
    sc = rt.sc
    seq = (sc.div(x.shape[1], sc.tp_axis)
           if sc.seq_parallel and sc.tp_axis is not None else None)
    return sc.constrain(x, sc.div(x.shape[0], sc.dp_axes), seq, None)


class _GatheredGrad(torch.autograd.Function):
    """Identity whose gradient is gathered over the sequence: with
    ``seq_parallel`` a sublayer's output gradient arrives in sequence
    shards and enters the sublayer's backward whole over the model axis
    (Megatron-SP's backward all-gather)."""

    @staticmethod
    def forward(ctx, y, sc):
        ctx.sc = sc
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.sc.act(g, g.shape[0], None, None), None


def _add_residual(x: torch.Tensor, y: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    """x plus a sublayer's output y, placed as the residual stream."""
    if rt.sc.seq_parallel and is_dtensor(y):
        y = _GatheredGrad.apply(y, rt.sc)
    return _residual(x + y, rt)


def _sublayer_input(h: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """A sublayer's normed input, whole over the model axis: with
    ``seq_parallel`` the all-gather of the sequence shards before the
    tensor-parallel matmuls (Megatron-SP); a no-op otherwise."""
    return rt.sc.act(h, h.shape[0], None, None)


def _apply_block(spec: LayerSpec, p: dict, x: torch.Tensor, cfg: ArchConfig,
                 rt: Runtime, causal: bool = True,
                 enc_out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    x = _residual(x, rt)
    h = _sublayer_input(norm_apply(cfg.norm, x, p["mixer_norm"]), rt)
    if spec.mixer == "attn":
        mixed = attn_mod.attention(p["mixer"], h, cfg, rt, causal=causal)
    elif spec.mixer == "mamba":
        mixed = mamba_mod.mamba(p["mixer"], h, cfg, rt)
    elif spec.mixer == "mlstm":
        mixed = xlstm_mod.mlstm(p["mixer"], h, cfg, rt)
    else:
        mixed = xlstm_mod.slstm(p["mixer"], h, cfg, rt)
    x = _add_residual(x, mixed, rt)
    if spec.cross_attn and enc_out is not None:
        h = _sublayer_input(norm_apply(cfg.norm, x, p["cross_norm"]), rt)
        x = _add_residual(x, attn_mod.attention(
            p["cross"], h, cfg, rt, causal=False, kv_x=enc_out), rt)
    return _ffn(spec, p, x, cfg, rt)


def _apply_period(x: torch.Tensor, layers: List[dict],
                  enc_out: Optional[torch.Tensor], specs: List[LayerSpec],
                  cfg: ArchConfig,
                  rt: Runtime) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                            ...]]:
    """The period's layers in order (cross-attending to ``enc_out`` where
    a layer has cross-attention); returns x and the MoE auxiliaries
    (``AUX_KEYS``, fp32) summed over its layers."""
    aux = [x.new_zeros((), dtype=torch.float32) for _ in AUX_KEYS]
    for spec, p in zip(specs, layers):
        x, a = _apply_block(spec, p, x, cfg, rt, enc_out=enc_out)
        if a is not None:
            aux = [t + a[k].float() for t, k in zip(aux, AUX_KEYS)]
    return x, tuple(aux)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of un-batched matrix products, recompute the rest:
    the counterpart of JAX's ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, rt: Runtime):
    """``none``: keep every activation; ``full``: keep only each period's
    input and recompute the period in the backward; ``dots``: recompute the
    period but keep its un-batched matrix products."""
    if rt.remat_policy == "none":
        return fn
    if rt.remat_policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if rt.remat_policy == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    raise ValueError(f"unknown remat policy {rt.remat_policy!r}")


def _run_layers(params: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every period in order; returns x and the MoE auxiliaries summed over
    all layers, as the reference's scan carries them."""
    P = len(cfg.period)
    specs = list(cfg.period)
    body = _remat(functools.partial(_apply_period, specs=specs, cfg=cfg,
                                    rt=rt), rt)
    blocks = params["blocks"]
    aux = [x.new_zeros((), dtype=torch.float32) for _ in AUX_KEYS]
    for i in range(0, len(blocks), P):
        x, a = body(x, blocks[i:i + P], enc_out)
        aux = [t + u for t, u in zip(aux, a)]
    return x, dict(zip(AUX_KEYS, aux))


def _encoder_layer(x: torch.Tensor, p: dict, cfg: ArchConfig,
                   rt: Runtime) -> torch.Tensor:
    return _apply_block(ENC_SPEC, p, x, cfg, rt, causal=False)[0]


def encode_audio(params: dict, frames: torch.Tensor, cfg: ArchConfig,
                 rt: Runtime) -> torch.Tensor:
    """Whisper's encoder over stubbed post-conv frame embeddings
    (B, encoder_seq, d): sinusoidal positions, the bidirectional layers
    (each under the remat policy, as the reference remats each), the final
    norm."""
    x = _add_sinusoidal(frames.to(rt.compute_dtype))
    body = _remat(functools.partial(_encoder_layer, cfg=cfg, rt=rt), rt)
    for p in params["enc_blocks"]:
        x = body(x, p)
    # whole over the model axis (gathered once under seq_parallel): every
    # cross-attention projects its keys and values from it
    return _sublayer_input(norm_apply(cfg.norm, x, params["enc_norm"]), rt)


def _embed_input(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: ArchConfig, rt: Runtime
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The decoder's input (token embeddings, a VLM's patches prepended,
    sinusoidal positions where the config has them) and the encoder output
    (None without an encoder)."""
    x = _embed_tokens(params, batch["tokens"], rt)
    if cfg.vision_tokens:
        x = torch.cat([batch["patches"].to(rt.compute_dtype), x], dim=1)
    enc_out = (encode_audio(params, batch["frames"], cfg, rt)
               if cfg.encoder_layers else None)
    if _uses_sinusoidal(cfg):
        x = _add_sinusoidal(x)
    return x, enc_out


def forward_train(params: dict, batch: Dict[str, torch.Tensor],
                  cfg: ArchConfig, rt: Runtime
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token loss of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S) (labels < 0 masked; a VLM's
    ``batch["patches"]`` prepended and not scored; whisper's
    ``batch["frames"]`` (B, encoder_seq, d) encoded and cross-attended),
    plus the z-loss.
    Returns (loss, metrics): ``loss`` = ce + 0.01 lb + 0.001 z, as the
    reference weights the MoE auxiliaries, ``ce``, ``tokens`` and the
    auxiliaries summed over layers (zero without MoE)."""
    labels = batch["labels"]
    x, enc_out = _embed_input(params, batch, cfg, rt)
    x, aux = _run_layers(params, x, cfg, rt, enc_out)
    x = norm_apply(cfg.norm, x, params["final_norm"])
    if cfg.vision_tokens:
        x = x[:, cfg.vision_tokens:]
    loss_ce, denom = chunked_cross_entropy(
        x, _head_weights(params, cfg), labels, labels >= 0, rt,
        cfg.vocab_size)
    loss = loss_ce + 0.01 * aux["moe_lb_loss"] + 0.001 * aux["moe_router_z"]
    metrics = {"loss": loss, "ce": loss_ce, "tokens": denom, **aux}
    return loss, metrics


# --------------------------------------------------------------------------- #
# Prefill / decode (serving)
# --------------------------------------------------------------------------- #
def init_cache(cfg: ArchConfig, rt: Runtime, B: int, S: int,
               device) -> List[Dict[str, torch.Tensor]]:
    """One zeroed cache dict per layer: {"k", "v"} (B, S, KV, hd) for
    attention, the recurrent state for Mamba, mLSTM and sLSTM, and
    {"cross_k", "cross_v"} (B, encoder_seq, KV, hd) for a layer with
    cross-attention."""
    caches = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            c = attn_mod.attn_cache_init(cfg, rt, B, S, device)
        elif spec.mixer == "mamba":
            c = mamba_mod.mamba_cache_init(cfg, rt, B, device)
        elif spec.mixer == "mlstm":
            c = xlstm_mod.mlstm_cache_init(cfg, rt, B, device)
        else:
            c = xlstm_mod.slstm_cache_init(cfg, rt, B, device)
        if spec.cross_attn:
            cross = attn_mod.attn_cache_init(cfg, rt, B, cfg.encoder_seq,
                                             device)
            c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
        caches.append(c)
    return caches


def forward_prefill(params: dict, batch: Dict[str, torch.Tensor],
                    cfg: ArchConfig, rt: Runtime,
                    cache_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Run the prompt (``batch["tokens"]`` (B, S); ``batch["patches"]``
    (B, vision_tokens, d) for a VLM, prepended; ``batch["frames"]``
    (B, encoder_seq, d) for whisper, encoded) through every layer.

    Returns the (B, Vp) fp32 logits of the last position and the cache:
    for attention ``max(cache_size, prefix + S)`` positions holding the
    prompt's keys and values (the rest zeros), for Mamba, mLSTM and sLSTM
    the state after the last token, for cross-attention the keys and values
    of the encoder output.  On a mesh (``rt.sc.device_mesh`` set) the
    cache is a DTensor tree placed by ``launch.sharding.cache_specs``."""
    B = batch["tokens"].shape[0]
    x, enc_out = _embed_input(params, batch, cfg, rt)
    S = x.shape[1]
    cache = init_cache(cfg, rt, B, max(cache_size or 0, S), x.device)
    if rt.sc.device_mesh is not None:
        from repro_torch.launch.sharding import place_cache
        cache = place_cache(cache, cfg, rt, B)
    for spec, p, c in zip(layer_specs(cfg), params["blocks"], cache):
        h = norm_apply(cfg.norm, x, p["mixer_norm"])
        if spec.mixer == "attn":
            mixed, (k, v) = attn_mod.attention_with_kv(p["mixer"], h, cfg,
                                                       rt)
            attn_mod.write_positions(c["k"], k, 0)
            attn_mod.write_positions(c["v"], v, 0)
        else:
            with_state = {"mamba": mamba_mod.mamba_with_state,
                          "mlstm": xlstm_mod.mlstm_with_state,
                          "slstm": xlstm_mod.slstm_with_state}[spec.mixer]
            mixed, st = with_state(p["mixer"], h, cfg, rt)
            c.update(st)
        x = x + mixed
        if spec.cross_attn:
            h = norm_apply(cfg.norm, x, p["cross_norm"])
            y, (k, v) = attn_mod.attention_with_kv(
                p["cross"], h, cfg, rt, causal=False, kv_x=enc_out)
            attn_mod.write_positions(c["cross_k"], k, 0)
            attn_mod.write_positions(c["cross_v"], v, 0)
            x = x + y
        x, _ = _ffn(spec, p, x, cfg, rt)
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
    x = _embed_tokens(params, tokens, rt)
    if _uses_sinusoidal(cfg):
        pos_row = sinusoidal_position_at(cache_len, x.shape[-1], x.device)
        x = x + pos_row[None, None].to(x.dtype)
    for spec, p, c in zip(layer_specs(cfg), params["blocks"], cache):
        h = norm_apply(cfg.norm, x, p["mixer_norm"])
        if spec.mixer == "attn":
            mixed = attn_mod.attn_decode(p["mixer"], h, c, cache_len, cfg,
                                         rt)
        else:
            decode = {"mamba": mamba_mod.mamba_decode,
                      "mlstm": xlstm_mod.mlstm_decode,
                      "slstm": xlstm_mod.slstm_decode}[spec.mixer]
            mixed, st = decode(p["mixer"], h, c, cfg, rt)
            c.update(st)
        x = x + mixed
        if spec.cross_attn:
            h = norm_apply(cfg.norm, x, p["cross_norm"])
            x = x + attn_mod.cross_attn_decode(p["cross"], h, c["cross_k"],
                                               c["cross_v"], cfg, rt)
        x, _ = _ffn(spec, p, x, cfg, rt)
    x = norm_apply(cfg.norm, x, params["final_norm"])
    logits = logits_for(x, _head_weights(params, cfg), rt, cfg.vocab_size)
    return logits[:, 0], cache
