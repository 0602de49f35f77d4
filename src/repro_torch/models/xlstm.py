"""xLSTM mixers: chunkwise mLSTM (matrix memory) and recurrent sLSTM.

The counterpart of ``repro.models.xlstm``.  ``mlstm`` without state (the
training and loss forward) sends the chunkwise recurrence to
``kernels.mlstm_chunk.ops.mlstm_mixer``: the hand-written forward and
backward kernels on the card, the plain version (which autograd
differentiates) on the CPU.  This is the JAX package's kernel path
(``use_pallas``), which its training cannot take (``pallas_call`` has no
transpose), so it trains through the jnp chunked form; the two compute the
same chunkwise function.  ``mlstm`` with state (prefill) and
``mlstm_decode`` stay plain PyTorch on both devices, as in the reference.

sLSTM has no kernel in the JAX package and stays plain PyTorch: a Python
loop over time, one cell update (about 20 small launches on the card) per
token.  The JAX package scans over chunks of up to 64 unrolled steps (an XLA
concern); the arithmetic per step is the same.

On a mesh (DTensor activations, ``rt.sc`` set) the blocks keep the
reference's layout: FSDP-sharded weights, activations split over the data
axes and whole over the model axis.  Each recurrence runs on each rank's
batch shard with its heads whole, through ``common.on_batch_shards``: the
mLSTM kernels (and the prefill's stateful chunkwise form), and the sLSTM
time loop as one region a layer call (a decode step's cell likewise), so
the loop issues no DTensor op per token.  The sLSTM recurrent weights ``r`` (FSDP-sharded with
``shard_lstm_r``) are gathered once before the loop (the reference gathers
once per 64-step chunk), and their gradient is a partial sum over the data
axes.  Every state comes out in ``launch.sharding.cache_specs``'
placements (the batch over the data axes).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.mlstm_chunk import ref as mlstm_ref
from repro_torch.models.common import (Runtime, dense_init,
                                       on_batch_shards, rmsnorm)
from repro_torch.models.mamba import _causal_conv

_CONV_K = 4
NEG = mlstm_ref.NEG
# leaves the reference keeps in fp32 whatever the parameter dtype
FP32_PARAMS = {"mlstm": ("w_gate", "gate_bias"), "slstm": ("r", "bias")}


def _stash_dtype(rt: Runtime) -> torch.dtype:
    return torch.bfloat16 if rt.lstm_bf16_states else torch.float32


def _rows(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """An activation with its batch over the data axes and the rest whole:
    the blocks' layout (a plain tensor is returned unchanged)."""
    sc = rt.sc
    return sc.act(x, x.shape[0], *(None,) * (x.dim() - 1))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #
def mlstm_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, di, nh = cfg.d_model, cfg.lstm_d_inner, cfg.lstm_heads
    dh = di // nh
    dev = gen.device
    return {
        "w_up": dense_init(gen, d, (d, 2 * di), rt.param_dtype),
        "conv_w": dense_init(gen, _CONV_K, (_CONV_K, di), rt.param_dtype),
        "wq": dense_init(gen, dh, (nh, dh, dh), rt.param_dtype),
        "wk": dense_init(gen, dh, (nh, dh, dh), rt.param_dtype),
        "wv": dense_init(gen, dh, (nh, dh, dh), rt.param_dtype),
        "w_gate": dense_init(gen, di, (di, 2 * nh), torch.float32),
        "gate_bias": torch.cat([torch.zeros(nh), torch.full((nh,), 3.0)]).to(
            dev),
        "out_scale": torch.ones(di, dtype=rt.param_dtype, device=dev),
        "w_down": dense_init(gen, di, (di, d), rt.param_dtype),
    }


def _mlstm_qkv_gates(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                     conv_state=None):
    cd = rt.compute_dtype
    B, S, _ = x.shape
    di, nh = cfg.lstm_d_inner, cfg.lstm_heads
    dh = di // nh
    up = _rows(x.to(cd) @ p["w_up"].to(cd), rt)
    x_m, z = up.chunk(2, dim=-1)
    x_c = F.silu(_causal_conv(x_m, p["conv_w"], conv_state))
    xh = x_c.reshape(B, S, nh, dh)
    q = torch.einsum("bsnd,nde->bsne", xh, p["wq"].to(cd))
    k = torch.einsum("bsnd,nde->bsne", xh, p["wk"].to(cd)) * (dh ** -0.5)
    v = torch.einsum("bsnd,nde->bsne", x_m.reshape(B, S, nh, dh),
                     p["wv"].to(cd))
    gates = _rows(x_m.float() @ p["w_gate"] + p["gate_bias"], rt)
    logi, logf_pre = gates.chunk(2, dim=-1)              # (B, S, nh)
    q, k, v = (_rows(t, rt) for t in (q, k, v))
    return q, k, v, logi, _log_sigmoid(logf_pre), z, x_m


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, nh, ...) -> contiguous fp32 (B, nh, S, ...)."""
    return t.transpose(1, 2).float().contiguous()


def _mlstm_out(p: dict, h: torch.Tensor, z: torch.Tensor, rt: Runtime
               ) -> torch.Tensor:
    """h (B, nh, S, dh) fp32 -> the block's (B, S, d) output."""
    B, _, S, _ = h.shape
    cd = rt.compute_dtype
    h = h.transpose(1, 2).reshape(B, S, -1).to(_stash_dtype(rt)).to(cd)
    h = rmsnorm(h, p["out_scale"]) * F.silu(z)
    return h @ p["w_down"].to(cd)


def _placed(state: dict, rt: Runtime) -> dict:
    """A recurrent state in ``cache_specs``' placements: the batch over
    the data axes, the rest whole (a no-op for plain tensors)."""
    return {k: _rows(t, rt) for k, t in state.items()}


def _mixer(q, k, v, logi, logf):
    return mlstm_ops.mlstm_mixer(*(_heads_first(t)
                                   for t in (q, k, v, logi, logf)))


def _chunkwise_with_state(q, k, v, logi, logf, *, chunk: int):
    """h and the carry (C, n, m) after the last token, as four tensors."""
    h, (C, n, m) = mlstm_ref.mlstm_chunkwise(
        *(_heads_first(t) for t in (q, k, v, logi, logf)), chunk=chunk,
        return_state=True)
    return h, C, n, m


def mlstm(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
          return_state: bool = False):
    """x (B, S, d) -> (B, S, d); with ``return_state`` also the decode
    state {"conv", "C", "n", "m"} after the last token."""
    S = x.shape[1]
    q, k, v, logi, logf, z, x_m = _mlstm_qkv_gates(p, x, cfg, rt)
    qkv = (q, k, v, logi, logf)
    if not return_state:
        return _mlstm_out(p, on_batch_shards(_mixer, rt.sc, qkv, out=(4,)), z, rt)
    L = min(rt.ssm_chunk, S)
    if S % L != 0:
        L = S
    h, C, n, m = on_batch_shards(
        functools.partial(_chunkwise_with_state, chunk=L), rt.sc, qkv,
        out=(4, 4, 3, 2))
    state = {"conv": x_m[:, S - (_CONV_K - 1):, :], "C": C, "n": n, "m": m}
    return _mlstm_out(p, h, z, rt), _placed(state, rt)


def mlstm_with_state(p, x, cfg: ArchConfig, rt: Runtime):
    return mlstm(p, x, cfg, rt, return_state=True)


def mlstm_cache_init(cfg: ArchConfig, rt: Runtime, B: int, device) -> dict:
    di, nh = cfg.lstm_d_inner, cfg.lstm_heads
    dh = di // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros(B, _CONV_K - 1, di, dtype=rt.compute_dtype,
                            device=device),
        "C": torch.zeros(B, nh, dh, dh, **f32),
        "n": torch.zeros(B, nh, dh, **f32),
        "m": torch.full((B, nh), NEG, **f32),
    }


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                 rt: Runtime) -> Tuple[torch.Tensor, dict]:
    """One token x (B, 1, d) against the state; returns the output and the
    new state."""
    cd = rt.compute_dtype
    B = x.shape[0]
    di = cfg.lstm_d_inner
    q, k, v, logi, logf, z, x_m = _mlstm_qkv_gates(
        p, x, cfg, rt, conv_state=cache["conv"])
    qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    li, lf = logi[:, 0], logf[:, 0]                      # (B, nh)
    m_new = torch.maximum(lf + cache["m"], li)
    fp = torch.exp(lf + cache["m"] - m_new)
    ip = torch.exp(li - m_new)
    C = fp[..., None, None] * cache["C"] + ip[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = fp[..., None] * cache["n"] + ip[..., None] * kf
    num = torch.einsum("bnd,bndv->bnv", qf, C)
    den = torch.maximum(torch.einsum("bnd,bnd->bn", qf, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, di).to(cd)
    h = rmsnorm(h, p["out_scale"]) * F.silu(z)
    out = h @ p["w_down"].to(cd)
    new_conv = torch.cat([cache["conv"][:, 1:], x_m], dim=1)
    return out, _placed({"conv": new_conv, "C": C, "n": n, "m": m_new}, rt)


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #
def slstm_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, nh = cfg.d_model, cfg.lstm_heads
    dh = d // nh
    dev = gen.device
    bias = torch.cat([torch.zeros(d), torch.zeros(d), torch.full((d,), 3.0),
                      torch.zeros(d)])                   # z, i, f, o
    return {
        "w_in": dense_init(gen, d, (d, 4 * d), rt.param_dtype),
        "r": dense_init(gen, dh, (nh, dh, 4 * dh), torch.float32),
        "bias": bias.to(dev),
        "norm_scale": torch.ones(d, dtype=rt.param_dtype, device=dev),
        "w_down": dense_init(gen, d, (d, d), rt.param_dtype),
    }


def _slstm_cell(p: dict, xt: torch.Tensor, state, cfg: ArchConfig):
    """xt (B, 4d) pre-computed input projection; state (c, n, h, m) (B, d)
    fp32."""
    d, nh = cfg.d_model, cfg.lstm_heads
    dh = d // nh
    c, n, h, m = state
    B = xt.shape[0]
    rec = torch.einsum("bnd,ndk->bnk", h.reshape(B, nh, dh), p["r"])
    # per-head (4dh) blocks are [z|i|f|o] slices: regroup to gate-major (4d)
    rec = rec.reshape(B, nh, 4, dh).permute(0, 2, 1, 3).reshape(B, 4 * d)
    g = xt.float() + rec + p["bias"]
    zt, it, ft, ot = g.chunk(4, dim=-1)
    logf = _log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(it - m_new)
    c_new = fp * c + ip * torch.tanh(zt)
    n_new = fp * n + ip
    h_new = torch.sigmoid(ot) * (c_new / n_new.clamp(min=1e-6))
    return c_new, n_new, h_new, m_new


def _slstm_state0(B: int, d: int, device):
    z = torch.zeros(B, d, dtype=torch.float32, device=device)
    return z, z, z, torch.full((B, d), NEG, dtype=torch.float32,
                               device=device)


def _slstm_loop(xp: torch.Tensor, r: torch.Tensor, bias: torch.Tensor, *,
                cfg: ArchConfig, stash: torch.dtype):
    """Every step of the recurrence over xp (B, S, 4d): the outputs
    (B, S, d) in ``stash`` and the final state (c, n, h, m)."""
    B, S, _ = xp.shape
    p = {"r": r, "bias": bias}
    state = _slstm_state0(B, cfg.d_model, xp.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, xp[:, t], state, cfg)
        hs.append(state[2].to(stash))
    return (torch.stack(hs, dim=1),) + tuple(state)


def slstm(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
          return_state: bool = False):
    cd = rt.compute_dtype
    xp = _rows(x.to(cd) @ p["w_in"].to(cd), rt)
    loop = functools.partial(_slstm_loop, cfg=cfg, stash=_stash_dtype(rt))
    h, c, n, hf, m = on_batch_shards(loop, rt.sc, (xp,),
                                     (p["r"], p["bias"]),
                                     out=(3, 2, 2, 2, 2))
    out = rmsnorm(h.to(cd), p["norm_scale"]) @ p["w_down"].to(cd)
    if return_state:
        return out, {"c": c, "n": n, "h": hf, "m": m}
    return out


def slstm_with_state(p, x, cfg: ArchConfig, rt: Runtime):
    return slstm(p, x, cfg, rt, return_state=True)


def slstm_cache_init(cfg: ArchConfig, rt: Runtime, B: int, device) -> dict:
    c, n, h, m = _slstm_state0(B, cfg.d_model, device)
    return {"c": c, "n": n, "h": h, "m": m}


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                 rt: Runtime) -> Tuple[torch.Tensor, dict]:
    cd = rt.compute_dtype
    xp = x.to(cd) @ p["w_in"].to(cd)
    state = tuple(cache[k] for k in ("c", "n", "h", "m"))
    c, n, h, m = on_batch_shards(functools.partial(_slstm_step, cfg=cfg),
                                 rt.sc, (xp[:, 0],) + state,
                                 (p["r"], p["bias"]), out=(2, 2, 2, 2))
    y = rmsnorm(h[:, None].to(cd), p["norm_scale"])
    out = y @ p["w_down"].to(cd)
    return out, {"c": c, "n": n, "h": h, "m": m}


def _slstm_step(xt, c, n, h, m, r, bias, *, cfg: ArchConfig):
    return _slstm_cell({"r": r, "bias": bias}, xt, (c, n, h, m), cfg)
