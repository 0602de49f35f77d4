"""Mamba selective-SSM mixer (Jamba's sequence layer).

The counterpart of ``repro.models.mamba``.  The recurrence over the
(d_inner, N) state goes to ``kernels.ssm_scan.ops.selective_scan``: the
hand-written kernels on the card, the plain sequential version (which
autograd differentiates) on the CPU.
  * ``mamba`` (training and the loss forward) runs the scan kernel, and its
    gradient the backward kernel.  This is the JAX package's kernel path
    (``use_pallas``), which its training cannot take (``pallas_call`` has
    no transpose); the two compute the same recurrence.
  * ``mamba_with_state`` (prefill) runs the same kernel and takes the final
    state from it.  The reference's prefill reaches no kernel: it scans in
    jnp chunks, because its Pallas kernel returns no state.
  * ``mamba_decode`` is the one-step plain update on both devices, as in the
    reference.
The prefill's conv state is the last Kc - 1 inputs, zero-padded in front
for a prompt shorter than that (the reference slices past the start there).

On a mesh (DTensor activations, ``rt.sc`` set) the activations are placed
at the reference's four sites (xz, x_c, delta and the gated output) with
d_inner over the model axis and the batch over the data axes, and the scan
runs the same kernels through ``local_map`` on each rank's
(B/dp, S, d_inner/tp, N) shard: the recurrence is independent per channel.
The reference runs a jnp chunked scan on a mesh (its kernel path is
guarded by ``rt.sc.mesh is None``); the port keeps its kernel there, as it
keeps the flash kernel.  C enters each rank whole over the model axis, so
its gradient is a partial sum there.  The prefill's and the decode step's
state come out in ``launch.sharding.cache_specs``' placements.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.checks import is_dtensor
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.common import Runtime, contiguous_grad, dense_init

# leaves the reference keeps in fp32 whatever the parameter dtype
FP32_PARAMS = ("dt_bias", "A_log", "D")


def mamba_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    r, N, Kc = cfg.dt_rank, cfg.ssm_state_dim, cfg.ssm_conv_dim
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return {
        "w_in": dense_init(gen, d, (d, 2 * di), rt.param_dtype),
        "conv_w": dense_init(gen, Kc, (Kc, di), rt.param_dtype),
        "w_x": dense_init(gen, di, (di, r + 2 * N), rt.param_dtype),
        "w_dt": dense_init(gen, r, (r, di), rt.param_dtype),
        "dt_bias": torch.full((di,), -4.6, device=dev),  # softplus^-1(~0.01)
        "A_log": torch.log(A),
        "D": torch.ones((di,), device=dev),
        "w_out": dense_init(gen, di, (di, d), rt.param_dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 shift_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via Kc shifted adds, summed in fp32 and cast to
    x's dtype.  x (B, S, di), w (Kc, di); ``shift_in`` (B, Kc - 1, di) are
    the inputs before position 0 (zeros by default)."""
    Kc = w.shape[0]
    B, S, di = x.shape
    if shift_in is None:
        shift_in = x.new_zeros(B, Kc - 1, di)
    xp = torch.cat([shift_in, x], dim=1)
    out = x.new_zeros(B, S, di, dtype=torch.float32)
    for i in range(Kc):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return out.to(x.dtype)


def _ssm_inputs(p: dict, xz: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                conv_state: Optional[torch.Tensor] = None):
    """Shared pre-scan computation.  xz (B, S, 2 di) -> (x_c, z, Abar, Bx,
    Cc, x_in): the discretised Abar = exp(delta A) and Bx = delta x B
    (B, S, di, N) fp32, and C (B, S, N) fp32."""
    cd = rt.compute_dtype
    r, N = cfg.dt_rank, cfg.ssm_state_dim
    x_in, z = xz.chunk(2, dim=-1)
    x_c = F.silu(_causal_conv(x_in, p["conv_w"], conv_state))
    x_c = _channels(x_c, cfg, rt)
    # x_c's channels split over the model axis leave a partial sum: reduce
    # it here (r + 2N columns) so that delta's bias adds to whole values
    xdb = rt.sc.act((x_c @ p["w_x"].to(cd)).float(), x_c.shape[0], None, None)
    dt_r, Bc, Cc = xdb.split([r, N, N], dim=-1)
    delta = F.softplus(dt_r @ p["w_dt"].float() + p["dt_bias"])
    delta = _channels(delta, cfg, rt)
    A = -torch.exp(p["A_log"])                                   # (di, N)
    Abar = torch.exp(delta[..., None] * A)                       # (B,S,di,N)
    Bx = (delta * x_c.float())[..., None] * Bc[:, :, None, :]
    return x_c, z, Abar, Bx, Cc.contiguous(), x_in


def _channels(x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
              width: int = 0) -> torch.Tensor:
    """An activation (B, S, width) with the batch over the data axes and
    its channels (d_inner by default) over the model axis: the reference's
    ``constrain`` sites.  A plain tensor is returned unchanged."""
    sc = rt.sc
    return sc.constrain(x, sc.div(x.shape[0], sc.dp_axes), None,
                        sc.div(width or cfg.ssm_d_inner, sc.tp_axis))


def _out(p: dict, y_ssm: torch.Tensor, x_c: torch.Tensor, z: torch.Tensor,
         cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    cd = rt.compute_dtype
    y = y_ssm + p["D"] * x_c.float()
    y = _channels(y.to(cd) * F.silu(z), cfg, rt)
    return y @ p["w_out"].to(cd)


def _scan(Abar: torch.Tensor, Bx: torch.Tensor, Cc: torch.Tensor,
          rt: Runtime, return_state: bool = False):
    """``ssm_ops.selective_scan``; on a mesh, on each rank's shard of the
    batch and the channels (see the module's docstring)."""
    if not is_dtensor(Abar):
        return ssm_ops.selective_scan(Abar, Bx, Cc, return_state=return_state)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    sc = rt.sc
    B, _, di, _ = Abar.shape
    bs, ch = sc.div(B, sc.dp_axes), sc.div(di, sc.tp_axis)
    ab = sc.placements((bs, None, ch, None))
    c_pl = sc.placements((bs, None, None))
    # C's gradient sums each rank's channels
    c_grad = [Partial() if a == ch else p
              for a, p in zip(sc.mesh.axis_names, c_pl)]
    Abar, Bx = (sc.constrain(t, bs, None, ch, None) for t in (Abar, Bx))
    Cc = sc.constrain(Cc, bs, None, None)
    y_pl = sc.placements((bs, None, ch))
    run = local_map(
        lambda a, b, c: ssm_ops.selective_scan(
            *(contiguous_grad(t.contiguous()) for t in (a, b, c)),
            return_state=return_state),
        out_placements=((y_pl, sc.placements((bs, ch, None)))
                        if return_state else y_pl),
        in_placements=(ab, ab, c_pl), in_grad_placements=(ab, ab, c_grad),
        device_mesh=sc.device_mesh)
    return run(Abar, Bx, Cc)


def _placed_state(st: dict, cfg: ArchConfig, rt: Runtime) -> dict:
    """The decode state {"conv" (B, Kc-1, di), "h" (B, di, N)} in
    ``cache_specs``' placements (a no-op for plain tensors)."""
    sc = rt.sc
    bs = sc.div(st["h"].shape[0], sc.dp_axes)
    ch = sc.div(cfg.ssm_d_inner, sc.tp_axis)
    return {"conv": sc.constrain(st["conv"], bs, None, ch),
            "h": sc.constrain(st["h"], bs, ch, None)}


def mamba(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
          return_state: bool = False):
    """Full-sequence selective scan of x (B, S, d) -> (B, S, d); with
    ``return_state`` also the decode state {"conv", "h"}."""
    cd = rt.compute_dtype
    xz = _channels(x.to(cd) @ p["w_in"].to(cd), cfg, rt,
                   2 * cfg.ssm_d_inner)
    x_c, z, Abar, Bx, Cc, x_in = _ssm_inputs(p, xz, cfg, rt)
    if not return_state:
        return _out(p, _scan(Abar, Bx, Cc, rt), x_c, z, cfg, rt)
    y_ssm, h_last = _scan(Abar, Bx, Cc, rt, return_state=True)
    Kc = cfg.ssm_conv_dim
    conv = torch.cat([x_in.new_zeros(x_in.shape[0], Kc - 1, x_in.shape[2]),
                      x_in], dim=1)[:, x_in.shape[1]:]
    return _out(p, y_ssm, x_c, z, cfg, rt), _placed_state(
        {"conv": conv, "h": h_last}, cfg, rt)


def mamba_with_state(p: dict, x: torch.Tensor, cfg: ArchConfig,
                     rt: Runtime):
    return mamba(p, x, cfg, rt, return_state=True)


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def mamba_cache_init(cfg: ArchConfig, rt: Runtime, B: int, device) -> dict:
    di, N, Kc = cfg.ssm_d_inner, cfg.ssm_state_dim, cfg.ssm_conv_dim
    return {
        "conv": torch.zeros((B, Kc - 1, di), dtype=rt.compute_dtype,
                            device=device),
        "h": torch.zeros((B, di, N), dtype=torch.float32, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                 rt: Runtime) -> Tuple[torch.Tensor, dict]:
    """One-token step.  x (B, 1, d) -> (B, 1, d) and the new state."""
    cd = rt.compute_dtype
    xz = x.to(cd) @ p["w_in"].to(cd)
    x_c, z, Abar, Bx, Cc, x_in = _ssm_inputs(p, xz, cfg, rt,
                                             conv_state=cache["conv"])
    h = Abar[:, 0] * cache["h"] + Bx[:, 0]                        # (B, di, N)
    y = torch.einsum("bin,bn->bi", h, Cc[:, 0])[:, None]
    new_conv = torch.cat([cache["conv"][:, 1:], x_in], dim=1)
    return _out(p, y, x_c, z, cfg, rt), _placed_state(
        {"conv": new_conv, "h": h}, cfg, rt)
