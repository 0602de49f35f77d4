"""Shared model machinery: runtime policy, norms, RoPE, init, logits and the
chunked cross-entropy loss.

The counterpart of ``repro.models.common``, as plain functions on tensors.
There is no sharding context: the port runs on one card (sharding is
ROADMAP queue 1 item 14), and no ``use_pallas`` switch: on the card the
kernels always run.

Wherever the JAX package multiplies ``compute_dtype`` operands with
``preferred_element_type=float32``, the port multiplies the operands,
rounded to ``compute_dtype``, in ``accum_dtype`` (``accum_product``): a
bf16 product rounded to bf16 and then widened would lose what the
reference keeps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Policy threaded through the model functions: parameters are stored in
    ``param_dtype``, activations computed in ``compute_dtype``, and scores
    and logits multiplied and summed in ``accum_dtype``; the rest are the
    training and routing knobs of the reference's ``Runtime`` (the mLSTM
    kernel's chunk is fixed at 64 tokens, as the Pallas kernel's is; the
    Mamba scan has no chunk: its kernel and plain version walk every
    step)."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    lstm_bf16_states: bool = False     # stash xLSTM outputs in bf16
    ce_chunk: int = 512                # seq chunk for cross-entropy
    ssm_chunk: int = 256               # chunk of the stateful mLSTM scan
    moe_capacity_factor: float = 0.0   # 0 -> use cfg.capacity_factor
    remat_policy: str = "full"         # none | dots | full
    z_loss: float = 1e-4


# --------------------------------------------------------------------------- #
# Norms / activations
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast to x's dtype, then scale (the reference's
    order, which bf16 parity needs)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def norm_apply(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_init(kind: str, d: int, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def act_fn(name: str):
    """silu, or the tanh-approximated gelu that ``jax.nn.gelu`` computes by
    default."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise KeyError(name)


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def dense_init(gen: torch.Generator, fan_in: int, shape: Sequence[int],
               dtype) -> torch.Tensor:
    """Normal truncated to +-2 sigma, sigma = fan_in^-1/2, drawn on the
    generator's device by inverting the normal CDF over [Phi(-2), Phi(2)]
    (the numbers differ from ``jax.random``'s; tests carry parameters across
    with ``convert.model_params_from_numpy``)."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=torch.float32)
    p = _PHI_LO + (_PHI_HI - _PHI_LO) * u
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return (z.clamp_(-2.0, 2.0) * fan_in ** -0.5).to(dtype)


# --------------------------------------------------------------------------- #
# Positions
# --------------------------------------------------------------------------- #
def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> cos/sin tables (B, S, hd//2) in fp32."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=dev) / hd))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd//2).  Rotates the pairs
    (x[i], x[i + hd/2]): the first half against the second, as the
    reference's code does (its docstring says interleaved)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _inv_freq(d: int, device) -> torch.Tensor:
    return 1.0 / (10_000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=device) / d))


def sinusoidal_position_at(pos: int, d: int, device=None) -> torch.Tensor:
    """Single sinusoidal position row -> (d,) fp32."""
    ang = float(pos) * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (S, d)


# --------------------------------------------------------------------------- #
# Logits
# --------------------------------------------------------------------------- #
def accum_product(a: torch.Tensor, b: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    """a @ b of the operands rounded to the compute dtype, multiplied and
    summed in the accumulation dtype (the reference's
    ``preferred_element_type=float32``)."""
    ad, cd = rt.accum_dtype, rt.compute_dtype
    return torch.matmul(a.to(cd).to(ad), b.to(cd).to(ad))


def logits_for(x: torch.Tensor, w_head: torch.Tensor, rt: Runtime,
               vocab_size: int) -> torch.Tensor:
    """(B, S, Vp) logits in the accumulation dtype of x (B, S, d); padded
    vocabulary columns are -1e30, so they never win an argmax."""
    Vp = w_head.shape[1]
    logits = accum_product(x, w_head, rt)
    if Vp != vocab_size:
        logits[..., vocab_size:] = -1e30
    return logits


# --------------------------------------------------------------------------- #
# Chunked cross-entropy (never materializes (B, S, V) logits)
# --------------------------------------------------------------------------- #
def _ce_chunk(xc, w_head, lc, mc, rt: Runtime, vocab_size: int):
    logits = accum_product(xc, w_head, rt)
    if w_head.shape[1] != vocab_size:
        col = torch.arange(w_head.shape[1], device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)                       # (B, C)
    ll = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    return ((lse - ll) * mc).sum(), (lse.square() * mc).sum()


def chunked_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          rt: Runtime, vocab_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked positions + ``rt.z_loss`` times the mean squared
    log-normalizer; returns (loss, token count).

    x (B, S, d) final hidden; w_head (d, Vp), the padded columns past
    ``vocab_size`` masked to -1e30; labels, mask (B, S).  Runs over S in
    ``rt.ce_chunk`` chunks (one chunk of S when S is no multiple), each
    under ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    logits instead of keeping them."""
    B, S, _ = x.shape
    C = min(rt.ce_chunk, S)
    if S % C != 0:
        C = S
    mf = mask.to(torch.float32)
    ce_sum = zl_sum = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, C):
        sl = slice(s0, s0 + C)
        ce, zl = checkpoint(_ce_chunk, x[:, sl], w_head, labels[:, sl],
                            mf[:, sl], rt, vocab_size, use_reentrant=False)
        ce_sum, zl_sum = ce_sum + ce, zl_sum + zl
    denom = mf.sum().clamp(min=1.0)
    return ce_sum / denom + rt.z_loss * zl_sum / denom, denom
