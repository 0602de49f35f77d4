"""Plain PyTorch versions of the flash-attention kernels, forward and
backward.

``attention_ref`` is the counterpart of ``repro.kernels.flash_attention.
ref.attention_ref``, in the model layout: q (B, Sq, H, hd), k/v (B, Sk, KV,
hd).  Query head h reads KV head h // G (G = H // KV) through a reshape,
never a copy to H heads.  Scores, softmax and P.V are float32 on the
inputs' values; the output is cast to the input dtype.  The causal mask lets
key j through to query i where j <= i + off: by default off = Sk - Sq
(aligned bottom-right, as the reference's oracle has it), or the diagonal
offset a caller gives for one rank's shard of the rows or the keys.  An
offset below 0 leaves the first -off rows no key: their output is 0 and
their log-sum-exp +inf, as the kernel writes them (``torch.softmax`` of a
row of -inf alone would give NaN).

``attention_lse_ref`` adds the row log-sum-exp of the scaled scores that
the forward kernel writes for training, and ``attention_bwd_ref`` writes out
the backward kernel's decomposition (``csrc/flash_attention_bwd.cu``): P
recomputed from the log-sum-exp, D = rowsum(dO o O), dS = P o (dP - D).

``attention_tc_ref`` and ``attention_bwd_tc_ref`` are the same functions with
the numerics of the bf16 tensor-core kernels written out: the products take
bf16 operands and sum in fp32, so P is rounded to bf16 before P.V (relative
to the running row max of each 64-key tile, as the forward's online softmax
holds it) and dS before dK and dQ, while the row sum l, D and the softmax
stay fp32.  The tests hold them against the JAX package's oracle to show
that the design fits the tolerances the card checks state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def diagonal(Sq: int, Sk: int, offset: Optional[int]) -> int:
    """The causal mask's diagonal offset: ``offset``, or Sk - Sq when
    None."""
    return Sk - Sq if offset is None else offset


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            offset: Optional[int] = None) -> torch.Tensor:
    """(B, KV, G, Sq, Sk) fp32 scaled scores, -inf where masked."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (hd ** -0.5)
    if causal:
        iq = torch.arange(Sq, device=q.device)[:, None]
        ik = torch.arange(Sk, device=q.device)[None, :]
        off = diagonal(Sq, Sk, offset)
        scores = scores.masked_fill(ik > iq + off, float("-inf"))
    return scores


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            offset: Optional[int], with_lse: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out (B, Sq, H, hd) in q's dtype, lse (B, KV, G, Sq) fp32 or None
    unless ``with_lse``) from one product of the scores; the rows that see
    no key (the first -offset under a causal mask) give out 0 and lse
    +inf."""
    B, Sq, H, hd = q.shape
    s = _scores(q, k, causal, offset)
    lse = torch.logsumexp(s, dim=-1) if with_lse else None
    n_empty = (min(Sq, max(0, -diagonal(Sq, k.shape[1], offset)))
               if causal else 0)
    if n_empty:
        # such a row's scores are all -inf: softmax it over 0s instead (no
        # NaN, forward or backward) and zero its weights
        empty = torch.arange(Sq, device=q.device)[:, None] < n_empty
        w = torch.softmax(torch.where(empty, 0.0, s), dim=-1)
        w = torch.where(empty, 0.0, w)
        if with_lse:
            lse = torch.where(empty[:, 0], float("inf"), lse)
    else:
        w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype), lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  offset: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H, hd) attention output in q's dtype."""
    return _attend(q, k, v, causal, offset, with_lse=False)[0]


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, offset: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output and the row log-sum-exp (B, H, Sq) fp32 of the scaled
    scores (+inf for a row that sees no key)."""
    B, Sq, H, _ = q.shape
    out, lse = _attend(q, k, v, causal, offset, with_lse=True)
    return out, lse.reshape(B, H, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      offset: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype for the upstream gradient dout
    (B, Sq, H, hd), from the forward's inputs, output and log-sum-exp:
    P = exp(S - lse), D = rowsum(dO o O), dS = P o (dO V^T - D),
    dV = P^T dO, dK = dS^T Q scale, dQ = dS K scale, fp32 throughout.
    ``lse`` need not be this call's: given the log-sum-exp over a larger
    set of keys (and that attention's output), it gives this set's share of
    dq and exact dk, dv for these keys."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G, scale = H // KV, hd ** -0.5
    p = torch.exp(_scores(q, k, causal, offset)
                  - lse.reshape(B, KV, G, Sq)[..., None])
    do = dout.float().reshape(B, Sq, KV, G, hd)
    D = (do * out.float().reshape(B, Sq, KV, G, hd)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KV, G, hd)) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


TC_BLOCK_K = 64   # keys per tile of the bf16 forward kernel


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def attention_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward kernel's arithmetic: (out, lse) with the online
    softmax over ``TC_BLOCK_K``-key tiles, each tile's P = exp(s - m)
    rounded to bf16 for P.V and summed into l in fp32."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    s = _scores(q, k, causal)
    vf = v.float()
    m = torch.full(s.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(s.shape[:-1], device=q.device)
    acc = torch.zeros(*s.shape[:-1], hd, device=q.device)
    for k0 in range(0, Sk, TC_BLOCK_K):
        sb = s[..., k0:k0 + TC_BLOCK_K]
        m_new = torch.maximum(m, sb.amax(-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(sb - m_use[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", _bf16(p), vf[:, k0:k0 + TC_BLOCK_K])
        m = m_new
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype), (m + torch.log(l)).reshape(B, H, Sq)


def attention_bwd_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, *, causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward kernels' arithmetic: ``attention_bwd_ref`` with P
    rounded to bf16 for dV = P^T dO and dS = P o (dP - D), taken from the
    fp32 P, rounded to bf16 for dK and dQ; the scale multiplies the fp32
    sums."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G, scale = H // KV, hd ** -0.5
    p = torch.exp(_scores(q, k, causal)
                  - lse.reshape(B, KV, G, Sq)[..., None])
    do = dout.float().reshape(B, Sq, KV, G, hd)
    D = (do * out.float().reshape(B, Sq, KV, G, hd)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = _bf16(p * (dp - D.permute(0, 2, 3, 1)[..., None]))
    dv = torch.einsum("bkgqs,bqkgd->bskd", _bf16(p), do)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KV, G, hd)) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
