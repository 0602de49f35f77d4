"""Plain PyTorch version of the flash-attention kernel.

The counterpart of ``repro.kernels.flash_attention.ref.attention_ref``, in
the model layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd).  Query head h reads
KV head h // G (G = H // KV) through a reshape, never a copy to H heads.
Scores, softmax and P.V are float32 on the inputs' values; the output is
cast to the input dtype.  The causal mask is aligned bottom-right,
k <= q + (Sk - Sq), as the reference's oracle has it.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, hd) attention output in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (hd ** -0.5)
    if causal:
        iq = torch.arange(Sq, device=q.device)[:, None]
        ik = torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(ik > iq + (Sk - Sq), float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
