"""GQA attention: self-attention (causal, or bidirectional in an encoder) and
cross-attention over an encoder's output, through the flash kernel; decode
against a KV cache or the cached cross keys and values.

Full-sequence attention (``attention`` / ``attention_with_kv``) sends every
sequence length to ``kernels.flash_attention.ops.sdpa``: the hand-written
kernel on the card, its plain version on the CPU.  This is intended.  The
JAX package splits attention into ``_sdpa_dense`` / ``_sdpa_blockwise`` for
its un-kernelled and sharded XLA paths, and takes its Pallas kernel only
when both lengths are multiples of the kernel's tiles; elsewhere (a
1000-token prompt, say) it falls back to ``_sdpa_dense``, the same function
with the probabilities rounded to the compute dtype before P.V.  The port's
kernel masks its ragged tiles, so it covers every length and the split is
not copied.

With ``kv_x`` set (whisper's decoder), keys and values are projected from
the encoder output and no RoPE is applied; that attention is non-causal,
so the reference kernel's top-left causal mask for Sq != Sk never applies.

Decode (``attn_decode``, ``cross_attn_decode``) stays plain PyTorch on the
card, as the JAX package computes it outside any Pallas kernel: one query
row per sequence against the cached keys.  The self-attention cache is
updated in place at ``cache_len``; the cross cache is only read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import (Runtime, accum_product, apply_rope,
                                       dense_init, rope_tables)


def attn_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, d, (d, H * hd), rt.param_dtype),
        "wk": dense_init(gen, d, (d, KV * hd), rt.param_dtype),
        "wv": dense_init(gen, d, (d, KV * hd), rt.param_dtype),
        "wo": dense_init(gen, H * hd, (H * hd, d), rt.param_dtype),
    }


def _project_q(p: dict, x: torch.Tensor, cfg: ArchConfig,
               rt: Runtime) -> torch.Tensor:
    B, S, _ = x.shape
    cd = rt.compute_dtype
    return (x.to(cd) @ p["wq"].to(cd)).view(B, S, cfg.n_heads, cfg.hd)


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                 kv_x: Optional[torch.Tensor] = None):
    """q (B, S, H, hd) from x, k and v (B, Sk, KV, hd) from ``kv_x`` (x
    when None), in the compute dtype."""
    src = x if kv_x is None else kv_x
    B, Sk, _ = src.shape
    cd = rt.compute_dtype
    sc = src.to(cd)
    k = (sc @ p["wk"].to(cd)).view(B, Sk, cfg.n_kv_heads, cfg.hd)
    v = (sc @ p["wv"].to(cd)).view(B, Sk, cfg.n_kv_heads, cfg.hd)
    return _project_q(p, x, cfg, rt), k, v


def _out_proj(p: dict, out: torch.Tensor, cfg: ArchConfig,
              rt: Runtime) -> torch.Tensor:
    B, S = out.shape[:2]
    cd = rt.compute_dtype
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(cd)


def attention_with_kv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      rt: Runtime, *, causal: bool = True,
                      kv_x: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Attention of x (B, S, d) at positions 0..S-1 over itself, or over
    ``kv_x`` (B, Sk, d) when given: the (B, S, d) output and the
    un-expanded (B, Sk, KV, hd) keys and values for the decode cache."""
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg, rt, kv_x)
    if cfg.rope and kv_x is None:
        positions = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = flash_ops.sdpa(q, k, v, causal=causal)
    return _out_proj(p, out, cfg, rt), (k, v)


def attention(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
              causal: bool = True,
              kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    return attention_with_kv(p, x, cfg, rt, causal=causal, kv_x=kv_x)[0]


# --------------------------------------------------------------------------- #
# Decode (one new token against a KV cache)
# --------------------------------------------------------------------------- #
def attn_cache_init(cfg: ArchConfig, rt: Runtime, B: int, S: int,
                    device) -> dict:
    shape = (B, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=rt.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=rt.compute_dtype, device=device)}


def attn_decode(p: dict, x: torch.Tensor, cache: dict, cache_len: int,
                cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    """x (B, 1, d); cache k/v (B, S, KV, hd).

    Writes the new key and value at ``cache_len`` (in place) and attends
    over positions [0, cache_len].  The reference scores the whole cache and
    masks the positions past ``cache_len`` to -1e30, whose probabilities
    are exactly 0; the port reads only the live positions.  Scores are the
    compute-dtype operands multiplied in the accumulation dtype (fp32),
    softmax in fp32, and the probabilities are rounded to the compute dtype
    for P.V, as in the reference."""
    q, k_new, v_new = _project_qkv(p, x, cfg, rt)
    if cfg.rope:
        pos = torch.full((x.shape[0], 1), cache_len, device=x.device)
        cos, sin = rope_tables(pos, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    cache["k"][:, cache_len] = k_new[:, 0]
    cache["v"][:, cache_len] = v_new[:, 0]
    n = cache_len + 1
    return _attend_one(p, q, cache["k"][:, :n], cache["v"][:, :n], cfg, rt)


def cross_attn_decode(p: dict, x: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, cfg: ArchConfig,
                      rt: Runtime) -> torch.Tensor:
    """x (B, 1, d) against the encoder's cached keys and values
    ``cross_k`` / ``cross_v`` (B, Se, KV, hd): every position, no mask, no
    cache write, no RoPE."""
    return _attend_one(p, _project_q(p, x, cfg, rt), cross_k, cross_v, cfg,
                       rt)


def _attend_one(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    """One query row q (B, 1, H, hd) over k and v (B, n, KV, hd), then the
    output projection."""
    B = q.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = rt.compute_dtype
    k = k.permute(0, 2, 3, 1)                        # (B, KV, hd, n)
    v = v.permute(0, 2, 1, 3)                        # (B, KV, n, hd)
    qg = q.view(B, KV, H // KV, hd)                  # one query row
    scores = accum_product(qg, k, rt) * (hd ** -0.5)  # (B, KV, G, n)
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.matmul(w, v.to(cd))                  # (B, KV, G, hd)
    return _out_proj(p, out.reshape(B, 1, H, hd), cfg, rt)
