"""GQA self-attention for serving: prefill through the flash kernel, decode
against a KV cache.

Prefill (``attention`` / ``attention_with_kv``) sends every sequence length
to ``kernels.flash_attention.ops.sdpa``: the hand-written kernel on the
card, its plain version on the CPU.  This is intended.  The JAX package
splits attention into ``_sdpa_dense`` / ``_sdpa_blockwise`` for its
un-kernelled and sharded XLA paths, and takes its Pallas kernel only when
both lengths are multiples of the kernel's tiles; elsewhere (a 1000-token
prompt, say) it falls back to ``_sdpa_dense``, the same function with the
probabilities rounded to the compute dtype before P.V.  The port's kernel
masks its ragged tiles, so it covers every length and the split is not
copied.

Decode (``attn_decode``) stays plain PyTorch on the card, as the JAX package
computes it outside any Pallas kernel: one query row per sequence against
the cached keys.  The cache is updated in place at ``cache_len``.
"""
from __future__ import annotations

from typing import Tuple

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


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime):
    """q (B, S, H, hd), k and v (B, S, KV, hd) in the compute dtype."""
    B, S, _ = x.shape
    cd = rt.compute_dtype
    xc = x.to(cd)
    q = (xc @ p["wq"].to(cd)).view(B, S, cfg.n_heads, cfg.hd)
    k = (xc @ p["wk"].to(cd)).view(B, S, cfg.n_kv_heads, cfg.hd)
    v = (xc @ p["wv"].to(cd)).view(B, S, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _out_proj(p: dict, out: torch.Tensor, cfg: ArchConfig,
              rt: Runtime) -> torch.Tensor:
    B, S = out.shape[:2]
    cd = rt.compute_dtype
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(cd)


def attention_with_kv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      rt: Runtime) -> Tuple[torch.Tensor,
                                            Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention of x (B, S, d) at positions 0..S-1: the
    (B, S, d) output and the un-expanded (B, S, KV, hd) keys and values for
    the decode cache."""
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg, rt)
    if cfg.rope:
        positions = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = flash_ops.sdpa(q, k, v, causal=True)
    return _out_proj(p, out, cfg, rt), (k, v)


def attention(p: dict, x: torch.Tensor, cfg: ArchConfig,
              rt: Runtime) -> torch.Tensor:
    return attention_with_kv(p, x, cfg, rt)[0]


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
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    cd = rt.compute_dtype
    q, k_new, v_new = _project_qkv(p, x, cfg, rt)
    if cfg.rope:
        pos = torch.full((B, 1), cache_len, device=x.device)
        cos, sin = rope_tables(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    cache["k"][:, cache_len] = k_new[:, 0]
    cache["v"][:, cache_len] = v_new[:, 0]
    n = cache_len + 1
    k = cache["k"][:, :n].permute(0, 2, 3, 1)        # (B, KV, hd, n)
    v = cache["v"][:, :n].permute(0, 2, 1, 3)        # (B, KV, n, hd)
    qg = q.view(B, KV, G, hd)                        # one query row
    scores = accum_product(qg, k, rt) * (hd ** -0.5)  # (B, KV, G, n)
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.matmul(w, v.to(cd))                  # (B, KV, G, hd)
    return _out_proj(p, out.reshape(B, 1, H, hd), cfg, rt)
