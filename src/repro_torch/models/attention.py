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

On a mesh (``DTensor`` activations, ``rt.sc`` set) the kernel stays:
``_sdpa`` places q, k and v with the batch over the data axes and the heads
over the model axis, or the heads replicated where they do not divide it
(smollm's 9, yi's 56 on a 16-wide axis), and runs ``flash_ops.sdpa`` on
each rank's local q, k and v through ``local_map``; its gradient goes
through the kernel's autograd Function.  Where the query heads divide the
axis and the key/value heads do not, k and v are expanded to the query
heads first, as the reference's dense path expands them.  The reference's
``kvseq``/``qseq`` fallbacks have no counterpart.  A DTensor cache, whose
position dim may be sharded (``launch.sharding.cache_specs``), is written
by each rank into its own positions and read by ``_attend_cached``: over
the key heads' shards through ``local_map`` where they divide the model
axis, else scored whole with the positions past ``cache_len`` masked to
-1e30, as the reference scores its cache.  Decode reads whisper's cross
cache the same way, with no mask.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.checks import is_dtensor
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import (Runtime, accum_product, apply_rope,
                                       contiguous_grad, dense_init,
                                       rope_tables)


def attn_init(gen: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, d, (d, H * hd), rt.param_dtype),
        "wk": dense_init(gen, d, (d, KV * hd), rt.param_dtype),
        "wv": dense_init(gen, d, (d, KV * hd), rt.param_dtype),
        "wo": dense_init(gen, H * hd, (H * hd, d), rt.param_dtype),
    }


def _heads(y: torch.Tensor, n_heads: int, cfg: ArchConfig,
           rt: Runtime) -> torch.Tensor:
    """A projection (B, S, n_heads*hd) as (B, S, n_heads, hd); on a mesh,
    its heads split over the model axis where they divide it (the
    reference's ``_shard_plan``), replicated otherwise."""
    sc = rt.sc
    B, S, _ = y.shape
    y = sc.constrain(y, sc.div(B, sc.dp_axes), None,
                     sc.div(n_heads, sc.tp_axis))
    return y.view(B, S, n_heads, cfg.hd)


def _project_q(p: dict, x: torch.Tensor, cfg: ArchConfig,
               rt: Runtime) -> torch.Tensor:
    cd = rt.compute_dtype
    return _heads(x.to(cd) @ p["wq"].to(cd), cfg.n_heads, cfg, rt)


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                 kv_x: Optional[torch.Tensor] = None):
    """q (B, S, H, hd) from x, k and v (B, Sk, KV, hd) from ``kv_x`` (x
    when None), in the compute dtype."""
    src = x if kv_x is None else kv_x
    cd = rt.compute_dtype
    sc = src.to(cd)
    k = _heads(sc @ p["wk"].to(cd), cfg.n_kv_heads, cfg, rt)
    v = _heads(sc @ p["wv"].to(cd), cfg.n_kv_heads, cfg, rt)
    return _project_q(p, x, cfg, rt), k, v


def _out_proj(p: dict, out: torch.Tensor, cfg: ArchConfig,
              rt: Runtime) -> torch.Tensor:
    B, S = out.shape[:2]
    cd = rt.compute_dtype
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(cd)


def _expand_kv(k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd), each key/value head repeated for
    its group of query heads."""
    B, S, KV, hd = k.shape
    G = cfg.n_heads // KV
    return k[:, :, :, None].expand(B, S, KV, G, hd).reshape(B, S, KV * G,
                                                            hd)


def _local_sdpa(q, k, v, *, causal: bool):
    q, k, v = (contiguous_grad(t.contiguous()) for t in (q, k, v))
    return flash_ops.sdpa(q, k, v, causal=causal)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: ArchConfig, rt: Runtime, causal: bool) -> torch.Tensor:
    """``flash_ops.sdpa``; on a mesh, on each rank's shard of the batch
    and the heads (see the module's docstring)."""
    if not is_dtensor(q):
        return flash_ops.sdpa(q, k, v, causal=causal)
    from torch.distributed.tensor.experimental import local_map
    sc = rt.sc
    h_axis = sc.div(cfg.n_heads, sc.tp_axis)
    if h_axis is not None and sc.div(cfg.n_kv_heads, h_axis) is None:
        k, v = _expand_kv(k, cfg), _expand_kv(v, cfg)
    spec = (sc.div(q.shape[0], sc.dp_axes), None, h_axis, None)
    q, k, v = (sc.constrain(t, *spec) for t in (q, k, v))
    pl = sc.placements(spec)
    run = local_map(functools.partial(_local_sdpa, causal=causal),
                    out_placements=pl, in_placements=(pl, pl, pl),
                    device_mesh=sc.device_mesh)
    return run(q, k, v)


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
    out = _sdpa(q, k, v, cfg, rt, causal)
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
    write_positions(cache["k"], k_new, cache_len)
    write_positions(cache["v"], v_new, cache_len)
    return _out_proj(p, _attend_cached(q, cache["k"], cache["v"], cfg, rt,
                                       n_live=cache_len + 1), cfg, rt)


def _attend_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ArchConfig, rt: Runtime,
                   n_live: Optional[int] = None) -> torch.Tensor:
    """One query row q (B, 1, H, hd) over a cache k, v (B, n, KV, hd), its
    first ``n_live`` positions (every position when None).  On a DTensor
    cache: with the key heads split over the model axis each rank holds
    whole rows of its heads, and the plain path runs on its shards through
    ``local_map``; with the cache split over its positions it is scored
    whole, the positions from ``n_live`` on masked."""
    live = slice(None, n_live)
    if not is_dtensor(k):
        return _attend_core(q, k[:, live], v[:, live], rt)
    from torch.distributed.tensor.experimental import local_map
    sc = rt.sc
    bs = sc.batch_spec(q.shape[0])
    kv_axis = sc.div(cfg.n_kv_heads, sc.tp_axis)
    if kv_axis is None:
        q = sc.constrain(q, bs, None, None, None)
        return _attend_core(q, k, v, rt, n_live=n_live)
    pl = sc.placements((bs, None, kv_axis, None))
    q = sc.constrain(q, bs, None, kv_axis, None)
    run = local_map(
        lambda q, k, v: _attend_core(q, k[:, live], v[:, live], rt),
        out_placements=pl, in_placements=(pl, pl, pl),
        device_mesh=sc.device_mesh)
    return run(q, k, v)


def write_positions(buf: torch.Tensor, new: torch.Tensor,
                    start: int) -> None:
    """``buf[:, start:start + n] = new`` in place, for a cache ``buf``
    (B, S, ...) and ``new`` (B, n, ...).  On a DTensor ``buf``, whose
    position dim may be sharded, each rank writes the positions of its own
    shard into its local tensor (``new`` placed as ``buf`` is, its
    positions whole)."""
    n = new.shape[1]
    if not is_dtensor(buf):
        buf[:, start:start + n] = new
        return
    from torch.distributed.tensor import Replicate
    mesh, pl = buf.device_mesh, buf.placements
    whole = tuple(Replicate() if p.is_shard(1) else p for p in pl)
    if tuple(new.placements) != whole:
        new = new.redistribute(mesh, whole)
    new = new.to_local()
    lo, hi = _local_span(buf.shape[1], mesh, pl, 1)
    a, b = max(start, lo), min(start + n, hi)
    if a < b:
        buf.to_local()[:, a - lo:b - lo] = new[:, a - start:b - start]


def _local_span(n: int, mesh, placements, dim: int) -> Tuple[int, int]:
    """[lo, hi) of dim ``dim`` (size n) held by this rank: DTensor's split,
    ceil-sized chunks over each mesh axis that shards the dim, major
    first."""
    coord = mesh.get_coordinate()
    lo, size = 0, n
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            lo += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return lo, lo + size


def cross_attn_decode(p: dict, x: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, cfg: ArchConfig,
                      rt: Runtime) -> torch.Tensor:
    """x (B, 1, d) against the encoder's cached keys and values
    ``cross_k`` / ``cross_v`` (B, Se, KV, hd): every position, no mask, no
    cache write, no RoPE; on a mesh as ``attn_decode`` reads its cache."""
    q = _project_q(p, x, cfg, rt)
    return _out_proj(p, _attend_cached(q, cross_k, cross_v, cfg, rt), cfg,
                     rt)


def _attend_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 rt: Runtime, n_live: Optional[int] = None) -> torch.Tensor:
    """One query row q (B, 1, H, hd) over k and v (B, n, KV, hd): the
    (B, 1, H, hd) attention output; with ``n_live``, the positions from
    ``n_live`` on are masked to -1e30 (probability 0)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    cd = rt.compute_dtype
    k = k.permute(0, 2, 3, 1)                        # (B, KV, hd, n)
    v = v.permute(0, 2, 1, 3)                        # (B, KV, n, hd)
    qg = q[:, 0].unflatten(1, (KV, H // KV))         # one query row
    scores = accum_product(qg, k, rt) * (hd ** -0.5)  # (B, KV, G, n)
    if n_live is not None:
        pos = torch.arange(scores.shape[-1], device=scores.device)
        scores = torch.where(pos < n_live, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.matmul(w, v.to(cd))                  # (B, KV, G, hd)
    return out.reshape(B, 1, H, hd)
