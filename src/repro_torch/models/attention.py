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

On a mesh (``DTensor`` activations, ``rt.sc`` set) the kernel stays, on
each rank's shard, split as the reference's ``_shard_plan`` splits the
score tensor, with the batch over the data axes:
  * heads that divide the model axis: q, k and v split over their heads,
    ``flash_ops.sdpa`` on each rank's local q, k and v
    (``common.on_local_shards``, a ``local_map``), its gradient through
    the kernel's autograd Function.
    Where the query heads divide the axis and the key/value heads do not,
    k and v are expanded to the query heads first, as the reference's
    dense path expands them;
  * heads that do not (smollm's 9, yi's 56, whisper's 20 on a 16-wide
    axis), ``rt.attn_fallback`` "kvseq" (the default): k and v split over
    their positions, q whole.  Each rank runs the forward kernel on its
    keys with the causal diagonal moved by its first key
    (``shard_offset``) and keeps the row log-sum-exp (``kvseq_piece``);
    ``kvseq_combine`` merges the pieces in fp32 through three functional
    all-reduces over the model axis (the row max, the sum of exp(lse_r -
    max) and the weighted outputs), the counterpart of the reference's
    partial max / sum all-reduces (the outputs' sum in fp32, see
    ``kvseq_combine``).  The gradient (``piece_bwd``) is the backward
    kernel on the rank's keys given the combined output and log-sum-exp:
    exact dk and dv, and the rank's share of dq, summed over the model
    axis as a partial gradient;
  * "qseq": q split over its rows, k and v whole; each rank runs the
    forward kernel on its rows with the diagonal moved by its first row
    (``qseq_piece``) and the backward kernel on them (``piece_bwd``), and
    the gradients of the whole k and v are partial sums over the model
    axis.  K is not cut to the keys a rank can see (the dry run counts a
    rank's work at rank 0's shapes times the ranks).  A rank that the
    split leaves no rows launches nothing and adds zero to dk and dv.
Both run in one autograd Function (``_SplitAttention``), and ``chip_smoke``
runs the same pieces rank after rank on one card.
A sequence split follows DTensor's (ceil-sized chunks, the last short:
whisper's 1500 frames are 15 x 94 + 90 over 16), where the reference's
``sc.div`` keeps a length that the axis does not divide whole
(``spans``); the outputs' global shapes are given to
``common.on_local_shards``, where ``local_map`` would infer them from even
shards.  A DTensor cache, whose
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
from repro_torch.models.common import (Runtime, ShardCtx, accum_product,
                                       apply_rope, dense_init,
                                       on_local_shards, rope_tables)

FALLBACKS = ("kvseq", "qseq")


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


def _out_proj(p: dict, out: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The output projection of the heads' outputs (B, S, H * hd)."""
    return out @ p["wo"].to(rt.compute_dtype)


def _expand_kv(k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd), each key/value head repeated for
    its group of query heads."""
    B, S, KV, hd = k.shape
    G = cfg.n_heads // KV
    return k[:, :, :, None].expand(B, S, KV, G, hd).reshape(B, S, KV * G,
                                                            hd)


def _shard_plan(cfg: ArchConfig, rt: Runtime):
    """(head_axis, kvseq_axis, qseq_axis), at most one of them set, as the
    reference's ``_shard_plan``: the heads over the model axis where they
    divide it, else the keys' positions ("kvseq", the default) or the
    query rows ("qseq") of the score tensor; all None without a model
    axis."""
    if rt.attn_fallback not in FALLBACKS:
        raise ValueError(f"attn_fallback {rt.attn_fallback!r} is not one "
                         f"of {FALLBACKS}")
    sc = rt.sc
    h_axis = sc.div(cfg.n_heads, sc.tp_axis)
    if h_axis is not None:
        return h_axis, None, None
    if rt.attn_fallback == "qseq":
        return None, None, sc.tp_axis
    return None, sc.tp_axis, None


def shard_offset(fallback: str, start: int, Sq: int, Sk: int) -> int:
    """The causal diagonal of one rank's call: the whole call's Sk - Sq,
    moved by the rank's first query row (``qseq``) or first key
    (``kvseq``)."""
    return Sk - Sq + start if fallback == "qseq" else Sk - Sq - start


def spans(n: int, ranks: int):
    """[lo, hi) of each rank's share of n: DTensor's split, ceil-sized
    chunks, the last short (or empty: 100 rows over 16 ranks leave the last
    none)."""
    chunk = -(-n // ranks)
    return [(min(n, r * chunk), min(n, (r + 1) * chunk))
            for r in range(ranks)]


def qseq_piece(q, k, v, causal: bool, offset: int):
    """One rank's piece of qseq attention: (out, lse) of this rank's query
    rows q over all the keys (an empty row shard launches nothing); its
    gradient is ``piece_bwd`` given these."""
    return flash_ops.sdpa_lse(q, k, v, causal=causal, causal_offset=offset)


def kvseq_piece(q, k, v, causal: bool, offset: int):
    """One rank's piece of kvseq attention: (out, lse) of q over this
    rank's keys k, v, the row log-sum-exp -inf for a row that sees none
    of them (the kernel writes +inf there)."""
    B, Sq, H, _ = q.shape
    if k.shape[1] == 0:   # an uneven split may leave a rank no key
        return (torch.zeros_like(q),
                q.new_full((B, H, Sq), float("-inf"), dtype=torch.float32))
    out, lse = flash_ops.sdpa_lse(q, k, v, causal=causal,
                                  causal_offset=offset)
    return out, torch.where(lse == float("inf"), float("-inf"), lse)


def kvseq_combine(out, lse, reduce):
    """The pieces merged in fp32: ``out`` (..., B, Sq, H, hd) and ``lse``
    (..., B, H, Sq) of one rank, and ``reduce(t, op)`` that takes "max" or
    "sum" of t over the ranks (an all-reduce on a mesh; ``stacked_reduce``
    where the ranks' pieces lie side by side).  Returns the whole
    attention's (out, lse), lse +inf for a row that no key reaches.

    The weighted outputs are summed in fp32, where the reference sums its
    partial P.V in the compute dtype: one rounding to bf16 at the end, not
    one per rank, for twice the bytes of that all-reduce (B * Sq * H * hd
    * 4 a layer; PERF.md section 7 has the cost on smollm's training
    cell)."""
    m = reduce(lse, "max")
    m = torch.where(m == float("-inf"), 0.0, m)
    e = torch.exp(lse - m)
    s = reduce(e, "sum")
    seen = s > 0
    w = e / torch.where(seen, s, 1.0)
    o = reduce(out.float() * w.transpose(-1, -2)[..., None], "sum")
    return (o.to(out.dtype),
            torch.where(seen, m + torch.log(s), float("inf")))


def stacked_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``kvseq_combine``'s reduce over the ranks' pieces stacked on dim 0
    (each rank's work run in turn in one process)."""
    return t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)


def piece_bwd(q, k, v, out, lse, dout, causal: bool, offset: int):
    """One rank's piece of the gradient of either split: the backward
    kernel on this rank's q and k, v given the attention's ``out`` and
    ``lse`` over these rows.  kvseq: q whole, the keys this rank's, out and
    lse the whole attention's (``kvseq_combine``), giving this rank's share
    of dq, which the ranks sum, and the exact dk, dv of its keys.  qseq:
    this rank's rows and their ``qseq_piece``, giving their exact dq and
    this rank's share of dk, dv."""
    if k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    return flash_ops.sdpa_bwd(q, k, v, out, lse, dout, causal=causal,
                              causal_offset=offset)


class _SplitAttention(torch.autograd.Function):
    """One rank's piece of a split attention: ``qseq_piece`` (``reduce``
    None), or ``kvseq_piece`` merged over the ranks by ``kvseq_combine``
    with ``reduce``; the gradient ``piece_bwd`` (not through the combine:
    the backward kernel has no log-sum-exp gradient, and needs none given
    the whole attention's output)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, offset, reduce):
        if reduce is None:
            out, lse = qseq_piece(q, k, v, causal, offset)
        else:
            out, lse = kvseq_combine(*kvseq_piece(q, k, v, causal, offset),
                                     reduce)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.offset = causal, offset
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return piece_bwd(q, k, v, out, lse, g.to(q.dtype).contiguous(),
                         ctx.causal, ctx.offset) + (None,) * 3


def _all_reduce(group, t: torch.Tensor, op: str) -> torch.Tensor:
    """A functional all-reduce ("max" or "sum") over ``group``: the dry
    run's ``CollectiveLog`` records it, as it records DTensor's own."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(t, op, group)
    return (out.wait() if isinstance(out, funcol.AsyncCollectiveTensor)
            else out)


def _sdpa_seq_split(q, k, v, sc: ShardCtx, axis: str, fallback: str,
                    causal: bool) -> torch.Tensor:
    """Attention with the keys' positions ("kvseq") or the query rows
    ("qseq") split over ``axis``, each rank's call on its shard (see the
    module's docstring): the (B, Sq, H * hd) output, whole over ``axis``.

    Two DTensor limits shape the output.  The heads are flattened on each
    rank: under ``seq_parallel`` the gradient of the flatten comes back
    split over H * hd, which DTensor cannot unflatten where the heads do
    not divide the axis.  And qseq's rows are gathered here, where the
    reference keeps them split into the output projection: DTensor
    flattens (B, S) for that product, and a row split becomes a strided
    shard that it cannot propagate under ``FakeTensorMode`` (the dry
    run)."""
    from torch.distributed.tensor import Partial
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bs = sc.div(B, sc.dp_axes)
    whole = sc.placements((bs, None, None, None))
    split = sc.placements((bs, axis, None, None))
    summed = list(whole)
    summed[sc.mesh.axis_names.index(axis)] = Partial()
    qseq = fallback == "qseq"
    q = sc.constrain(q, bs, axis if qseq else None, None, None)
    k, v = (sc.constrain(t, bs, None if qseq else axis, None, None)
            for t in (k, v))
    start = _local_span(Sq if qseq else Sk, sc.device_mesh, split, 1)[0]
    off = shard_offset(fallback, start, Sq, Sk)
    reduce = (None if qseq else functools.partial(
        _all_reduce, sc.device_mesh.get_group(axis)))
    q_pl, kv_pl, out_pl = ((split, summed, split) if qseq
                           else (summed, split, whole))
    out = on_local_shards(
        lambda q, k, v: _SplitAttention.apply(q, k, v, causal, off,
                                              reduce).flatten(2),
        sc, ((q, q_pl), (k, kv_pl), (v, kv_pl)), out_pl,
        shape=(B, Sq, H * hd))
    return sc.constrain(out, bs, None, None)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: ArchConfig, rt: Runtime, causal: bool) -> torch.Tensor:
    """``flash_ops.sdpa``, the heads flattened: (B, Sq, H * hd); on a mesh,
    on each rank's shard of the batch and the heads, or of a sequence (see
    the module's docstring)."""
    if not is_dtensor(q):
        return flash_ops.sdpa(q, k, v, causal=causal).flatten(2)
    sc = rt.sc
    h_axis, kv_axis, q_axis = _shard_plan(cfg, rt)
    if kv_axis or q_axis:
        return _sdpa_seq_split(q, k, v, sc, kv_axis or q_axis,
                               "kvseq" if kv_axis else "qseq", causal)
    if h_axis is not None and sc.div(cfg.n_kv_heads, h_axis) is None:
        k, v = _expand_kv(k, cfg), _expand_kv(v, cfg)
    spec = (sc.div(q.shape[0], sc.dp_axes), None, h_axis, None)
    q, k, v = (sc.constrain(t, *spec) for t in (q, k, v))
    pl = sc.placements(spec)
    return on_local_shards(
        lambda q, k, v: flash_ops.sdpa(q, k, v, causal=causal).flatten(2),
        sc, [(t, pl) for t in (q, k, v)], pl,
        shape=(q.shape[0], q.shape[1], q.shape[2] * q.shape[3]))


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
    return _out_proj(p, out, rt), (k, v)


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
                                       n_live=cache_len + 1).flatten(2), rt)


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
    """[lo, hi) of dim ``dim`` (size n) held by this rank: DTensor's split
    (``spans``) over each mesh axis that shards the dim, major first."""
    coord = mesh.get_coordinate()
    lo, size = 0, n
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            a, b = spans(size, mesh.size(i))[coord[i]]
            lo, size = lo + a, b - a
    return lo, lo + size


def cross_attn_decode(p: dict, x: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, cfg: ArchConfig,
                      rt: Runtime) -> torch.Tensor:
    """x (B, 1, d) against the encoder's cached keys and values
    ``cross_k`` / ``cross_v`` (B, Se, KV, hd): every position, no mask, no
    cache write, no RoPE; on a mesh as ``attn_decode`` reads its cache."""
    q = _project_q(p, x, cfg, rt)
    return _out_proj(p, _attend_cached(q, cross_k, cross_v, cfg,
                                       rt).flatten(2), rt)


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
