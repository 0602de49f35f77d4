"""Plain PyTorch versions of the chunkwise mLSTM kernels (forward and
backward).

* ``mlstm_ref``: the fully recurrent stabilized mLSTM, the counterpart of
  ``repro.kernels.mlstm_chunk.ref.mlstm_ref`` (fp32, one step per token).
* ``mlstm_chunkwise``: the chunkwise function the CUDA kernel computes, the
  counterpart of the chunk body of ``repro.models.xlstm.mlstm``
  (``xlstm.py:99-133``) and of the Pallas ``_mlstm_kernel``: within a chunk
  a decay-masked ``(Q K^T) V``, across chunks a carried (dh, dh) matrix
  memory C, normalizer n and max-stabilizer m.  Any length: the last chunk
  may be short.  Autograd differentiates it; the CPU path of
  ``ops.mlstm_mixer`` is this function.
* ``chunk_gates`` and ``mlstm_chunkwise_bwd``: the backward kernel's own
  decomposition (scalar gate terms, a forward scan of the chunk-boundary
  states, per-chunk intra terms, a reverse scan of dC and dn, then dq, dk,
  dv and the gate gradients), written out in plain PyTorch so that the CPU
  tests hold the kernels' arithmetic against autograd and ``jax.grad``.
* ``split_einsum``, ``mlstm_chunkwise_split`` and ``MlstmChunkSplit``: the
  kernels' tensor-core numerics (every product of two tiles from fp32
  operands split into TF32 hi and lo parts, three products summed with the
  tensor cores' truncation in a fresh accumulator each 8-deep k-step, the
  k-steps added in fp32; the per-token dot products and sums stay fp32),
  for the CPU tests only, never the main path.

Per chunk of L tokens with inclusive cumulative log forget gates b:
    D[t, s] = b_t - b_s + i_s (s <= t),  m_t = max(max_s D[t, s], b_t + m_in)
    h_t = (sum_s (q_t.k_s) e^{D[t,s]-m_t} v_s + e^{b_t+m_in-m_t} C^T q_t)
          / max(|sum_s (q_t.k_s) e^{D[t,s]-m_t} + e^{b_t+m_in-m_t} q_t.n|,
                e^{-m_t})
The stabilizers m cancel from h wherever they appear (numerator and both
branches of the denominator scale alike), so the backward treats them as
constants; autograd of the plain version sends zero-sum terms through them.
Masked entries use the finite ``NEG = -1e30``, never -inf.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# the kernels' tensor-core numerics, kept under these names here
from repro_torch.kernels.tc_numerics import (  # noqa: F401
    KSTEP, mma_step, split_einsum, tf32_trunc)

NEG = -1e30
CHUNK = 64


def mlstm_ref(q, k, v, logi, logf):
    """q/k/v (B, NH, S, dh) fp32; logi/logf (B, NH, S) -> h (B, NH, S, dh),
    one recurrent step per token."""
    B, NH, S, dh = q.shape
    C = q.new_zeros(B, NH, dh, dh)
    n = q.new_zeros(B, NH, dh)
    m = q.new_full((B, NH), NEG)
    hs = []
    for t in range(S):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        li, lf = logi[:, :, t], logf[:, :, t]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhd,bhdv->bhv", qt, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2)


def _chunk_starts(S: int, L: int):
    return [(t0, min(L, S - t0)) for t0 in range(0, S, L)]


def mlstm_chunkwise(q, k, v, logi, logf, *, chunk: int = CHUNK,
                    state: Optional[Tuple] = None,
                    return_state: bool = False):
    """q/k/v (B, NH, S, dh) fp32; logi/logf (B, NH, S) fp32 -> h
    (B, NH, S, dh), in chunks of ``chunk`` tokens (the last one may be
    shorter).  ``state`` (C (B, NH, dh, dh), n (B, NH, dh), m (B, NH)) is the
    carry to start from (zeros and NEG by default); with ``return_state``
    the carry after the last token is returned too."""
    B, NH, S, dh = q.shape
    if state is None:
        C = q.new_zeros(B, NH, dh, dh)
        n = q.new_zeros(B, NH, dh)
        m_in = q.new_full((B, NH), NEG)
    else:
        C, n, m_in = state
    hs = []
    for t0, L in _chunk_starts(S, chunk):
        qf, kf, vf = (t[:, :, t0:t0 + L] for t in (q, k, v))
        lit = logi[:, :, t0:t0 + L]
        b = torch.cumsum(logf[:, :, t0:t0 + L], dim=-1)
        D = b[..., :, None] - b[..., None, :] + lit[..., None, :]
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = D.masked_fill(~tri, NEG)
        m_intra = D.amax(dim=-1)
        m_comb = torch.maximum(m_intra, b + m_in[..., None]).clamp(min=NEG)
        Dn = torch.exp(D - m_comb[..., None])
        inter_w = torch.exp(b + m_in[..., None] - m_comb)
        scores = torch.einsum("bnld,bnsd->bnls", qf, kf) * Dn
        h_num = (torch.einsum("bnls,bnsv->bnlv", scores, vf)
                 + inter_w[..., None] * torch.einsum("bnld,bndv->bnlv", qf,
                                                     C))
        denom = (scores.sum(-1)
                 + inter_w * torch.einsum("bnld,bnd->bnl", qf, n))
        denom = torch.maximum(denom.abs(), torch.exp(-m_comb))
        hs.append(h_num / denom[..., None])
        bL = b[..., -1:]
        dec = bL - b + lit
        m_new = torch.maximum(bL[..., 0] + m_in, dec.amax(dim=-1))
        w_state = torch.exp(bL[..., 0] + m_in - m_new)
        w_tok = torch.exp(dec - m_new[..., None])
        C = (w_state[..., None, None] * C
             + torch.einsum("bnl,bnld,bnlv->bndv", w_tok, kf, vf))
        n = w_state[..., None] * n + torch.einsum("bnl,bnld->bnd", w_tok, kf)
        m_in = m_new
    h = torch.cat(hs, dim=2)
    if return_state:
        return h, (C, n, m_in)
    return h


# --------------------------------------------------------------------------- #
# the backward kernel's decomposition, in plain PyTorch
# --------------------------------------------------------------------------- #
def chunk_gates(logi, logf, chunk: int = CHUNK) -> Dict[str, torch.Tensor]:
    """The scalar gate terms of every token and chunk, as the gate kernel
    computes them: b (inclusive cumulative log f within the chunk), m
    (stabilizer), w (weight of the carried state in h), u (weight of the
    token in the next carried state), each (B, NH, S); wstate (weight of the
    carried state in the next one), (B, NH, nC)."""
    B, NH, S = logi.shape
    m_in = logi.new_full((B, NH), NEG)
    out = {k: [] for k in ("b", "m", "w", "u", "wstate")}
    for t0, L in _chunk_starts(S, chunk):
        li = logi[:, :, t0:t0 + L]
        b = torch.cumsum(logf[:, :, t0:t0 + L], dim=-1)
        D = b[..., :, None] - b[..., None, :] + li[..., None, :]
        tri = torch.ones(L, L, dtype=torch.bool, device=li.device).tril()
        m_intra = D.masked_fill(~tri, NEG).amax(dim=-1)
        m = torch.maximum(m_intra, b + m_in[..., None]).clamp(min=NEG)
        bL = b[..., -1]
        dec = bL[..., None] - b + li
        m_next = torch.maximum(bL + m_in, dec.amax(dim=-1))
        out["b"].append(b)
        out["m"].append(m)
        out["w"].append(torch.exp(b + m_in[..., None] - m))
        out["u"].append(torch.exp(dec - m_next[..., None]))
        out["wstate"].append(torch.exp(bL + m_in - m_next)[..., None])
        m_in = m_next
    return {k: torch.cat(v, dim=-1) for k, v in out.items()}


def clamp_share(q, k, logi, logf, *, chunk: int = CHUNK) -> float:
    """Share of tokens whose denominator the clamp e^{-m} decides, i.e.
    |sum_s S[t, s] + w_t q_t.n_c| <= e^{-m_t} (where the gradient takes no
    term through the denominator)."""
    S = q.shape[2]
    g = chunk_gates(logi, logf, chunk)
    n = q.new_zeros(q.shape[0], q.shape[1], q.shape[3])
    hits = 0
    for c, (t0, L) in enumerate(_chunk_starts(S, chunk)):
        sl = slice(t0, t0 + L)
        b, m, w = g["b"][:, :, sl], g["m"][:, :, sl], g["w"][:, :, sl]
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = b[..., :, None] - b[..., None, :] + logi[:, :, sl][..., None, :]
        P = torch.where(tri, torch.exp(D - m[..., None]), 0.0)
        A = torch.einsum("bntd,bnsd->bnts", q[:, :, sl], k[:, :, sl])
        den_raw = (A * P).sum(-1) + w * torch.einsum("bntd,bnd->bnt",
                                                     q[:, :, sl], n)
        hits += int((den_raw.abs() <= torch.exp(-m)).sum())
        u = g["u"][:, :, sl]
        n = g["wstate"][:, :, c, None] * n + torch.einsum(
            "bnt,bntd->bnd", u, k[:, :, sl])
    return hits / logi.numel()


def _state_scan(X, Y, cx, cy, cn, wstate, chunk: int, reverse: bool,
                mm: Callable = torch.einsum):
    """Snapshots of acc (B, NH, nC, dk, dv) and nacc (B, NH, nC, dk) before
    each chunk's update, in scan order: acc <- wstate_c acc
    + sum_t (cx_t X_t) (cy_t Y_t)^T, nacc <- wstate_c nacc
    + sum_t cx_t cn_t X_t.  Forward (C_c, n_c): X = k, Y = v, cx = u, cy =
    cn = 1.  Reverse (dL/dC_{c+1}, dL/dn_{c+1}): X = q, Y = dh, cx = w,
    cy = 1/den, cn = alpha.  ``mm`` computes the update's product."""
    B, NH, S, dk = X.shape
    starts = _chunk_starts(S, chunk)
    acc = X.new_zeros(B, NH, dk, Y.shape[-1])
    nacc = X.new_zeros(B, NH, dk)
    snaps = [None] * len(starts)
    order = range(len(starts) - 1, -1, -1) if reverse else range(len(starts))
    for c in order:
        t0, L = starts[c]
        snaps[c] = (acc, nacc)
        xs = X[:, :, t0:t0 + L] * cx[:, :, t0:t0 + L, None]
        ys = Y[:, :, t0:t0 + L] * cy[:, :, t0:t0 + L, None]
        ws = wstate[:, :, c]
        acc = ws[..., None, None] * acc + mm("bnti,bntj->bnij", xs, ys)
        nacc = ws[..., None] * nacc + torch.einsum(
            "bnti,bnt->bni", xs, cn[:, :, t0:t0 + L])
    return (torch.stack([s[0] for s in snaps], dim=2),
            torch.stack([s[1] for s in snaps], dim=2))


def mlstm_chunkwise_bwd(q, k, v, logi, logf, h, dh, *, chunk: int = CHUNK,
                        mm: Callable = torch.einsum):
    """Gradients (dq, dk, dv, dlogi, dlogf) of ``mlstm_chunkwise`` at (q, k,
    v, logi, logf) for the upstream gradient ``dh``, given its output h,
    computed the way the backward kernel does; ``mm`` computes the products
    of two tiles (the kernel's tensor-core products), ``torch.einsum`` the
    per-token dot products."""
    S = q.shape[2]
    g = chunk_gates(logi, logf, chunk)
    ones = torch.ones_like(logi)
    Cst, nst = _state_scan(k, v, g["u"], ones, ones, g["wstate"], chunk,
                           reverse=False, mm=mm)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dli, db = torch.zeros_like(logi), torch.zeros_like(logi)
    intra = []
    invden, alpha = torch.zeros_like(logi), torch.zeros_like(logi)
    for c, (t0, L) in enumerate(_chunk_starts(S, chunk)):
        sl = slice(t0, t0 + L)
        qc, kc, vc, gc, hc = (t[:, :, sl] for t in (q, k, v, dh, h))
        b, m, w = g["b"][:, :, sl], g["m"][:, :, sl], g["w"][:, :, sl]
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = b[..., :, None] - b[..., None, :] + logi[:, :, sl][..., None, :]
        P = torch.where(tri, torch.exp(D - m[..., None]), 0.0)
        Sm = mm("bntd,bnsd->bnts", qc, kc) * P
        den_raw = Sm.sum(-1) + w * torch.einsum("bntd,bnd->bnt", qc,
                                                nst[:, :, c])
        den = torch.maximum(den_raw.abs(), torch.exp(-m))
        gh = (gc * hc).sum(-1)
        free = den_raw.abs() > torch.exp(-m)      # the clamp does not win
        a = torch.where(free, -gh / den * torch.sign(den_raw), 0.0)
        dS = torch.where(tri, mm("bntj,bnsj->bnts", gc, vc)
                         / den[..., None] + a[..., None], 0.0)
        dA, dD = dS * P, dS * Sm
        invden[:, :, sl], alpha[:, :, sl] = 1.0 / den, a
        dli[:, :, sl] += dD.sum(-2)
        db[:, :, sl] += dD.sum(-1) - dD.sum(-2)
        intra.append((Sm, dA))
    dCa, dna = _state_scan(q, dh, g["w"], invden, alpha, g["wstate"], chunk,
                           reverse=True, mm=mm)
    for c, (t0, L) in enumerate(_chunk_starts(S, chunk)):
        sl = slice(t0, t0 + L)
        Sm, dA = intra[c]
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        gd = dh[:, :, sl] * invden[:, :, sl, None]
        w, u = g["w"][:, :, sl], g["u"][:, :, sl]
        C, n, dC, dn = Cst[:, :, c], nst[:, :, c], dCa[:, :, c], dna[:, :, c]
        Y = mm("bnij,bntj->bnti", C, gd) + \
            alpha[:, :, sl, None] * n[:, :, None]
        Z = mm("bnij,bnsj->bnsi", dC, vc) + dn[:, :, None]
        dq[:, :, sl] = mm("bnts,bnsi->bnti", dA, kc) + w[..., None] * Y
        dk[:, :, sl] = mm("bnts,bnti->bnsi", dA, qc) + u[..., None] * Z
        dv[:, :, sl] = mm("bnts,bntj->bnsj", Sm, gd) + \
            u[..., None] * mm("bnsi,bnij->bnsj", kc, dC)
        ddec = (kc * Z).sum(-1) * u
        dws = (C * dC).sum((-1, -2)) + (n * dn).sum(-1)
        db[:, :, sl] += (qc * Y).sum(-1) * w - ddec
        db[:, :, t0 + L - 1] += ddec.sum(-1) + dws * g["wstate"][:, :, c]
        dli[:, :, sl] += ddec
    dlf = torch.zeros_like(logf)
    for t0, L in _chunk_starts(S, chunk):
        sl = slice(t0, t0 + L)
        dlf[:, :, sl] = db[:, :, sl].flip(-1).cumsum(-1).flip(-1)
    return dq, dk, dv, dli, dlf


# --------------------------------------------------------------------------- #
# the tensor-core kernels' numerics, in plain PyTorch (tests only)
# --------------------------------------------------------------------------- #
def mlstm_chunkwise_split(q, k, v, logi, logf, *, chunk: int = CHUNK,
                          passes: int = 3, chain: Optional[int] = 1):
    """The forward kernel's arithmetic: ``mlstm_chunkwise`` through its
    stages (gate terms, the state scan, per chunk Q K^T, the denominators
    and S V + w Q C_c), each product of two tiles by ``split_einsum``
    (``passes`` and ``chain`` as it takes them)."""
    def mm(eq, a, b):
        return split_einsum(eq, a, b, passes=passes, chain=chain)

    S = q.shape[2]
    g = chunk_gates(logi, logf, chunk)
    ones = torch.ones_like(logi)
    Cst, nst = _state_scan(k, v, g["u"], ones, ones, g["wstate"], chunk,
                           reverse=False, mm=mm)
    hs = []
    for c, (t0, L) in enumerate(_chunk_starts(S, chunk)):
        sl = slice(t0, t0 + L)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        b, m, w = g["b"][:, :, sl], g["m"][:, :, sl], g["w"][:, :, sl]
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = b[..., :, None] - b[..., None, :] + logi[:, :, sl][..., None, :]
        P = torch.where(tri, torch.exp(D - m[..., None]), 0.0)
        Sm = mm("bntd,bnsd->bnts", qc, kc) * P
        den_raw = Sm.sum(-1) + w * torch.einsum("bntd,bnd->bnt", qc,
                                                nst[:, :, c])
        den = torch.maximum(den_raw.abs(), torch.exp(-m))
        num = mm("bnts,bnsj->bntj", Sm, vc) + \
            w[..., None] * mm("bnti,bnij->bntj", qc, Cst[:, :, c])
        hs.append(num / den[..., None])
    return torch.cat(hs, dim=2)


class MlstmChunkSplit(torch.autograd.Function):
    """``MlstmChunk`` with the kernels' numerics on any device: forward
    ``mlstm_chunkwise_split``, backward ``mlstm_chunkwise_bwd`` with the
    same split products."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf):
        h = mlstm_chunkwise_split(q, k, v, logi, logf)
        ctx.save_for_backward(q, k, v, logi, logf, h)
        return h

    @staticmethod
    def backward(ctx, g):
        return mlstm_chunkwise_bwd(*ctx.saved_tensors, g, mm=split_einsum)
