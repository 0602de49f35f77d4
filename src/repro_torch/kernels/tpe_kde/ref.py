"""Plain PyTorch versions of the product-Parzen (TPE) scoring kernels,
batched over studies.

TPE models each encoded dimension of the good/bad observation splits with a
1D Gaussian Parzen window and scores candidates by the log-density ratio
l(x)/g(x):

    dens_j(c) = (1/n) sum_i w_i * exp(-(c_j - x_ij)^2 * a_ij)
    log_kde(c) = sum_j log(dens_j(c) + 1e-12)
    score(c)   = log_kde_good(c) - log_kde_bad(c)

Every array carries a leading study axis B: candidates (B, S, dp),
observations and per-row per-dim scales (B, na, dp), memberships (B, na),
``scal`` (B, 4) and the live row count ``n_live`` (B,).  Rows at or past
``n_live[b]`` contribute nothing (the bank lays out observed rows, then
pending rows, then zeros); dims past ``d_true`` are padding and never read.

The (B, block, n, d) temporary is capped at ``_MAX_ELEMS`` elements by
streaming the candidates in chunks, as the JAX package's oracle does, so a
fleet-sized call never builds gigabytes on the CPU.

These are what a wrapper in ``ops`` runs for a CPU tensor, and what the CUDA
kernels are held against on the card.  ``tpe_scores_rowseq`` and
``parzen_logdens_rowseq`` write out the CUDA kernel's own arithmetic, row by
row in float32, in two layouts: ``compacted=False`` adds every live row into
every sum, as the first CUDA design did, and ``compacted=True`` adds only the
rows of each split's list, as the kernel does now.
"""
from __future__ import annotations

import torch

_MAX_ELEMS = 4_000_000   # (B, block, n, d) temporary cap (16 MB f32)


def scott_bandwidth(n_pts: torch.Tensor, d_true: int) -> torch.Tensor:
    """The host oracle's Scott-rule bandwidth: count- and dim-dependent
    only (not data-dependent), floored away from zero."""
    n = torch.clamp(n_pts, min=1.0)
    return torch.clamp(n ** (-1.0 / (d_true + 4)), min=1e-2) * 0.5 + 1e-3


def _live(pts: torch.Tensor, n_live: torch.Tensor, *ws: torch.Tensor):
    """Trim the row axis to the largest live count and zero the weights of
    rows past each study's own count."""
    n = max(0, min(int(n_live.max()), pts.shape[1])) if len(n_live) else 0
    row = torch.arange(n, device=pts.device)
    keep = (row[None, :] < n_live[:, None].long()).to(pts.dtype)
    return pts[:, :n], [w[:, :n] * keep for w in ws], n


def _chunks(S: int, per_cand: int):
    block = max(1, _MAX_ELEMS // max(per_cand, 1))
    for s0 in range(0, S, block):
        yield slice(s0, min(S, s0 + block))


def tpe_scores_ref(cands, pts, a, wg, wb, scal, n_live, *, d_true: int):
    """(B, S) l/g log-ratio: cands (B, S, dp), pts and a (B, na, dp),
    wg and wb (B, na), scal (B, 4) = [1/n_g, 1/n_b, 0, 0], n_live (B,)."""
    B, S, _ = cands.shape
    X, (wg, wb), n = _live(pts, n_live, wg, wb)
    X = X[:, None, :, :d_true]                       # (B, 1, n, d)
    A = a[:, None, :n, :d_true]
    wg, wb = wg[:, None, :, None], wb[:, None, :, None]
    inv_g, inv_b = scal[:, 0, None, None], scal[:, 1, None, None]
    out = torch.empty((B, S), dtype=cands.dtype, device=cands.device)
    for sl in _chunks(S, B * n * d_true):
        d2 = (cands[:, sl, None, :d_true] - X) ** 2   # (B, block, n, d)
        E = torch.exp(-d2 * A)          # one exp serves both densities
        densg = (E * wg).sum(2) * inv_g + 1e-12
        densb = (E * wb).sum(2) * inv_b + 1e-12
        out[:, sl] = (torch.log(densg) - torch.log(densb)).sum(-1)
    return out


def parzen_logdens_ref(cands, pts, w, scal, n_live, *, d_true: int):
    """(B, S) product-Parzen log-density of cands (B, S, dp) under the
    masked point set pts (B, na, dp), w (B, na); scal (B, 4) =
    [1/(2 bw^2), 1/n, 0, 0]."""
    B, S, _ = cands.shape
    X, (w,), n = _live(pts, n_live, w)
    X = X[:, None, :, :d_true]
    w = w[:, None, :, None]
    inv2, inv_n = scal[:, 0, None, None, None], scal[:, 1, None, None]
    out = torch.empty((B, S), dtype=cands.dtype, device=cands.device)
    for sl in _chunks(S, B * n * d_true):
        d2 = (cands[:, sl, None, :d_true] - X) ** 2
        dens = (torch.exp(-d2 * inv2) * w).sum(2) * inv_n + 1e-12
        out[:, sl] = torch.log(dens).sum(-1)
    return out


def fmaf32(x, y, z):
    """fmaf(x, y, z) on float32 tensors: the product is exact in float64 and
    the sum is rounded to float64, then to float32.  Where x * y is itself a
    float32 (x in {0, 1}) that is one rounding of the sum, since float64 has
    more than 2 x 24 + 2 bits; otherwise the double rounding may differ from
    fmaf in the last bit."""
    return (x.double() * y.double() + z.double()).float()


def _rows_sum(c, x, a, w, rows):
    """fmaf(w_i, exp(-(c - x_i)^2 a_i), sum) for i in ``rows``, in order:
    c (S, d); x, a (n, d); w (n,).  Returns the (S, d) sums."""
    acc = torch.zeros_like(c)
    for i in rows:
        d = c - x[i]
        acc = fmaf32(w[i], torch.exp(-(d * d) * a[i]), acc)
    return acc


def _rowseq(cands, pts, a, ws, scal, n_live, d_true, compacted):
    """The kernels' sums and tails: ``ws`` holds one (B, na) weight per
    density (tpe: good, bad; parzen: w), ``scal[:, l]`` density l's 1/n."""
    B, S, _ = cands.shape
    out = torch.empty((B, S), dtype=torch.float32)
    floor = torch.tensor(1e-12, dtype=torch.float32)
    for b in range(B):
        n = max(0, min(int(n_live[b]), pts.shape[1]))
        c = cands[b, :, :d_true]
        x, ab = pts[b, :n, :d_true], a[b, :n, :d_true]
        w = [wl[b, :n] for wl in ws]
        if compacted:          # each split's list: its rows with w != 0
            sums = [_rows_sum(c, x, ab, wl, torch.nonzero(wl).flatten())
                    for wl in w]
        else:                  # every live row, one exp into every sum
            sums = [torch.zeros_like(c) for _ in w]
            for i in range(n):
                d = c - x[i]
                e = torch.exp(-(d * d) * ab[i])
                sums = [fmaf32(wl[i], e, acc) for wl, acc in zip(w, sums)]
        logs = [torch.log(fmaf32(acc, scal[b, l], floor))
                for l, acc in enumerate(sums)]
        score = torch.zeros(S, dtype=torch.float32)
        for j in range(d_true):
            term = logs[0][:, j]
            if len(logs) == 2:
                term = term - logs[1][:, j]
            score = score + term
        out[b] = score
    return out


def tpe_scores_rowseq(cands, pts, a, wg, wb, scal, n_live, *, d_true: int,
                      compacted: bool):
    """(B, S) ``tpe_scores`` as the CUDA kernel computes it, on the CPU in
    float32: per dim, each density's sum over its rows in ascending order,
    one fmaf(w_i, exp(-(d*d) * a_ij), sum) a row, then
    logf(fmaf(sum_g, 1/n_g, 1e-12)) - logf(fmaf(sum_b, 1/n_b, 1e-12))
    added over the dims in order.  Arguments as ``tpe_scores_ref``."""
    return _rowseq(cands, pts, a, (wg, wb), scal, n_live, d_true, compacted)


def parzen_logdens_rowseq(cands, pts, w, scal, n_live, *, d_true: int,
                          compacted: bool):
    """(B, S) ``parzen_logdens`` as the CUDA kernel computes it: one list,
    every row's scale the study's 1/(2 bw^2).  Arguments as
    ``parzen_logdens_ref``."""
    a = scal[:, 0, None, None].expand(pts.shape)
    return _rowseq(cands, pts, a, (w,), scal[:, 1:], n_live, d_true,
                   compacted)
