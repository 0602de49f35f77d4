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
kernels are held against on the card.
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
