"""Plain PyTorch versions of the GP-BUCB scoring kernels, batched over studies.

Every array carries a leading study axis B.  Candidates ``Cs`` (B, S, dp) and
observations ``Xs`` (B, na, dp) arrive divided by the lengthscales and
zero-padded to ``dp`` columns (padded columns add nothing to a distance).

    K     = matern52(Cs, Xs) * mask                    (B, S, na)
    mu    = K alpha                                    (B, S)
    sig2  = max(var + noise - ||K L^-T||^2, 1e-10)     (B, S)

The variance is the monotone sum of squares through the triangular inverse
factor ``Linv = L^-1``: the conditioning-hardened form of the JAX package.

The Matern polynomial takes the squared distance ``d2`` and clamps it only
under the square root, as the JAX bank path does (``repro.core.gp.bank_pick``
and ``repro.kernels.gp_acquisition.ref``).  ``d2`` is summed from the rows'
differences, column by column (``sqdist``), where the JAX package expands
|x|^2 + |y|^2 - 2 x.y: a lengthscale near its floor makes prescaled rows long
(|x|^2 in the thousands at 0.01), and the expansion then loses the distance of
nearby rows to cancellation, which a float32 variance near the noise level
shows.  Summed from differences, ``d2`` is never negative.

``masked_kernel`` is the fit's kernel matrix and ``fit_grad_ref`` its
gradient, in closed form from K^-1 and alpha (``core.gp.fit_hypers_bank``).

These are what a wrapper in ``ops`` runs for a CPU tensor, and what the CUDA
kernels are held against on the card.  ``score_cov_split`` is the scoring
kernel's own arithmetic (its product K L^-T in split TF32), for the CPU tests
only.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.tc_numerics import split_einsum

SQRT5 = math.sqrt(5.0)


def sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, n, m) between rows x1 (B, n, dp) and x2 (B, m,
    dp), summed from the differences in column order, as the CUDA kernels
    sum them."""
    shape = torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2])
    d2 = torch.zeros(shape + (x1.shape[-2], x2.shape[-2]), dtype=x1.dtype,
                     device=x1.device)
    for k in range(x1.shape[-1]):
        u = x1[..., :, None, k] - x2[..., None, :, k]
        d2 = d2 + u * u
    return d2


def matern52(x1: torch.Tensor, x2: torch.Tensor,
             var: torch.Tensor) -> torch.Tensor:
    """Matern-5/2 between prescaled rows: x1 (B, n, dp), x2 (B, m, dp),
    var (B,) -> (B, n, m)."""
    d2 = sqdist(x1, x2)
    s = SQRT5 * torch.sqrt(torch.clamp(d2, min=1e-12))
    return var[:, None, None] * (1.0 + s + (5.0 / 3.0) * d2) * torch.exp(-s)


def masked_kernel(X, mask, ls, var, noise, jitter):
    """The GP fit's and factors' kernel matrix (B, n, n) of raw rows X (B,
    n, d) under lengthscales ls (B, d): the Matern of ``matern52`` scaled by
    mask_i mask_j off the diagonal, var + noise + jitter on an observed
    row's diagonal, 1 on a masked row's.  var, noise, jitter (B,)."""
    Xs = X / ls[:, None, :]
    K = matern52(Xs, Xs, var) * (mask[:, :, None] * mask[:, None, :])
    diag = torch.where(mask > 0, (var + noise + jitter)[:, None], 1.0)
    return torch.diagonal_scatter(K, diag, dim1=-2, dim2=-1)


def score_cov_ref(Cs, Xs, mask, Linv, alpha, var, noise):
    """(mu, sig2, K) for Cs (B, S, dp) against Xs (B, na, dp), mask (B, na),
    Linv (B, na, na), alpha (B, na), var and noise (B,)."""
    K = matern52(Cs, Xs, var) * mask[:, None, :]
    mu = (K @ alpha[..., None])[..., 0]
    t = K @ Linv.transpose(-1, -2)
    q = (t * t).sum(-1)
    sig2 = torch.clamp((var + noise)[:, None] - q, min=1e-10)
    return mu, sig2, K


def score_cov_split(Cs, Xs, mask, Linv, alpha, var, noise, *,
                    passes: int = 3, chain=None):
    """``score_cov_ref`` with the CUDA kernel's arithmetic: K and mu in fp32
    as there, t = K L^-T by ``split_einsum`` (each operand split into TF32
    hi and lo, lo.hi + hi.lo + hi.hi per 8-deep k-step through the tensor
    cores' truncating accumulator), q = sum_j t_j^2 in fp32.  The kernel
    runs one accumulator over each 64-column tile of t for the whole
    contraction (``chain=None``); tiles of L^-1 above the diagonal are zero,
    and zero products leave that accumulator as it is, so contracting over
    all of na gives the kernel's sums.  ``passes=1`` is one TF32 pass."""
    K = matern52(Cs, Xs, var) * mask[:, None, :]
    mu = (K @ alpha[..., None])[..., 0]
    t = split_einsum("bsk,bjk->bsj", K, Linv, passes=passes, chain=chain)
    q = (t * t).sum(-1)
    sig2 = torch.clamp((var + noise)[:, None] - q, min=1e-10)
    return mu, sig2, K


def var_downdate_ref(Cs, x_star, Kc, u, schur, sig2, var):
    """Rank-1 downdate after absorbing x_star (B, dp) with Schur vector
    u (B, na) and complement schur (B,): returns (sig2', knew), both (B, S).
    ``Kc`` (B, S, na) is the cached cross-covariance block."""
    knew = matern52(Cs, x_star[:, None, :], var)[..., 0]
    proj = knew - (Kc @ u[..., None])[..., 0]
    return (torch.clamp(sig2 - proj * proj / schur[:, None], min=1e-10),
            knew)


def fit_grad_ref(X, mask, Kinv, alpha, ls, var, noise_exp, n_eff):
    """Gradient of each study's -log ML / n_eff (``core.gp._nll``) with
    respect to (log ls_1..d, log var, log noise), (B, d + 2), from
    ``Kinv`` = K^-1 (B, n, n) and ``alpha`` = K^-1 z (B, n):
    0.5 sum_ij W_ij dK_ij / n_eff with W = K^-1 - alpha alpha^T.  X (B, n,
    d) raw rows, mask (B, n), ls (B, d), var, ``noise_exp`` = exp(log
    noise) and n_eff (B,).  dK is that of ``_masked_kernel``: the Matern
    of ``matern52`` (with its clamp of d2) scaled by mask_i mask_j off the
    diagonal, var + noise + ``scoring.jitter(var)`` on an observed row's
    diagonal, constant on a masked row's."""
    n, d = X.shape[1], X.shape[2]
    Xs = X / ls[:, None, :]
    diff = [Xs[:, :, None, k] - Xs[:, None, :, k] for k in range(d)]
    d2 = sqdist(Xs, Xs)
    v = var[:, None, None]
    s = SQRT5 * torch.sqrt(torch.clamp(d2, min=1e-12))
    e = torch.exp(-s)
    k = v * (1.0 + s + (5.0 / 3.0) * d2) * e
    # dk/dlog ls_d over (x_id - x_jd)^2 / ls_d^2: -2 dk/dd2
    g = torch.where(d2 >= 1e-12, (5.0 / 3.0) * v * (1.0 + s) * e,
                    -(10.0 / 3.0) * v * e)
    W = Kinv - alpha[:, :, None] * alpha[:, None, :]
    mm = mask[:, :, None] * mask[:, None, :]
    off = ~torch.eye(n, dtype=torch.bool, device=X.device)
    Wm = torch.where(off & (mm != 0), W * mm, 0.0)
    Wd = torch.where(mask > 0, torch.diagonal(W, dim1=-2, dim2=-1), 0.0)
    dvar_diag = var + torch.where(var >= 1.0, 1e-6 * var, 0.0)
    Wg = Wm * g
    g_ls = torch.stack([(Wg * u * u).sum((1, 2)) for u in diff], -1)
    g_var = (Wm * k).sum((1, 2)) + Wd.sum(-1) * dvar_diag
    g_noise = Wd.sum(-1) * noise_exp
    grad = torch.cat([g_ls, g_var[:, None], g_noise[:, None]], -1)
    return 0.5 * grad / n_eff[:, None]
