"""Plain PyTorch versions of the GP-BUCB scoring kernels, batched over studies.

Every array carries a leading study axis B.  Candidates ``Cs`` (B, S, dp) and
observations ``Xs`` (B, na, dp) arrive divided by the lengthscales and
zero-padded to ``dp`` columns (padded columns add nothing to a distance).

    K     = matern52(Cs, Xs) * mask                    (B, S, na)
    mu    = K alpha                                    (B, S)
    sig2  = max(var + noise - ||K L^-T||^2, 1e-10)     (B, S)

The variance is the monotone sum of squares through the triangular inverse
factor ``Linv = L^-1``: the conditioning-hardened form of the JAX package.

The Matern polynomial takes the raw squared distance ``d2`` and clamps it only
under the square root.  That is the JAX bank path (``repro.core.gp.bank_pick``
and ``repro.kernels.gp_acquisition.ref``); the Pallas kernel also clamps ``d2``
at 0 before the polynomial.  The port follows the bank path.

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


def matern52(x1: torch.Tensor, x2: torch.Tensor,
             var: torch.Tensor) -> torch.Tensor:
    """Matern-5/2 between prescaled rows: x1 (B, n, dp), x2 (B, m, dp),
    var (B,) -> (B, n, m)."""
    d2 = ((x1 * x1).sum(-1)[..., :, None] + (x2 * x2).sum(-1)[..., None, :]
          - 2.0 * (x1 @ x2.transpose(-1, -2)))
    s = SQRT5 * torch.sqrt(torch.clamp(d2, min=1e-12))
    return var[:, None, None] * (1.0 + s + (5.0 / 3.0) * d2) * torch.exp(-s)


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
