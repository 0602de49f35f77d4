"""GP surrogate stages of the bank pipeline, batched over studies.

The PyTorch counterpart of the StudyBank half of ``repro.core.gp``: the
hyperparameter fit (Adam on -log marginal likelihood), the masked Cholesky
factors, lengthscale prescaling, pending absorption, the GP-BUCB pick and
the clustering pick.
Each function takes every study at once along a leading axis B and runs on
the device its inputs live on.

The reference splits the pick into distance, ``exp`` and pick programs to
work around XLA:CPU's scalar ``exp`` in fused code.  Here
``ops.score_cov`` computes the Matern block, the mean and the variance in one
pass, so that split has no counterpart.

``torch.linalg.cholesky_ex`` is used instead of ``cholesky``: a study whose
matrix is not positive definite gets a NaN factor, as ``jnp.linalg.cholesky``
gives it, and does not raise for the whole bank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import kmeans, scoring
from repro_torch.kernels.gp_acquisition import ops, ref

LOG_LS_MIN = math.log(0.01)
LOG_LS_MAX = math.log(10.0)


def matern52(x1: torch.Tensor, x2: torch.Tensor, ls: torch.Tensor,
             var: torch.Tensor) -> torch.Tensor:
    """x1 (B, n, d), x2 (B, m, d), ls (B, d) ARD lengthscales, var (B,)
    -> (B, n, m): the kernels' Matern on lengthscale-divided rows."""
    return ref.matern52(x1 / ls[:, None, :], x2 / ls[:, None, :], var)


def _masked_kernel(X, mask, ls, var, noise):
    K = matern52(X, X, ls, var) * (mask[:, :, None] * mask[:, None, :])
    diag = torch.where(mask > 0, (var + noise + scoring.jitter(var))[:, None],
                       1.0)
    return torch.diagonal_scatter(K, diag, dim1=-2, dim2=-1)


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[:, None, None], L, torch.nan).contiguous()


def cholesky_masked(X, mask, ls, var, noise) -> torch.Tensor:
    return _cholesky(_masked_kernel(X, mask, ls, var, noise))


def _nll(X, z, mask, n_eff, log_ls, log_var, log_noise):
    """Per-study -log marginal likelihood / n_eff, (B,)."""
    ls = torch.exp(log_ls)
    var = torch.exp(log_var)
    noise = torch.exp(log_noise) + 1e-5
    L = cholesky_masked(X, mask, ls, var, noise)
    zm = z * mask
    alpha = torch.cholesky_solve(zm[..., None], L)[..., 0]
    logdiag = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    ll = (-0.5 * (zm * alpha).sum(-1) - (logdiag * mask).sum(-1)
          - 0.5 * n_eff * math.log(2 * math.pi))
    return -ll / n_eff


def fit_hypers_bank(X, y, mask, log_ls, log_var, log_noise, y_mean, y_std,
                    steps: int = 40):
    """Adam on -log ML for every study at once, warm-started from the given
    log-hypers with fresh moments (lr 0.08, b1 0.9, b2 0.999, ``log_ls``
    clipped to [log 0.01, log 10] after each step).  ``y`` is the raw signed
    history; ``(y_mean, y_std)`` are the frozen host standardization.  The
    gradient of the sum of per-study losses is each study's own gradient,
    since the studies share no parameter.  Returns (log_ls, log_var,
    log_noise)."""
    z = ((y - y_mean[:, None]) / y_std[:, None]) * mask
    n_eff = torch.clamp(mask.sum(-1), min=1.0)
    params = [log_ls.clone(), log_var.clone(), log_noise.clone()]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    lr, b1, b2 = 0.08, 0.9, 0.999
    one = torch.ones((), dtype=torch.float32, device=X.device)
    for i in range(steps):
        ps = [p.detach().requires_grad_(True) for p in params]
        loss = _nll(X, z, mask, n_eff, *ps).sum()
        grads = torch.autograd.grad(loss, ps)
        t = float(i + 1)
        c1 = 1 - (b1 * one) ** t
        c2 = 1 - (b2 * one) ** t
        with torch.no_grad():
            for k, g in enumerate(grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                params[k] = params[k] - lr * (m[k] / c1) / (
                    torch.sqrt(v[k] / c2) + 1e-8)
            params[0] = torch.clamp(params[0], LOG_LS_MIN, LOG_LS_MAX)
    return params[0], params[1], params[2]


def bank_factors(X, mask, ls, var, noise):
    """Masked-kernel Cholesky factor, its inverse, and the power-iteration
    condition estimate for every study: (L, Linv, cond)."""
    L = cholesky_masked(X, mask, ls, var, noise)
    return L, scoring.linv_from_chol(L), scoring.cond_estimate(L, mask)


def _pad_dim(d: int) -> int:
    return max(8, -(-d // 8) * 8)


def _prescale(A: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    B, n, d = A.shape
    out = torch.zeros((B, n, _pad_dim(d)), dtype=torch.float32,
                      device=A.device)
    out[..., :d] = A / ls[:, None, :]
    return out


def bank_prescale_X(X: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Lengthscale-divide and pad the observation block (B, na, d) ->
    (B, na, dp); cached with the factors."""
    return _prescale(X, ls)


def bank_prescale_C(C: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Prescale the fresh candidate block (B, S, d) -> (B, S, dp).  S is not
    padded: the kernels mask their ragged last block themselves."""
    return _prescale(C, ls)


def bank_absorb(Xs, y, mask, L, Linv, P, n_pending, n_obs, ls, var, noise):
    """Hallucinate each study's in-flight trials ``P`` (B, pend_cap, d, raw)
    into copies of its system; returns the extended (Xs, y, mask, L,
    Linv)."""
    Ps = _prescale(P, ls)
    return scoring.absorb_pending(Xs.clone(), y.clone(), mask.clone(),
                                  L.clone(), Linv.clone(), Ps, n_pending,
                                  n_obs, var, noise)


def bank_pick(Cs, Xs, y, mask, L, Linv, var, noise, n_obs_eff, domain_size,
              batch_size: int) -> torch.Tensor:
    """Score every candidate through ``ops.score_cov`` and run the GP-BUCB
    slot loop on copies of the factors.  ``n_obs_eff`` is ``n_obs +
    n_pending``.  Returns picked candidate indices (B, batch_size)."""
    alpha = scoring.kinv_matvec(Linv, y * mask)
    mu, sig2, K = ops.score_cov(Cs, Xs, mask, Linv, alpha, var, noise)
    return scoring.pick_downdate_from_scores(
        Cs, mu, sig2, K, L.clone(), Linv.clone(), var, noise, n_obs_eff,
        domain_size, batch_size)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def bank_cluster_pick(Cs, C, Xs, y, mask, Linv, var, noise, n_obs_eff,
                      domain_size, u, n_top: int,
                      batch_size: int) -> torch.Tensor:
    """The clustering strategy (Groves & Pyzer-Knapp 2018) for every study:
    score every candidate through ``ops.score_cov``, UCB at the ask's
    observation count ``n_obs_eff``, then ``cluster_pick`` on the raw
    (unscaled) candidate rows ``C`` (B, S, d).  Returns picked candidate
    indices (B, batch_size)."""
    alpha = scoring.kinv_matvec(Linv, y * mask)
    mu, sig2, _ = ops.score_cov(Cs, Xs, mask, Linv, alpha, var, noise)
    beta = scoring.adaptive_beta_dev(n_obs_eff, domain_size)
    acq = mu + torch.sqrt(beta)[:, None] * torch.sqrt(sig2)
    return cluster_pick(acq, C, u, n_top, batch_size)


def cluster_pick(acq, C, u, n_top: int, batch_size: int) -> torch.Tensor:
    """The clustering head on the surface ``acq`` (B, S): keep the
    ``n_top`` best (``top_k``), weight them by ``acq - acq[n_top - 1] +
    1e-6``, cluster their rows of ``C`` (B, S, d) into ``batch_size``
    clusters (``kmeans.kmeans`` from the per-study uniforms ``u``), and
    pick each cluster's best not yet picked, falling back to the best of
    the remaining top set when its cluster has none left.  Returns picked
    candidate indices (B, batch_size)."""
    top_vals, top_idx = top_k(acq, n_top)
    w = top_vals - top_vals[:, n_top - 1:n_top] + 1e-6
    B = C.shape[0]
    rows = torch.arange(B, device=C.device)
    assign = kmeans.kmeans(C[rows[:, None], top_idx], w, u)
    picked = torch.zeros((B, n_top), dtype=torch.bool, device=C.device)
    picks = torch.zeros((B, batch_size), dtype=torch.int64,
                        device=C.device)
    for c in range(batch_size):
        in_c = (assign == c) & ~picked
        sel = torch.where(in_c.any(-1, keepdim=True), in_c, ~picked)
        j = torch.argmax(torch.where(sel, top_vals, -torch.inf), dim=-1)
        picked[rows, j] = True
        picks[:, c] = top_idx[rows, j]
    return picks
