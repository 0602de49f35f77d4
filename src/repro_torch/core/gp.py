"""GP surrogate of the tuner: the bank pipeline's stages, batched over
studies, and one study's GP for the strategies.

The PyTorch counterpart of ``repro.core.gp``.  The bank half: the
hyperparameter fit (Adam on -log marginal likelihood), the masked Cholesky
factors, lengthscale prescaling, pending absorption, the GP-BUCB pick and
the clustering pick.  Each takes every study at once along a leading axis
B and runs on the device its inputs live on.  The single-study half (after
the bank's): the posterior, rank-1 appends, the fused GP-BUCB proposals on
the L-based path and on the factor core, and the ``GaussianProcess``
facade the strategies hold.

The reference splits the pick into distance, ``exp`` and pick programs to
work around XLA:CPU's scalar ``exp`` in fused code.  Here
``ops.score_cov`` computes the Matern block, the mean and the variance in one
pass, so that split has no counterpart.

``torch.linalg.cholesky_ex`` is used instead of ``cholesky``: a study whose
matrix is not positive definite gets a NaN factor, as ``jnp.linalg.cholesky``
gives it, and does not raise for the whole bank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.sanitizers import EntryPoint, to_device, to_host
from repro_torch.core import kmeans, scoring
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gp_acquisition import ops, ref

LOG_LS_MIN = math.log(0.01)
LOG_LS_MAX = math.log(10.0)


def matern52(x1: torch.Tensor, x2: torch.Tensor, ls: torch.Tensor,
             var: torch.Tensor) -> torch.Tensor:
    """x1 (B, n, d), x2 (B, m, d), ls (B, d) ARD lengthscales, var (B,)
    -> (B, n, m): the kernels' Matern on lengthscale-divided rows."""
    return ref.matern52(x1 / ls[:, None, :], x2 / ls[:, None, :], var)


def _masked_kernel(X, mask, ls, var, noise):
    """The masked kernel matrix (B, n, n) of the fit and the factors, built
    in one pass (``ops.masked_kernel``; ``noise`` with its floor)."""
    return ops.masked_kernel(X.contiguous(), mask.contiguous(),
                             ls.contiguous(), var.contiguous(),
                             noise.contiguous(), scoring.jitter(var))


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[:, None, None], L, torch.nan).contiguous()


def cholesky_masked(X, mask, ls, var, noise) -> torch.Tensor:
    return _cholesky(_masked_kernel(X, mask, ls, var, noise))


def _nll(X, z, mask, n_eff, log_ls, log_var, log_noise):
    """Per-study -log marginal likelihood / n_eff, (B,): the fit's loss,
    kept as its plain reference (the fit takes its gradient in closed
    form, ``_nll_grad``)."""
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


def _nll_grad(X, z, mask, n_eff, log_ls, log_var, log_noise):
    """Gradient of ``_nll`` with respect to (log_ls, log_var, log_noise),
    (B, d + 2), in closed form: 0.5 sum_ij W_ij dK_ij / n_eff with W =
    K^-1 - alpha alpha^T and alpha = K^-1 z (``z`` masked).  K^-1 is the
    product of the factor's inverse with its transpose, in full float32;
    ``ops.fit_grad`` contracts W with dK.  A study whose K is not positive
    definite gets a NaN factor, so a NaN gradient, in its own row only."""
    ls = torch.exp(log_ls)
    var = torch.exp(log_var)
    noise_exp = torch.exp(log_noise)
    L = cholesky_masked(X, mask, ls, var, noise_exp + 1e-5)
    Linv = scoring.linv_from_chol(L)
    Kinv = Linv.mT @ Linv
    alpha = scoring.kinv_matvec(Linv, z)
    return ops.fit_grad(X, mask, Kinv, alpha, ls, var, noise_exp, n_eff)


def fit_hypers_bank(X, y, mask, log_ls, log_var, log_noise, y_mean, y_std,
                    steps: int = 40):
    """Adam on -log ML for every study at once, warm-started from the given
    log-hypers with fresh moments (lr 0.08, b1 0.9, b2 0.999, ``log_ls``
    clipped to [log 0.01, log 10] after each step).  ``y`` is the raw signed
    history; ``(y_mean, y_std)`` are the frozen host standardization.  Each
    step takes every study's own gradient in closed form (``_nll_grad``).
    The log-hypers are updated as one (B, d + 2) tensor, elementwise as
    three would be.  Returns (log_ls, log_var, log_noise)."""
    X = X.contiguous()
    mask = mask.contiguous()
    z = ((y - y_mean[:, None]) / y_std[:, None]) * mask
    n_eff = torch.clamp(mask.sum(-1), min=1.0)
    d = X.shape[-1]
    p = torch.cat([log_ls, log_var[:, None], log_noise[:, None]], -1)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    # the clip of log_ls alone: the other columns pass unchanged
    lo = torch.full((d + 2,), -math.inf, dtype=p.dtype, device=p.device)
    hi = torch.full((d + 2,), math.inf, dtype=p.dtype, device=p.device)
    lo[:d] = LOG_LS_MIN
    hi[:d] = LOG_LS_MAX
    lr, b1, b2 = 0.08, 0.9, 0.999
    one = torch.ones((), dtype=torch.float32, device=X.device)
    for i in range(steps):
        g = _nll_grad(X, z, mask, n_eff, p[:, :d], p[:, d], p[:, d + 1])
        t = float(i + 1)
        c1 = 1 - (b1 * one) ** t
        c2 = 1 - (b2 * one) ** t
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8)
        p = torch.clamp(p, lo, hi)
    return (p[:, :d].contiguous(), p[:, d].contiguous(),
            p[:, d + 1].contiguous())


def bank_factors(X, mask, ls, var, noise):
    """Masked-kernel Cholesky factor, its inverse, and the power-iteration
    condition estimate for every study: (L, Linv, cond)."""
    L = cholesky_masked(X, mask, ls, var, noise)
    return L, scoring.linv_from_chol(L), scoring.cond_estimate(L, mask)


def bank_prescale_X(X: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Lengthscale-divide and pad the observation block (B, na, d) ->
    (B, na, dp); cached with the factors."""
    return scoring.prescale_rows(X, ls)


def bank_prescale_C(C: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Prescale the fresh candidate block (B, S, d) -> (B, S, dp).  S is not
    padded: the kernels mask their ragged last block themselves."""
    return scoring.prescale_rows(C, ls)


def bank_absorb(Xs, y, mask, L, Linv, P, n_pending, n_obs, ls, var, noise):
    """Hallucinate each study's in-flight trials ``P`` (B, pend_cap, d, raw)
    into copies of its system; returns the extended (Xs, y, mask, L,
    Linv)."""
    Ps = scoring.prescale_rows(P, ls)
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
    taken = torch.ones((), dtype=torch.bool, device=C.device)
    picks = torch.zeros((B, batch_size), dtype=torch.int64,
                        device=C.device)
    for c in range(batch_size):
        in_c = (assign == c) & ~picked
        sel = torch.where(in_c.any(-1, keepdim=True), in_c, ~picked)
        j = torch.argmax(torch.where(sel, top_vals, -torch.inf), dim=-1)
        picked[rows, j] = taken        # a device value: True would sync
        picks[:, c] = top_idx[rows, j]
    return picks


# Every bank entry point, by name, behind a wrapper that records each
# distinct dispatch signature (``sanitizers.EntryPoint``): the port's
# counterpart of the JAX package's ``BANK_JITS``, audited by
# ``sanitizers.no_retrace`` (one signature per shape bucket, ever, is the
# bucketing contract).  ``StudyBank`` calls its entry points through this
# registry, so an entry replaced here is what runs.  ``core.tpe`` adds
# ``fused_tpe_propose_bank``.  The reference's ``bank_dist`` / ``bank_exp``
# split exists only for XLA:CPU and has no counterpart.
BANK_ENTRY_POINTS = {fn.__name__: EntryPoint(fn) for fn in (
    bank_factors, bank_prescale_X, bank_prescale_C, bank_absorb, bank_pick,
    bank_cluster_pick, fit_hypers_bank)}


# --------------------------------------------------------------------------- #
# one study: the strategies' GP (no leading study axis)
# --------------------------------------------------------------------------- #
# The counterparts of the JAX package's single-study programs
# (``repro.core.gp``, lines 65-398).  Each runs as a Python loop of tensor
# ops on its inputs' device; host counts (``n_obs``, ``n_pending``) stay on
# the host, so no pick loop reads the device back: the picks leave it once,
# at the end.
def _matern(x1, x2, ls, var):
    """x1 (n, d), x2 (m, d), ls (d,) ARD lengthscales, var 0-d -> (n, m)."""
    return ref.matern52((x1 / ls)[None], (x2 / ls)[None], var.reshape(1))[0]


def _cold_params(d: int) -> dict:
    """The fit's default start, as the ledger's cold rows hold it."""
    return {"log_ls": np.full((d,), np.log(0.5), np.float32),
            "log_var": np.float32(0.0),
            "log_noise": np.float32(np.log(1e-2))}


def fit_hypers(X, y, mask, steps: int = 40, init=None):
    """(ls (d,), var, noise, raw log-params) of one study by Adam on -log
    ML: ``fit_hypers_bank`` at B = 1 on the standardized ``y`` (mean 0,
    std 1 leaves it as it is).  ``init`` warm-starts Adam from a previous
    fit's log-params (fresh moments); None starts cold."""
    dev = X.device
    p = _cold_params(X.shape[1]) if init is None else init
    lp = [to_device(p[k], dev, np.float32).reshape(sh)
          for k, sh in (("log_ls", (1, -1)), ("log_var", (1,)),
                        ("log_noise", (1,)))]
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    lls, lv, ln = fit_hypers_bank(X[None], y[None], mask[None], *lp, zero,
                                  zero + 1.0, steps=steps)
    params = {"log_ls": lls[0], "log_var": lv[0], "log_noise": ln[0]}
    return (torch.exp(lls[0]), torch.exp(lv[0]), torch.exp(ln[0]) + 1e-5,
            params)


def cholesky_masked1(X, mask, ls, var, noise) -> torch.Tensor:
    """One study's masked-kernel Cholesky factor (identity at padded
    slots; NaN where K is not positive definite)."""
    return cholesky_masked(X[None], mask[None], ls[None], var.reshape(1),
                           noise.reshape(1))[0]


def posterior(X, y, mask, L, Xs, ls, var, noise):
    """mu and sigma^2 at Xs (m, d) given the padded training set (n, d) and
    its Cholesky factor: the L-based path, plain triangular solves."""
    Ks = _matern(X, Xs, ls, var) * mask[:, None]                 # (n, m)
    alpha = torch.cholesky_solve((y * mask)[:, None], L)[:, 0]
    mu = Ks.T @ alpha
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    var_s = torch.clamp(var + noise - (V * V).sum(0), min=1e-10)
    return mu, var_s


def chol_append(L, X, mask, idx, x_new, ls, var, noise):
    """Rank-1 extension: write x_new into padded row ``idx`` (a host int or
    a 0-d tensor) and extend L.  Returns new (L, X, mask); the inputs are
    left as they are.  O(n^2) instead of a refit."""
    n = X.shape[0]
    X = X.clone()
    X[idx] = x_new
    k_vec = _matern(X, x_new[None, :], ls, var)[:, 0] * mask
    l_vec = torch.linalg.solve_triangular(L, k_vec[:, None],
                                          upper=False)[:, 0]
    l_vec = torch.where(torch.arange(n, device=X.device) < idx, l_vec, 0.0)
    l_nn = torch.sqrt(torch.maximum(
        var + noise + scoring.jitter(var) - (l_vec * l_vec).sum(),
        scoring.schur_floor(var, noise)))
    l_vec[idx] = l_nn
    L = L.clone()
    L[idx, :] = l_vec
    mask = mask.clone()
    mask[idx] = 1.0
    return L, X, mask


def kinv_from_chol(L: torch.Tensor) -> torch.Tensor:
    """K^-1 from its Cholesky factor (identity rows and columns at padded
    slots): the legacy operand the factor core replaced."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.cholesky_solve(eye, L)


def _slot(idx, device) -> torch.Tensor:
    return (idx.reshape(1).long() if isinstance(idx, torch.Tensor)
            else torch.full((1,), int(idx), dtype=torch.long, device=device))


def chol_factor_append(L, Linv, X, mask, idx, x_new, ls, var, noise):
    """``chol_append`` and the rank-1 extension of Linv together, through
    the hardened ``scoring.factor_append`` (float32 Schur solves with one
    refinement step).  Returns new (L, Linv, X, mask)."""
    X = X.clone()
    X[idx] = x_new
    k_vec = _matern(X, x_new[None, :], ls, var)[:, 0] * mask
    L2, Linv2, _, _ = scoring.factor_append(
        L[None].clone(), Linv[None].clone(), _slot(idx, L.device),
        k_vec[None], var.reshape(1), noise.reshape(1))
    mask = mask.clone()
    mask[idx] = 1.0
    return L2[0], Linv2[0], X, mask


def _append_core_uv(L, Kinv, idx, k_vec, var, noise):
    """Legacy float32 K^-1 Schur append (L row + block-inverse extension):
    the path whose conditioning lost picks on near-noiseless objectives,
    kept as the baseline the factor core is measured against.  Returns
    (L', Kinv', u, schur)."""
    n = L.shape[0]
    l_vec = torch.linalg.solve_triangular(L, k_vec[:, None],
                                          upper=False)[:, 0]
    u = torch.linalg.solve_triangular(L.T, l_vec[:, None], upper=True)[:, 0]
    c = var + noise + scoring.jitter(var)
    floor = scoring.schur_floor(var, noise)
    schur = torch.maximum(c - k_vec @ u, floor)
    Kinv = _schur_extend(Kinv, u, schur, idx)
    l_vec = torch.where(torch.arange(n, device=L.device) < idx, l_vec, 0.0)
    l_vec[idx] = torch.sqrt(torch.maximum(c - (l_vec * l_vec).sum(), floor))
    L = L.clone()
    L[idx, :] = l_vec
    return L, Kinv, u, schur


def _schur_extend(Kinv, u, schur, idx):
    """Write the block-inverse extension into row/col ``idx`` of Kinv."""
    Kinv = Kinv + torch.outer(u, u) / schur
    Kinv[idx, :] = -u / schur
    Kinv[:, idx] = -u / schur
    Kinv[idx, idx] = 1.0 / schur
    return Kinv


def _fused_pick(X, y, mask, L, C, ls, var, noise, n_obs: int, domain_size,
                batch_size: int) -> torch.Tensor:
    """GP-BUCB batch selection on the L-based path: one posterior pass,
    then per slot UCB -> argmax -> rank-1 Cholesky hallucination, extending
    the candidate solve ``V = L^-1 Ks`` by the one row forward substitution
    would produce (O(n S) a slot).  Returns the picks (batch_size,) on the
    device."""
    dev = C.device
    S = C.shape[0]
    Ks = _matern(X, C, ls, var) * mask[:, None]                  # (n, S)
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    sig2 = torch.clamp(var + noise - (V * V).sum(0), min=1e-10)
    alpha = torch.cholesky_solve((y * mask)[:, None], L)[:, 0]
    mu = Ks.T @ alpha
    y = y.clone()
    beta = scoring.adaptive_beta_dev(
        n_obs + torch.arange(batch_size, device=dev),
        scoring.scalar(domain_size, dev))
    avail = torch.ones(S, dtype=torch.bool, device=dev)
    taken = torch.zeros((), dtype=torch.bool, device=dev)
    picks = torch.zeros(batch_size, dtype=torch.int64, device=dev)
    for b in range(batch_size):
        acq = torch.where(avail, mu + torch.sqrt(beta[b]) * torch.sqrt(sig2),
                          -torch.inf)
        idx = torch.argmax(acq)
        picks[b] = idx
        avail[idx] = taken
        if b == batch_size - 1:
            break
        slot = n_obs + b
        L, X, mask = chol_append(L, X, mask, slot, C[idx], ls, var, noise)
        # the new cross-covariance row and the one new row of V' = L'^-1 Ks'
        # (rows < slot are unchanged by construction)
        k_row = _matern(C[idx][None, :], C, ls, var)[0]           # (S,)
        Ks[slot] = k_row
        l_row = L[slot]
        v_new = (k_row - l_row @ V) / l_row[slot]
        V[slot] = v_new
        sig2 = torch.clamp(sig2 - v_new * v_new, min=1e-10)
        # hallucinate at the posterior mean, then refresh mu from the
        # extended system
        y[slot] = mu[idx]
        alpha = torch.cholesky_solve((y * mask)[:, None], L)[:, 0]
        mu = Ks.T @ alpha
    return picks


def fused_propose(X, y, mask, L, C, ls, var, noise, n_obs: int, domain_size,
                  batch_size: int) -> torch.Tensor:
    """The whole GP-BUCB batch on the L-based path (no pending)."""
    return _fused_pick(X, y, mask, L, C, ls, var, noise, n_obs, domain_size,
                       batch_size)


def fused_propose_pending(X, y, mask, L, P, C, ls, var, noise, n_obs: int,
                          domain_size, batch_size: int) -> torch.Tensor:
    """``fused_propose`` with the in-flight rows P (n_pending, d) absorbed
    first, as ``GaussianProcess.hallucinate`` absorbs them: posterior mean
    at each from the current extended system, rank-1 Cholesky append,
    phantom y at the mean; then the pick loop with the observation count
    advanced by n_pending."""
    y = y.clone()
    for j in range(P.shape[0]):
        x_new = P[j]
        k_vec = _matern(X, x_new[None, :], ls, var)[:, 0] * mask
        alpha = torch.cholesky_solve((y * mask)[:, None], L)[:, 0]
        mu = k_vec @ alpha
        slot = n_obs + j
        L, X, mask = chol_append(L, X, mask, slot, x_new, ls, var, noise)
        y[slot] = mu
    return _fused_pick(X, y, mask, L, C, ls, var, noise, n_obs + P.shape[0],
                       domain_size, batch_size)


def fused_propose_pallas(X, y, mask, L, Linv, C, ls, var, noise,
                         n_obs: int, domain_size,
                         batch_size: int) -> torch.Tensor:
    """``fused_propose`` on the factor core (the name is the JAX package's,
    where this path runs its Pallas kernels): ``scoring.pick_downdate_loop``
    scores through ``ops.score_cov`` and downdates through
    ``ops.var_downdate``, the Hopper kernels on a CUDA tensor."""
    Xs, Cs = scoring.prescale(X, C, ls)
    return scoring.pick_downdate_loop(Cs, Xs, y, mask, L, Linv, var, noise,
                                      n_obs, domain_size, batch_size)


def fused_propose_pallas_pending(X, y, mask, L, Linv, P, C, ls, var, noise,
                                 n_obs: int, domain_size,
                                 batch_size: int) -> torch.Tensor:
    """``fused_propose_pallas`` with the in-flight rows P (n_pending, d)
    absorbed first by ``scoring.absorb_pending`` (hardened factor appends,
    posterior mean at each row, phantom y at the mean), then the downdate
    pick loop with the observation count advanced by n_pending."""
    Xs, Cs = scoring.prescale(X, C, ls)
    Xs, y, mask, L, Linv = scoring.absorb_pending_one(
        Xs, y, mask, L, Linv, P, ls, var, noise, n_obs)
    return scoring.pick_downdate_loop(Cs, Xs, y, mask, L, Linv, var, noise,
                                      n_obs + P.shape[0], domain_size,
                                      batch_size)


# --------------------------------------------------------------------------- #
# the GaussianProcess facade
# --------------------------------------------------------------------------- #
def _pad_to(n: int) -> int:
    p = 16
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class GPState:
    """One study's GP on its device: padded buffers (n_pad rows), the
    Cholesky factor, hyperparameters, and the host scalars."""
    X: torch.Tensor            # (n_pad, d)
    y: torch.Tensor            # (n_pad,) standardized
    mask: torch.Tensor         # (n_pad,)
    L: torch.Tensor            # (n_pad, n_pad)
    ls: torch.Tensor           # (d,)
    var: torch.Tensor          # 0-d
    noise: torch.Tensor        # 0-d, floor included
    n: int
    y_mean: float
    y_std: float
    Linv: Optional[torch.Tensor] = None   # L^-1, only with track_factor


def _grow_state(st: GPState) -> GPState:
    """Double the padded buffers; identity rows keep L and Linv consistent."""
    grow = st.X.shape[0]

    def eye_pad(M):
        out = torch.nn.functional.pad(M, (0, grow, 0, grow))
        out.diagonal()[grow:].fill_(1.0)
        return out

    zeros = torch.zeros_like
    return dataclasses.replace(
        st, X=torch.cat([st.X, zeros(st.X)]), y=torch.cat([st.y, zeros(st.y)]),
        mask=torch.cat([st.mask, zeros(st.mask)]), L=eye_pad(st.L),
        Linv=None if st.Linv is None else eye_pad(st.Linv))


class GaussianProcess:
    """Stateful fit/predict facade of one study's GP, on ``device``
    (``cuda`` unless ``"cpu"`` is asked for), where it keeps its buffers.

    ``fit`` is the full hyperparameter re-tune; ``observe`` appends new
    observations in O(n^2) and refits only when the observed prefix
    changed, the data shrank, or ``refit_every`` new points accumulated
    since the last fit.  Host arrays in, host arrays out (``predict``); the
    standardization is numpy's, as in the JAX package, so both agree
    bitwise on it."""

    def __init__(self, dim: int, fit_steps: int = 40, refit_every: int = 8,
                 track_factor: bool = False,
                 warm_fit_steps: Optional[int] = None,
                 device: DeviceLike = None):
        self.dim = dim
        self.device = resolve_device(device)
        self.fit_steps = fit_steps
        # refit boundaries warm-start Adam from the previous log-params and
        # run a short polish instead of the full schedule
        self.warm_fit_steps = (max(8, fit_steps // 4)
                               if warm_fit_steps is None else warm_fit_steps)
        self.refit_every = max(1, int(refit_every))
        # maintain Linv = L^-1 beside L (the factor core's operand)
        self.track_factor = track_factor
        self.state: Optional[GPState] = None
        self.n_fit = 0                 # observation count at the last fit
        self._fit_params: Optional[dict] = None   # its log-params
        self._obs_X: Optional[np.ndarray] = None
        self._obs_y: Optional[np.ndarray] = None

    def _t(self, a) -> torch.Tensor:
        return to_device(a, self.device, np.float32)

    def _padded(self, X, y, n):
        """(Xp, yp standardized, mask) host buffers and the frozen
        standardization over the first n rows."""
        n_pad = _pad_to(n)
        y_mean = float(y[:n].mean()) if n else 0.0
        y_std = float(y[:n].std()) + 1e-6 if n else 1.0
        Xp = np.zeros((n_pad, self.dim), np.float32)
        yp = np.zeros((n_pad,), np.float32)
        mp = np.zeros((n_pad,), np.float32)
        Xp[:n] = X[:n]
        yp[:n] = (y[:n] - y_mean) / y_std
        mp[:n] = 1.0
        return Xp, yp, mp, y_mean, y_std

    def _build(self, Xp, yp, mp, ls, var, noise, n, y_mean, y_std):
        Xt, mt = self._t(Xp), self._t(mp)
        L = cholesky_masked1(Xt, mt, ls, var, noise)
        Linv = (scoring.linv_from_chol(L) if self.track_factor else None)
        return GPState(Xt, self._t(yp), mt, L, ls, var, noise, n, y_mean,
                       y_std, Linv=Linv)

    def fit(self, X: np.ndarray, y: np.ndarray) -> GPState:
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n = X.shape[0]
        Xp, yp, mp, y_mean, y_std = self._padded(X, y, n)
        steps = self.fit_steps if self._fit_params is None \
            else self.warm_fit_steps
        ls, var, noise, params = fit_hypers(
            self._t(Xp), self._t(yp), self._t(mp), steps=steps,
            init=self._fit_params)
        self._fit_params = params
        self.state = self._build(Xp, yp, mp, ls, var, noise, n, y_mean,
                                 y_std)
        self.n_fit = n
        self._obs_X, self._obs_y = X, y
        return self.state

    def _extend(self, st: GPState, x_new, y_new) -> GPState:
        """Append one row (x_new, standardized y_new) in O(n^2)."""
        if st.n >= st.X.shape[0]:
            st = _grow_state(st)
        x_new = to_device(x_new, self.device, np.float32)
        if st.Linv is not None:
            L, Linv, X, mask = chol_factor_append(
                st.L, st.Linv, st.X, st.mask, st.n, x_new, st.ls, st.var,
                st.noise)
        else:
            L, X, mask = chol_append(st.L, st.X, st.mask, st.n, x_new, st.ls,
                                     st.var, st.noise)
            Linv = None
        y = st.y.clone()
        y[st.n] = y_new
        return dataclasses.replace(st, X=X, y=y, mask=mask, L=L,
                                   n=st.n + 1, Linv=Linv)

    def _append(self, st: GPState, x_new: np.ndarray, y_raw: float
                ) -> GPState:
        """Extend the state with one real observation in O(n^2)."""
        return self._extend(st, x_new,
                            (float(y_raw) - st.y_mean) / st.y_std)

    def observe(self, X: np.ndarray, y: np.ndarray) -> GPState:
        """Incremental fit on the full observation history (X, y)."""
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n = len(y)
        st = self.state
        stale = (
            st is None or n < st.n
            or (n - self.n_fit) >= self.refit_every
            or self._obs_X is None
            or not np.array_equal(self._obs_X[:st.n], X[:st.n])
            or not np.array_equal(self._obs_y[:st.n], y[:st.n]))
        if not stale and n > self.n_fit:
            # frozen-standardization sanity: a degenerate fit (y_std ~ 1e-6)
            # would blow new values up to ~1e6 standardized; re-tune now.
            # Checked over everything appended since the last fit, so a
            # resumed replay reaches the same refit decision.
            z = np.abs(y[self.n_fit:n] - st.y_mean) / st.y_std
            stale = bool(z.size) and float(z.max()) > 1e3
        if stale:
            return self.fit(X, y)
        for i in range(st.n, n):
            st = self._append(st, X[i], y[i])
        self.state = st
        self._obs_X, self._obs_y = X, y
        return st

    def restore(self, X: np.ndarray, y: np.ndarray, n_fit: int) -> GPState:
        """Full fit on the first ``n_fit`` rows, then the rest replayed as
        appends: the state of an uninterrupted incremental run."""
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n_fit = max(1, min(int(n_fit), len(y)))
        st = self.fit(X[:n_fit], y[:n_fit])
        for i in range(n_fit, len(y)):
            st = self._append(st, X[i], y[i])
        self.state = st
        self._obs_X, self._obs_y = X, y
        return st

    # -------------------------------------------------- exact checkpointing
    def export_state(self) -> Optional[dict]:
        """JSON-able snapshot of the fit schedule (the JAX package's v1
        format): the last fit's observation count and raw log-params.
        Everything else is a function of the history and this pair."""
        if self.state is None or self._fit_params is None:
            return None
        return {"n_fit": int(self.n_fit),
                "log_params": {
                    k: np.asarray(to_host(v), np.float32).tolist()
                    for k, v in self._fit_params.items()}}

    def restore_exact(self, X: np.ndarray, y: np.ndarray,
                      snap: dict) -> GPState:
        """Rebuild the live state from an ``export_state`` snapshot: the
        buffers and Cholesky factor at ``n_fit`` under the stored
        hyperparameters, then the remaining rows replayed as appends."""
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n_fit = max(1, min(int(snap["n_fit"]), len(y)))
        lp = {k: self._t(np.asarray(v, np.float32))
              for k, v in snap["log_params"].items()}
        self._fit_params = lp
        Xp, yp, mp, y_mean, y_std = self._padded(X, y, n_fit)
        st = self._build(Xp, yp, mp, torch.exp(lp["log_ls"]),
                         torch.exp(lp["log_var"]),
                         torch.exp(lp["log_noise"]) + 1e-5, n_fit, y_mean,
                         y_std)
        self.n_fit = n_fit
        for i in range(n_fit, len(y)):
            st = self._append(st, X[i], y[i])
        self.state = st
        self._obs_X, self._obs_y = X, y
        return st

    def ensure_capacity(self, st: GPState, extra: int) -> GPState:
        """A grown copy of ``st`` with room for ``extra`` more rows (not
        stored: the stored state grows only inside ``_append``, so growth
        is a function of the observation sequence)."""
        while st.n + extra > st.X.shape[0]:
            st = _grow_state(st)
        return st

    def predict(self, Xs: np.ndarray, state: Optional[GPState] = None):
        """(mu, sd) at Xs in the original y scale, as host arrays."""
        st = state or self.state
        mu, var_s = posterior(st.X, st.y, st.mask, st.L, self._t(Xs),
                              st.ls, st.var, st.noise)
        mu, var_s = to_host(mu, var_s)                     # one exit
        return mu * st.y_std + st.y_mean, np.sqrt(var_s) * st.y_std

    def hallucinate(self, st: GPState, x_new: np.ndarray) -> GPState:
        """GP-BUCB: extend with a phantom observation at the posterior
        mean (standardized), which stays on the device."""
        if st.n >= st.X.shape[0]:
            st = _grow_state(st)
        x = self._t(np.asarray(x_new, np.float32))
        mu_std, _ = posterior(st.X, st.y, st.mask, st.L, x[None], st.ls,
                              st.var, st.noise)
        return self._extend(st, x, mu_std[0])
