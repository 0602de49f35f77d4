"""Conditioning-hardened GP posterior scoring, batched over studies.

The PyTorch counterpart of ``repro.core.scoring`` for the bank pipeline.
Every tensor carries a leading study axis B; a loop over batch slots takes
the place of ``fori_loop``.  The numerics are the reference's:

  * the resident operand is the triangular inverse factor ``Linv = L^-1`` and
    the posterior variance is the monotone sum of squares
    ``var + noise - ||k Linv^T||^2`` (``ops.score_cov``);
  * rank-1 appends extend (L, Linv) by one new row each and never rewrite
    earlier rows;
  * the Schur solves run in float32 with one step of iterative refinement.
    That is the reference's branch whenever JAX's x64 mode is off, which
    is how the JAX package runs;
  * the Schur complement is the Cholesky pivot form ``c - sum l^2`` and the
    floors are relative to the signal scale (``jitter``, ``schur_floor``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gp_acquisition import ops
from repro_torch.kernels.gp_acquisition.ref import matern52

# condition estimate above which float32 posterior scoring is presumed
# unreliable (cond * eps_f32 ~ 1)
COND_PROXY_WARN = 1e7

JITTER = 1e-6


def jitter(var: torch.Tensor) -> torch.Tensor:
    """Diagonal jitter, relative to the signal variance: 1e-6 absolute or
    1e-6 * var, whichever is larger.  Shared by the Cholesky and append
    paths so a floor never binds on one of them only."""
    return JITTER * torch.clamp(var, min=1.0)


def schur_floor(var: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Floor of the Schur complement / Cholesky pivot, relative to the
    diagonal scale (keeps 1/schur finite when a duplicate is absorbed)."""
    return torch.clamp(1e-8 * (var + noise), min=1e-10)


def adaptive_beta_dev(t: torch.Tensor,
                      domain_size: torch.Tensor) -> torch.Tensor:
    """UCB exploration weight (delta = 0.1) for observation counts t."""
    t = torch.clamp(t.to(torch.float32), min=1.0)
    beta = 2.0 * torch.log(torch.clamp(domain_size, min=2.0) * t * t
                           * (math.pi ** 2) / 0.6)
    return torch.clamp(beta, 1.0, 100.0)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v for every study: (B, n, n) x (B, n) -> (B, n)."""
    return (M @ v[..., None])[..., 0]


def _vm(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v M (= M^T v without forming the transpose) for every study."""
    return (v[:, None, :] @ M)[:, 0]


def linv_from_chol(L: torch.Tensor) -> torch.Tensor:
    """L^-1 (identity rows/cols at padded slots, like L itself)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L),
                                         upper=False).contiguous()


def cond_estimate(L: torch.Tensor, mask: torch.Tensor,
                  iters: int = 16) -> torch.Tensor:
    """Power-iteration estimate of cond2(K) from its masked Cholesky factor,
    for every study: ``iters`` steps each for lambda_max(K) (K v = L (L^T v))
    and lambda_max(K^-1) (two triangular solves), Rayleigh quotients
    multiplied.  The masked block of L is identity, so masking the start
    vector and every product keeps the iteration in the active block."""
    m = (mask > 0).to(L.dtype)
    v0 = m / torch.clamp(torch.sqrt(m.sum(-1, keepdim=True)), min=1.0)

    def rayleigh(mv):
        v = v0
        for _ in range(iters):
            w = mv(v)
            nrm = torch.sqrt((w * w).sum(-1, keepdim=True))
            v = w / torch.clamp(nrm, min=1e-30)
        return (v * mv(v)).sum(-1)

    def k_mv(v):
        return _mv(L, _vm(v * m, L)) * m

    def kinv_mv(v):
        t = torch.linalg.solve_triangular(L, (v * m)[..., None], upper=False)
        t = torch.linalg.solve_triangular(L.transpose(-1, -2), t, upper=True)
        return t[..., 0] * m

    return torch.clamp(rayleigh(k_mv) * rayleigh(kinv_mv), min=1.0)


def factor_append(L: torch.Tensor, Linv: torch.Tensor, idx: torch.Tensor,
                  k_vec: torch.Tensor, var: torch.Tensor,
                  noise: torch.Tensor):
    """Extend (L, Linv) of every study by the point whose masked Matern
    column is ``k_vec`` (B, n), into row ``idx`` (B,) of each study.

    Returns ``(L, Linv, u, schur)``: ``u = K^-1 k`` is the Schur vector
    that drives the variance downdate and ``schur`` the Schur complement.
    The new Linv row is ``[-u / l_nn, 1 / l_nn]``.  Unlike the JAX version
    this writes the new rows into ``L`` and ``Linv`` in place: callers pass
    tensors they own.  The solves are Linv matvecs in float32, each with
    one step of iterative refinement (residual against L, corrected through
    Linv)."""
    n = L.shape[-1]
    rows = torch.arange(L.shape[0], device=L.device)
    l_vec = _mv(Linv, k_vec)                          # forward solve L l = k
    l_vec = l_vec + _mv(Linv, k_vec - _mv(L, l_vec))
    u = _vm(l_vec, Linv)                              # back solve L^T u = l
    u = u + _vm(l_vec - _vm(u, L), Linv)
    c = var + noise + jitter(var)
    active = torch.arange(n, device=L.device)[None, :] < idx[:, None]
    l_vec = torch.where(active, l_vec, 0.0)
    u = torch.where(active, u, 0.0)
    schur = torch.maximum(c - (l_vec * l_vec).sum(-1),
                          schur_floor(var, noise))
    l_nn = torch.sqrt(schur)
    l_vec[rows, idx] = l_nn
    L[rows, idx] = l_vec
    li_row = -u / l_nn[:, None]
    li_row[rows, idx] = 1.0 / l_nn
    Linv[rows, idx] = li_row
    return L, Linv, u, schur


def kinv_matvec(Linv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K^-1 v through the factor, as two triangular matvecs."""
    return _vm(_mv(Linv, v), Linv)


def absorb_pending(Xs, y, mask, L, Linv, Ps, n_pending, n_obs, var, noise):
    """Hallucinate each study's in-flight rows ``Ps`` (B, pend_cap, dp),
    prescaled like ``Xs``, into its system (GP-BUCB): posterior mean at the
    pending point from the current extended system, hardened rank-1 append,
    phantom y at the mean.  Study b absorbs its first ``n_pending[b]`` rows
    into slots ``n_obs[b] + j``.  Updates the given tensors in place."""
    for j in range(Ps.shape[1]):
        sub = torch.nonzero(n_pending > j)[:, 0]
        if not len(sub):
            break
        x_new = Ps[sub, j]
        k_vec = (matern52(Xs[sub], x_new[:, None, :], var[sub])[..., 0]
                 * mask[sub])
        mu = (k_vec * kinv_matvec(Linv[sub], y[sub] * mask[sub])).sum(-1)
        slot = (n_obs[sub] + j).long()
        L_s, Linv_s, _, _ = factor_append(L[sub], Linv[sub], slot, k_vec,
                                          var[sub], noise[sub])
        L[sub], Linv[sub] = L_s, Linv_s
        Xs[sub, slot] = x_new
        y[sub, slot] = mu
        mask[sub, slot] = 1.0
    return Xs, y, mask, L, Linv


def pick_downdate_from_scores(Cs, mu, sig2, Kc, L, Linv, var, noise, n_obs,
                              domain_size, batch_size: int) -> torch.Tensor:
    """The GP-BUCB slot loop over scored candidates, for every study.

    Hallucinating at the posterior mean leaves the mean unchanged, so per
    slot only the variance moves: after the pick is appended to the factor,
    ``ops.var_downdate`` contracts every candidate's variance by
    ``(k(c, x*) - k_c^T u)^2 / schur`` from the cached block ``Kc`` and
    writes the picked point's column into it.  ``L``, ``Linv`` and ``Kc``
    are updated in place.  Returns the picks, (B, batch_size) int64."""
    B, S = mu.shape
    rows = torch.arange(B, device=mu.device)
    avail = torch.ones((B, S), dtype=torch.bool, device=mu.device)
    picks = torch.zeros((B, batch_size), dtype=torch.int64, device=mu.device)
    for b in range(batch_size):
        beta = adaptive_beta_dev(n_obs + b, domain_size)
        acq = mu + torch.sqrt(beta)[:, None] * torch.sqrt(sig2)
        acq = torch.where(avail, acq, -torch.inf)
        idx = torch.argmax(acq, dim=1)
        picks[:, b] = idx
        avail[rows, idx] = False
        if b == batch_size - 1:
            break
        slot = (n_obs + b).to(torch.int32)
        # the cached row IS the masked Matern column of the picked point
        # (columns of not-yet-active slots are zero by construction)
        k_vec = Kc[rows, idx]
        L, Linv, u, schur = factor_append(L, Linv, slot.long(), k_vec, var,
                                          noise)
        sig2, _ = ops.var_downdate(Cs, Cs[rows, idx].contiguous(), Kc,
                                   u.contiguous(), schur, sig2, var,
                                   slot=slot)
    return picks
