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

import numpy as np
import torch

from repro_torch.analysis.sanitizers import to_device, to_host
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
    into slots ``n_obs[b] + j``.  Updates the given tensors in place.

    ``n_pending`` holds host counts (a numpy array or a sequence; a tensor
    is read back once, through ``to_host``).  Each slot's rows are chosen
    on the host and all of them go up in one upload before the loop, so
    the loop reads nothing back from the device."""
    counts = to_host(n_pending)
    subs = []
    for j in range(Ps.shape[1]):
        rows = np.nonzero(counts > j)[0]
        if not len(rows):
            break
        subs.append(rows)
    if not subs:
        return Xs, y, mask, L, Linv
    flat = to_device(np.concatenate(subs), Ps.device)
    one = torch.ones((), dtype=mask.dtype, device=mask.device)
    start = 0
    for j, rows in enumerate(subs):
        sub = flat[start:start + len(rows)]
        start += len(rows)
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
        mask[sub, slot] = one     # a device value: a Python 1.0 would sync
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
    taken = torch.zeros((), dtype=torch.bool, device=mu.device)
    picks = torch.zeros((B, batch_size), dtype=torch.int64, device=mu.device)
    for b in range(batch_size):
        beta = adaptive_beta_dev(n_obs + b, domain_size)
        acq = mu + torch.sqrt(beta)[:, None] * torch.sqrt(sig2)
        acq = torch.where(avail, acq, -torch.inf)
        idx = torch.argmax(acq, dim=1)
        picks[:, b] = idx
        avail[rows, idx] = taken       # a device value: False would sync
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


# --------------------------------------------------------------------------- #
# single-study entry points (the strategies' device programs)
# --------------------------------------------------------------------------- #
def cond_proxy_from_chol(L: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Diagonal lower bound of cond2(K) from its Cholesky factor on the
    active block: ``(max diag L / min diag L)^2``.  L (..., n, n), mask
    (..., n) -> (...)."""
    d = torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))
    act = mask > 0
    dmax = torch.where(act, d, 0.0).amax(-1)
    dmin = torch.where(act, d, torch.inf).amin(-1)
    return (dmax / torch.clamp(dmin, min=1e-30)) ** 2


def scalar(v, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``, filled there (no copy from the
    host)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def prescale_rows(A: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Rows A (B, n, d) divided by each study's ARD lengthscales ls (B, d),
    zero-padded to dp = 8k columns (padded columns add nothing to a
    distance)."""
    B, n, d = A.shape
    out = torch.zeros((B, n, max(8, -(-d // 8) * 8)), dtype=torch.float32,
                      device=A.device)
    out[..., :d] = A / ls[:, None, :]
    return out


def prescale(X: torch.Tensor, C: torch.Tensor, ls: torch.Tensor):
    """One study's observations X (n, d) and candidates C (S, d),
    prescaled (``prescale_rows``).  The reference also pads S to a Pallas
    block multiple and masks the padded rows unavailable; ``ops.score_cov``
    masks its ragged last block itself, so S stays as it is, as in the
    bank."""
    return (prescale_rows(X[None], ls[None])[0],
            prescale_rows(C[None], ls[None])[0])


def absorb_pending_one(Xs, y, mask, L, Linv, P, ls, var, noise,
                       n_obs: int):
    """One study's in-flight rows P (n_pending, d, raw) absorbed into
    copies of its system by ``absorb_pending``, at slots ``n_obs + j``;
    returns the extended (Xs, y, mask, L, Linv)."""
    if not P.shape[0]:
        return Xs, y, mask, L, Linv
    sys_ = [t.clone()[None] for t in (Xs, y, mask, L, Linv)]
    absorb_pending(*sys_, prescale_rows(P[None], ls[None]), [P.shape[0]],
                   torch.full((1,), n_obs, dtype=torch.float32,
                              device=P.device),
                   var.reshape(1), noise.reshape(1))
    return tuple(t[0] for t in sys_)


def posterior_scores(Cs, Xs, y, mask, Linv, var, noise):
    """(mu, sig2, Kc, alpha) of one study: prescaled candidates Cs (S, dp)
    against its prescaled observations Xs (na, dp), mask and standardized y
    (na,), through the factor Linv (na, na); var and noise 0-d.

    The one scoring entry point of the single-study strategies (the
    fused GP-BUCB factor core and the clustering pipeline): ``ops.score_cov``
    at B = 1, the Hopper kernel for a CUDA tensor and its plain version for
    a CPU one."""
    alpha = kinv_matvec(Linv[None], (y * mask)[None])
    mu, sig2, Kc = ops.score_cov(
        Cs[None].contiguous(), Xs[None].contiguous(),
        mask[None].contiguous(), Linv[None].contiguous(),
        alpha.contiguous(), var.reshape(1), noise.reshape(1))
    return mu[0], sig2[0], Kc[0], alpha[0]


def var_downdate(Cs, x_star, Kc, u, schur, sig2, var, slot):
    """One study's rank-1 variance downdate (``ops.var_downdate`` at B = 1):
    returns (sig2', knew) and writes knew into column ``slot`` of Kc."""
    sig2_new, knew = ops.var_downdate(
        Cs[None], x_star[None].contiguous(), Kc[None], u[None].contiguous(),
        schur.reshape(1), sig2[None].contiguous(), var.reshape(1),
        to_device(np.array([slot], np.int32), Cs.device)
        if isinstance(slot, int) else slot.reshape(1).to(torch.int32))
    return sig2_new[0], knew[0]


def pick_downdate_loop(Cs, Xs, y, mask, L, Linv, var, noise, n_obs: int,
                       domain_size, batch_size: int) -> torch.Tensor:
    """One study's GP-BUCB slot loop on the factor core: one
    ``posterior_scores`` pass scores every candidate and caches the masked
    cross-covariance block, then each slot appends its pick to (L, Linv)
    and downdates the variance by ``ops.var_downdate``: O(n S) a slot.
    ``n_obs`` is the host count of rows already in the system; the loop
    extends copies of L and Linv.  Returns the picks (batch_size,) on the
    device; nothing is read back inside the loop."""
    import repro_torch.core.scoring as scoring   # the dispatch test's spy
    mu, sig2, Kc, _ = scoring.posterior_scores(Cs, Xs, y, mask, Linv, var,
                                               noise)
    dev = Cs.device
    return pick_downdate_from_scores(
        Cs[None], mu[None], sig2[None], Kc[None], L[None].clone(),
        Linv[None].clone(), var.reshape(1), noise.reshape(1),
        scalar(n_obs, dev).reshape(1), scalar(domain_size, dev).reshape(1),
        batch_size)[0]
