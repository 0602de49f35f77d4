"""Tree-structured Parzen Estimator baseline (the Hyperopt algorithm), the
PyTorch counterpart of ``repro.core.tpe``.

  * split observations into good/bad by the gamma-quantile of y,
  * model each encoded dimension with 1D Parzen windows (Gaussian KDE with
    a per-dimension bandwidth: Scott base scaled by each dim's split
    spread, so one-hot categoricals get a sharper kernel),
  * score candidates by l(x)/g(x) and take the top of the Monte-Carlo
    candidate set,
  * parallel batches take the top-b scores (Hyperopt's naive parallelism).

One ask is one batched pass over B studies (``fused_tpe_propose_bank``;
one study's, ``fused_tpe_propose``, is the same pass at B = 1):
the split runs as masked ranks over the padded observation buffer, the
O(S n d) product-Parzen scorer is ``kernels.tpe_kde.ops.tpe_scores`` (the
CUDA kernel on the card, its plain version on the CPU), and the batch is
selected by a stable descending sort, so that among equal scores the lower
index comes first, as ``lax.top_k`` orders them in the JAX package.

Pending trials: ``pending_penalty=True`` (opt-in) hallucinates the
in-flight configurations into the bad-split KDE ("pessimistic liar"), so
replacement picks steer away from work already in flight.  The numpy seed
pipeline is kept as ``TPEStrategy.propose_host``, the parity oracle;
``TPEStrategy.propose`` is the single-study ask on the device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.analysis.sanitizers import EntryPoint, to_device, to_host
from repro_torch.core import gp as gp_lib
from repro_torch.core.strategies import STRATEGIES, BaseStrategy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.tpe_kde import ops
from repro_torch.kernels.tpe_kde.ref import scott_bandwidth


def _masked_var(w: torch.Tensor, Xd: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    """Per-dim variance of the n rows selected by w (B, na) over
    Xd (B, na, d), as elementwise products and sums (never a matmul, so no
    TF32 path can touch it)."""
    den = torch.clamp(n, min=1.0)[:, None]
    m = (w[..., None] * Xd).sum(1) / den
    return (w[..., None] * (Xd - m[:, None, :]) ** 2).sum(1) / den


def fused_tpe_propose_bank(X, y, C, meta, *, batch_size: int,
                           d_true: int) -> torch.Tensor:
    """Split, l/g scoring and top-b for B studies in one pass.

    X (B, na, dp) holds each study's observed rows, then its pending rows
    (the penalty's in-flight set, empty unless enabled), then zero padding;
    y (B, na) the observed objective values; C (B, S, dp) the padded
    candidates.  ``meta`` (B, 4) packs [n_obs, n_pend, n_cand, gamma] per
    study.  Returns the (B, batch_size) pick indices on X's device."""
    B, na, dp = X.shape
    S = C.shape[1]
    dev = X.device
    n_obs = meta[:, 0].to(torch.int32)
    n_pend = meta[:, 1].to(torch.int32)
    n_cand = meta[:, 2].to(torch.int32)
    gamma = meta[:, 3]
    row = torch.arange(na, dtype=torch.int32, device=dev)[None, :]
    is_obs = row < n_obs[:, None]
    pend = ((row >= n_obs[:, None])
            & (row < (n_obs + n_pend)[:, None])).to(torch.float32)
    # rank observed rows best-first (stable, like the host argsort)
    neg = torch.where(is_obs, -y, torch.full_like(y, float("inf")))
    order = torch.argsort(neg, dim=1, stable=True).to(torch.int32)
    rank = torch.empty_like(order).scatter_(1, order.long(),
                                            row.expand(B, na).contiguous())
    # split count in float32 on every path so ceil ties cannot flip
    n_good = torch.clamp(torch.ceil(gamma * n_obs.to(torch.float32)),
                         min=1.0).to(torch.int32)[:, None]
    good = (rank < n_good) & is_obs
    wg = good.to(torch.float32)
    wb_obs = ((rank >= n_good) & is_obs).to(torch.float32)
    wb_obs = torch.where(n_obs[:, None] > n_good, wb_obs, wg)  # empty bad
    wb = torch.clamp(wb_obs + pend, max=1.0)                  # pessimistic
    ng = wg.sum(1)
    nb = wb.sum(1)
    # per-DIM bandwidths: Scott base scaled by each split's clipped spread
    Xd = X[..., :d_true]
    vg = _masked_var(wg, Xd, ng)
    vb = _masked_var(wb, Xd, nb)
    bw_g = scott_bandwidth(ng, d_true)[:, None] \
        * torch.clamp(2.0 * torch.sqrt(vg), 0.1, 1.0)          # (B, d)
    bw_b = scott_bandwidth(nb, d_true)[:, None] \
        * torch.clamp(2.0 * torch.sqrt(vb), 0.1, 1.0)
    # each row carries its own split's 1/(2 bw_j^2) (disjoint splits)
    a = torch.zeros((B, na, dp), dtype=torch.float32, device=dev)
    a[..., :d_true] = torch.where(good[..., None],
                                  (0.5 / (bw_g * bw_g))[:, None, :],
                                  (0.5 / (bw_b * bw_b))[:, None, :])
    zero = torch.zeros_like(ng)
    scal = torch.stack([1.0 / ng, 1.0 / nb, zero, zero], dim=1)
    n_live = (n_obs + n_pend).contiguous()
    score = ops.tpe_scores(C, X.contiguous(), a, wg, wb.contiguous(),
                           scal.contiguous(), n_live, d_true=d_true)
    cand = torch.arange(S, device=dev)[None, :]
    score = torch.where(cand < n_cand[:, None], score,
                        torch.full_like(score, float("-inf")))
    # stable descending sort: ties keep the lower index first (lax.top_k)
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices
    return idx[:, :batch_size]


def fused_tpe_propose(X, y, C, meta, *, batch_size: int,
                      d_true: int) -> torch.Tensor:
    """One study's split, l/g scoring and top-b: ``fused_tpe_propose_bank``
    at B = 1.  X (na, dp), y (na,), C (Sp, dp), meta (4,) -> (batch_size,)
    pick indices on X's device."""
    return fused_tpe_propose_bank(
        X[None], y[None], C[None], meta[None], batch_size=batch_size,
        d_true=d_true)[0]


class TPEStrategy(BaseStrategy):
    """TPE's knobs, validated; the bank's ``_dispatch_tpe`` serves a bank's
    asks past the random phase, ``propose`` one study's on ``device``, and
    ``propose_host`` is the numpy oracle of both."""

    needs_gp = True  # needs observations (not an actual GP)

    def __init__(self, dim: int, domain_size: float, gamma: float = 0.25,
                 pending_penalty: bool = False, fit_steps: int = 40,
                 refit_every: int = 8, device: DeviceLike = None):
        # fit_steps/refit_every belong to the strategy-constructor
        # contract; TPE has no GP to apply them to.  Anything else is a
        # typo -> TypeError.
        if dim < 1:
            raise ValueError(f"TPE needs dim >= 1, got {dim}")
        # gamma is the GOOD quantile; > 0.5 would make the "good" model the
        # majority and breaks the disjoint splits one exp per row relies on
        if not 0.0 < gamma <= 0.5:
            raise ValueError(f"gamma must be in (0, 0.5], got {gamma}")
        if not domain_size > 0:
            raise ValueError(f"domain_size must be > 0, got {domain_size}")
        self.dim = int(dim)
        self.domain_size = float(domain_size)
        self.gamma = float(gamma)
        self.pending_penalty = bool(pending_penalty)
        self._device = device      # resolved where ``propose`` runs

    @property
    def device(self):
        return resolve_device(self._device)

    # ------------------------------------------------------------ host oracle
    def _split_count(self, n: int) -> int:
        """Good-split size, computed in float32 like the device program."""
        return max(1, int(np.ceil(np.float32(self.gamma) * np.float32(n))))

    @staticmethod
    def _scott_bw(n_pts: int, d: int) -> np.float32:
        """Scott-rule base bandwidth, computed in float32 like the device."""
        return max(np.float32(max(n_pts, 1)) ** np.float32(-1.0 / (d + 4)),
                   np.float32(1e-2)) * np.float32(0.5) + np.float32(1e-3)

    @staticmethod
    def _dim_scale(pts: np.ndarray) -> np.ndarray:
        """Per-dim bandwidth scale clip(2*std_j, 0.1, 1.0) in f32 — the
        host twin of the device's masked-moment computation."""
        p = np.asarray(pts, np.float32)
        n = np.float32(max(len(p), 1))
        mean = p.sum(axis=0, dtype=np.float32) / n
        var = ((p - mean) ** 2).sum(axis=0, dtype=np.float32) / n
        return np.clip(np.float32(2.0) * np.sqrt(var),
                       np.float32(0.1), np.float32(1.0))

    @staticmethod
    def _kde_sum(pts: np.ndarray, x: np.ndarray, bw) -> np.ndarray:
        """(m, d) per-dim SUM of Gaussian Parzen kernels of x under pts."""
        inv2bw2 = np.float32(0.5) / np.float32(bw * bw)
        d2 = (x[:, None, :] - pts[None, :, :]) ** 2     # (m, n, d)
        return np.exp(-d2 * inv2bw2).sum(axis=1)

    @classmethod
    def _log_kde(cls, pts: np.ndarray, x: np.ndarray) -> np.ndarray:
        """1D-product Parzen log-density of x (m, d) under pts (n, d)."""
        n = max(len(pts), 1)
        dens = cls._kde_sum(pts, x, cls._scott_bw(n, pts.shape[1])) / n
        return np.log(dens + 1e-12).sum(axis=1)

    def propose_host(self, X, y, candidates, batch_size, seed=0,
                     pending=None) -> List[int]:
        """The seed numpy pipeline, kept as the parity oracle for the fused
        device program (same split, per-split bandwidths, tie-breaking).

        Pending rows (when the penalty is on) join the bad mixture at the
        bad split's bandwidth.  In the degenerate empty-bad case — only
        reachable with a single observation, the optimizer never asks with
        fewer than two — the good rows stand in for the bad split at their
        own bandwidth (exactly the device program's per-row-scale
        semantics)."""
        y = np.asarray(y, dtype=float)
        n = len(y)
        d = np.asarray(X).shape[1]
        n_good = self._split_count(n)
        order = np.argsort(-y, kind="stable")  # maximization
        Xa = np.asarray(X)
        good = Xa[order[:n_good]]
        bad = Xa[order[n_good:]]
        pend = (np.asarray(pending, dtype=Xa.dtype)
                if (self.pending_penalty and pending is not None
                    and len(pending)) else Xa[:0])
        ng = len(good)
        nb = (len(bad) if len(bad) else ng) + len(pend)
        bad_eff = bad if len(bad) else good
        b_pts = (np.concatenate([bad_eff, pend]) if len(pend) else bad_eff)
        bw_g = self._scott_bw(ng, d) * self._dim_scale(good)      # (d,)
        bw_b = self._scott_bw(nb, d) * self._dim_scale(b_pts)
        candidates = np.asarray(candidates)
        batch_size = min(batch_size, len(candidates))
        lg = np.log(self._kde_sum(good, candidates, bw_g) / ng
                    + 1e-12).sum(axis=1)
        bad_sum = (self._kde_sum(bad, candidates, bw_b) if len(bad)
                   else self._kde_sum(good, candidates, bw_g))
        if len(pend):
            bad_sum = bad_sum + self._kde_sum(pend, candidates, bw_b)
        lb = np.log(bad_sum / nb + 1e-12).sum(axis=1)
        top = np.argsort(-(lg - lb), kind="stable")[:batch_size]
        return [int(i) for i in top]

    # --------------------------------------------------------- device program
    def propose(self, X, y, candidates, batch_size, seed=0,
                pending=None) -> List[int]:
        """One pass on the device (``fused_tpe_propose``; the ``tpe_scores``
        kernel on the card): rows padded to a multiple of 64, candidates to
        one of 256, as the JAX package pads them; one read-back."""
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        C = np.ascontiguousarray(candidates, dtype=np.float32)
        n, d = X.shape
        S = len(C)
        batch_size = min(batch_size, S)
        n_pend = (len(pending)
                  if self.pending_penalty and pending is not None else 0)
        dp = ops.pad_dims(d)
        na = ops.pad_rows(n + n_pend, 64)
        Sp = ops.pad_rows(S, 256)
        Xb = np.zeros((na, dp), np.float32)
        Xb[:n, :d] = X
        yb = np.zeros(na, np.float32)
        yb[:n] = y
        if n_pend:
            Xb[n:n + n_pend, :d] = np.asarray(pending, dtype=np.float32)
        Cb = np.zeros((Sp, dp), np.float32)
        Cb[:S, :d] = C
        meta = np.array([n, n_pend, S, self.gamma], np.float32)
        dev = self.device
        picks = fused_tpe_propose(
            to_device(Xb, dev), to_device(yb, dev), to_device(Cb, dev),
            to_device(meta, dev), batch_size=batch_size, d_true=d)
        return [int(i) for i in to_host(picks)]   # one exit


STRATEGIES["tpe"] = TPEStrategy
# the bank's TPE program joins the GP family's in the audited registry
gp_lib.BANK_ENTRY_POINTS["fused_tpe_propose_bank"] = EntryPoint(
    fused_tpe_propose_bank)
