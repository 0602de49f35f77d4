"""Weighted k-means (k-means++ seeding and Lloyd iterations) for the
clustering batch strategy (Groves & Pyzer-Knapp 2018), batched over studies.

The counterpart of ``repro.core.kmeans._kmeans``, vmapped over the bank,
and of its host entry ``kmeans_assign``.
Its random draws depend on the PRNG key alone, not on the points:
``jax.random.choice(key, n, p=p)`` is ``r = cumsum(p)[-1] * (1 - u)`` with
``u`` a float32 uniform of the key, then ``searchsorted(cumsum(p), r)``
(side left).  So ``kmeans_uniforms`` makes each study's ``k`` uniforms on
the host (``core.prng``, bit for bit ``jax.random``), one for the first
center and one for each seeding step after it, each from a fresh ``split``
of the key, and ``kmeans`` runs on the device from those.

As in the reference: argmin takes the first index on ties, a cluster that
loses all its points keeps its center, and every sum is in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.sanitizers import to_device, to_host
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device


def kmeans_uniforms(seeds, k: int) -> np.ndarray:
    """(R, k) float32: for each study's uint32 seed, the uniforms its
    k-means draws from ``PRNGKey(seed)``: ``key, sub = split(key)`` before
    each of the ``k`` center choices, ``uniform(sub)`` for the choice."""
    key = prng.PRNGKey(np.asarray(seeds).astype(np.uint32))
    out = np.empty((key.shape[0], k), np.float32)
    for i in range(k):
        pair = prng.split(key)
        key = pair[:, 0]
        out[:, i] = prng.uniform(pair[:, 1])
    return out


def _choice(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)`` per study, given the key's
    uniform ``u`` (R,): p (R, n) -> (R,) int64."""
    cum = torch.cumsum(p, dim=-1)
    r = cum[:, -1:] * (1.0 - u[:, None])
    idx = torch.searchsorted(cum, r.contiguous(), side="left")[:, 0]
    return torch.clamp(idx, max=p.shape[1] - 1)


def _sqdist(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum((X - c)^2, -1): X (R, n, d), c (R, m, d) -> (R, n, m)."""
    return ((X[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)


def kmeans(X: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           iters: int = 10) -> torch.Tensor:
    """Cluster assignment (R, n) int64 of points X (R, n, d) with weights
    w (R, n) into k = u.shape[1] clusters, seeded from the uniforms u
    (R, k) of ``kmeans_uniforms``."""
    R, n, d = X.shape
    k = u.shape[1]
    rows = torch.arange(R, device=X.device)
    p = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    first = X[rows, _choice(p, u[:, 0])]
    centers = X.new_zeros((R, k, d))
    centers[:, 0] = first
    d2min = _sqdist(X, first[:, None])[..., 0]
    for i in range(1, k):
        probs = d2min * w
        tot = probs.sum(-1, keepdim=True)
        probs = torch.where(tot > 0, probs / tot,
                            torch.ones_like(probs) / n)
        c = X[rows, _choice(probs, u[:, i])]
        centers[:, i] = c
        d2min = torch.minimum(d2min, _sqdist(X, c[:, None])[..., 0])
    for _ in range(iters):
        assign = torch.argmin(_sqdist(X, centers), dim=-1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype) \
            * w[..., None]                                  # (R, n, k)
        sums = onehot.transpose(1, 2) @ X                   # (R, k, d)
        counts = onehot.sum(1)[..., None]                   # (R, k, 1)
        centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1e-9), centers)
    return torch.argmin(_sqdist(X, centers), dim=-1)


def kmeans_assign(X: np.ndarray, weights: np.ndarray, k: int,
                  seed: int = 0, iters: int = 10,
                  device: DeviceLike = None) -> np.ndarray:
    """Host-facing k-means of one point set (the clustering strategy's
    ``propose_host``): assignment (n,) of X (n, d) with weights (n,) into
    k clusters, seeded from ``PRNGKey(seed)`` as ``repro.core.kmeans``
    seeds it, run on ``device``."""
    if len(X) <= k:
        return np.arange(len(X))
    dev = resolve_device(device)
    t = lambda a: to_device(np.asarray(a, np.float32)[None],  # noqa: E731
                            dev)
    return to_host(kmeans(t(X), t(weights),
                          t(kmeans_uniforms([seed], k)[0]), iters)[0])
