"""UCB acquisition with Mango's adaptive exploration/exploitation schedule.

beta follows the GP-UCB schedule (Srinivas et al.), scaled by search-space
size, completed evaluations, and the position within the parallel batch
(GP-BUCB increments t per hallucinated pick):

    beta_t = 2 * log(domain_size * t^2 * pi^2 / (6 * delta))

These are the host versions; the bank pipeline evaluates the same schedule
on the device (``scoring.adaptive_beta_dev``).  ``fused_cluster_propose`` is
one study's clustering proposal (Groves & Pyzer-Knapp 2018) on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def adaptive_beta(n_evals: int, domain_size: float, batch_index: int = 0,
                  delta: float = 0.1) -> float:
    t = max(n_evals + batch_index, 1)
    beta = 2.0 * math.log(
        max(domain_size, 2.0) * t * t * math.pi ** 2 / (6.0 * delta))
    return min(max(beta, 1.0), 100.0)


def ucb(mu: np.ndarray, sigma: np.ndarray, beta: float) -> np.ndarray:
    return mu + math.sqrt(beta) * sigma


def fused_cluster_propose(X, y, mask, L, Linv, P, C, ls, var, noise,
                          n_obs: int, domain_size, seed: int,
                          batch_size: int, n_top: int) -> torch.Tensor:
    """One study's clustering proposal on its device (the counterpart of
    the JAX package's jitted program of the same name):

    1. absorb the in-flight rows P (n_pending, d) through the factor core's
       hardened appends (``scoring.absorb_pending``);
    2. score every candidate through ``scoring.posterior_scores``
       (``ops.score_cov``: the Hopper kernel on a CUDA tensor), UCB at the
       observation count ``n_obs + n_pending``;
    3. keep the ``n_top`` best, cluster their raw rows of C by weighted
       k-means seeded from ``PRNGKey(seed)``, and take each cluster's best
       not yet picked (``gp.cluster_pick``).

    Only the (batch_size,) picks leave the device, once, at the caller."""
    from repro_torch.analysis.sanitizers import to_device
    from repro_torch.core import gp, kmeans, scoring
    dev = C.device
    Xs, Cs = scoring.prescale(X, C, ls)
    Xs, y, mask, L, Linv = scoring.absorb_pending_one(
        Xs, y, mask, L, Linv, P, ls, var, noise, n_obs)
    mu, sig2, _, _ = scoring.posterior_scores(Cs, Xs, y, mask, Linv, var,
                                              noise)
    beta = scoring.adaptive_beta_dev(scoring.scalar(n_obs + P.shape[0], dev),
                                     scoring.scalar(domain_size, dev))
    acq = mu + torch.sqrt(beta) * torch.sqrt(sig2)
    u = to_device(kmeans.kmeans_uniforms([seed], batch_size), dev)
    return gp.cluster_pick(acq[None], C[None], u, n_top, batch_size)[0]
