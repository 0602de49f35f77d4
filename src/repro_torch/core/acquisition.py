"""UCB acquisition with Mango's adaptive exploration/exploitation schedule.

beta follows the GP-UCB schedule (Srinivas et al.), scaled by search-space
size, completed evaluations, and the position within the parallel batch
(GP-BUCB increments t per hallucinated pick):

    beta_t = 2 * log(domain_size * t^2 * pi^2 / (6 * delta))

These are the host versions; the bank pipeline evaluates the same schedule
on the device (``scoring.adaptive_beta_dev``).
"""
from __future__ import annotations

import math

import numpy as np


def adaptive_beta(n_evals: int, domain_size: float, batch_index: int = 0,
                  delta: float = 0.1) -> float:
    t = max(n_evals + batch_index, 1)
    beta = 2.0 * math.log(
        max(domain_size, 2.0) * t * t * math.pi ** 2 / (6.0 * delta))
    return min(max(beta, 1.0), 100.0)


def ucb(mu: np.ndarray, sigma: np.ndarray, beta: float) -> np.ndarray:
    return mu + math.sqrt(beta) * sigma
