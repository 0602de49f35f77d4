"""Parallel batch-selection strategies (paper §2.3), as far as they are ported.

  * ``bayesian`` (default) / ``hallucination``: GP-BUCB.  The ask itself is
    served by the StudyBank pipeline (``core.studybank``), so the strategy
    object only marks that a GP is needed.
  * ``random``: a batch of valid random samples (the paper's third
    optimizer).
  * ``clustering``: (Groves & Pyzer-Knapp 2018) the UCB surface on the
    candidates, its top ``top_frac`` share clustered by weighted k-means
    into ``batch_size`` groups, each group's best picked.  Served by the
    StudyBank pipeline (``gp.bank_cluster_pick``), sharing the GP stages.
  * ``tpe``: the Hyperopt baseline, registered by ``core.tpe``; its asks
    are served by the StudyBank pipeline too.

``hallucination_ref``, the JAX package's numpy-facing reference loop, is
not ported: asking for it raises.
"""
from __future__ import annotations

from typing import List

import numpy as np

_NOT_PORTED = ("hallucination_ref",)


def n_top_candidates(S: int, batch_size: int, top_frac: float) -> int:
    """The size of the top set the clustering pick clusters."""
    return min(max(batch_size * 4, int(S * top_frac)), S)


class BaseStrategy:
    """GP-backed strategy: ``needs_gp`` routes the ask through the bank.
    The knobs the bank's GP schedule reads live on the optimizer; unknown
    keyword arguments raise ``TypeError`` here."""

    needs_gp = True

    def __init__(self, dim: int, domain_size: float, fit_steps: int = 40,
                 refit_every: int = 8):
        pass


class ClusteringStrategy(BaseStrategy):
    """GP-backed; ``top_frac`` (the share of candidates clustered) is read
    by the bank from ``strategy_kwargs``."""

    def __init__(self, dim: int, domain_size: float, fit_steps: int = 40,
                 refit_every: int = 8, top_frac: float = 0.2):
        self.top_frac = top_frac


class RandomStrategy(BaseStrategy):
    needs_gp = False

    def __init__(self, dim: int = 0, domain_size: float = 1.0, **kwargs):
        pass

    def propose(self, X, y, candidates, batch_size, seed=0,
                pending=None) -> List[int]:
        rng = np.random.default_rng(seed)
        # clamp: a small mc_samples override can leave fewer candidates
        # than batch slots — return what exists instead of raising
        return list(rng.choice(len(candidates),
                               size=min(batch_size, len(candidates)),
                               replace=False))


STRATEGIES = {
    "bayesian": BaseStrategy,     # mango's default name
    "hallucination": BaseStrategy,
    "clustering": ClusteringStrategy,
    "random": RandomStrategy,
}


def check_strategy(name: str) -> None:
    """Raise ``ValueError`` for a strategy name the port cannot serve."""
    if name in _NOT_PORTED:
        raise ValueError(f"optimizer {name!r} is not ported yet; choose "
                         f"from {sorted(STRATEGIES)}")
    if name not in STRATEGIES:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"choose from {sorted(STRATEGIES)}")
