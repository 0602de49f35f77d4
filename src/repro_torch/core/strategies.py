"""Parallel batch-selection strategies (paper §2.3).

  * ``bayesian`` (default) / ``hallucination``: GP-BUCB.  Asks through
    ``AskTellOptimizer`` and ``StudyBank`` are served by the bank pipeline
    (``core.studybank``); ``FusedHallucinationStrategy.propose`` is the same
    batch for one study, on its own ``GaussianProcess``.
  * ``hallucination_ref``: GP-BUCB as a numpy-facing Python loop
    (Desautels et al. 2014): pick argmax UCB, hallucinate the pick at the
    posterior mean so the variance contracts, repeat.  The reference the
    fused path is held against; its asks go through the strategy itself.
  * ``clustering``: (Groves & Pyzer-Knapp 2018) the UCB surface on the
    candidates, its top ``top_frac`` share clustered by weighted k-means
    into ``batch_size`` groups, each group's best picked.  Served by the
    bank pipeline (``gp.bank_cluster_pick``); ``ClusteringStrategy.propose``
    is one study's (``acquisition.fused_cluster_propose``).
  * ``random``: a batch of valid random samples (the paper's third
    optimizer).
  * ``tpe``: the Hyperopt baseline, registered by ``core.tpe``.

``scorer`` chooses the GP math: ``"chol"`` (the default) is the L-based
path; ``"kinv_jnp"`` and ``"kinv_pallas"`` (the JAX package's names of one
factor core run as jnp or as Pallas kernels) are both the factor core,
which scores through ``ops.score_cov`` and downdates through
``ops.var_downdate``.  The tensor's device chooses kernel or plain version:
the Hopper kernels on ``cuda``, the plain versions in ``ref.py`` on
``cpu``.  ``use_pallas`` and ``pallas_interpret`` are not taken.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.sanitizers import to_device, to_host
from repro_torch.core import scoring
from repro_torch.core.acquisition import (adaptive_beta,
                                          fused_cluster_propose, ucb)
from repro_torch.core.gp import (GaussianProcess, fused_propose,
                                 fused_propose_pallas,
                                 fused_propose_pallas_pending,
                                 fused_propose_pending, posterior)
from repro_torch.core.kmeans import kmeans_assign
from repro_torch.device import DeviceLike
from repro_torch.kernels.gp_acquisition import ops as gp_ops

SCORERS = ("chol", "kinv_jnp", "kinv_pallas")


def n_top_candidates(S: int, batch_size: int, top_frac: float) -> int:
    """The size of the top set the clustering pick clusters."""
    return min(max(batch_size * 4, int(S * top_frac)), S)


def _window(st, rows: int) -> int:
    """The active window: a 64-multiple covering ``rows``, at least 16,
    at most the padded size.  The leading block of L is the Cholesky
    factor of the leading block of K, so the slice is exact."""
    return min(st.X.shape[0], max(16, -(-rows // 64) * 64))


class BaseStrategy:
    """A GP-backed strategy: encoded observations and candidates in, pick
    indices out.  ``propose`` also takes ``pending``, the encoded rows of
    trials in flight, which GP strategies hallucinate before picking.

    ``last_cond_proxy`` is the power-iteration condition estimate of K's
    active window at the last propose (``scoring.cond_estimate``), computed
    when read; above ``scoring.COND_PROXY_WARN`` a one-time warning fires.
    Unknown keyword arguments raise ``TypeError``."""

    needs_gp = True

    def __init__(self, dim: int, domain_size: float, fit_steps: int = 40,
                 refit_every: int = 8, scorer: Optional[str] = None,
                 device: DeviceLike = None):
        self._scorer_explicit = scorer is not None
        if scorer is None:
            scorer = "chol"
        elif scorer not in SCORERS:
            raise ValueError(f"unknown scorer {scorer!r}; "
                             f"choose from {SCORERS}")
        self.scorer = scorer
        self.gp = GaussianProcess(dim, fit_steps=fit_steps,
                                  refit_every=refit_every,
                                  track_factor=scorer != "chol",
                                  device=device)
        self.device = self.gp.device
        self.domain_size = domain_size
        self._cond_src = None
        self._cond_warned = False

    @property
    def factor_core(self) -> bool:
        """Whether the scorer is the factor core (kernels 1-2 on the card)."""
        return self.scorer != "chol"

    def _update_cond_proxy(self, st, na: Optional[int] = None) -> None:
        """Stage the conditioning diagnostic of the active window; it is
        computed only when ``last_cond_proxy`` is read."""
        self._cond_src = (st.L, st.mask, na)

    @property
    def last_cond_proxy(self) -> Optional[float]:
        """Condition estimate of the last propose's active kernel window
        (None before the first GP-backed propose)."""
        if self._cond_src is None:
            return None
        L, m, na = self._cond_src
        if na is not None:
            L, m = L[:na, :na], m[:na]
        val = float(scoring.cond_estimate(L[None], m[None])[0])
        if val > scoring.COND_PROXY_WARN and not self._cond_warned:
            self._cond_warned = True
            warnings.warn(
                f"GP kernel condition estimate {val:.2e} exceeds "
                f"{scoring.COND_PROXY_WARN:.0e}: float32 posterior scores "
                "may be unreliable (consider a larger noise floor)",
                RuntimeWarning, stacklevel=2)
        return val

    def _predict(self, st, C: np.ndarray):
        if self.factor_core:
            return gp_ops.gp_mean_std(st, C)
        return self.gp.predict(C, st)

    def _absorb_pending(self, st, pending):
        """Host loop: hallucinate the in-flight rows one by one."""
        st = self.gp.ensure_capacity(st, len(pending))
        for p in np.asarray(pending, dtype=np.float32):
            st = self.gp.hallucinate(st, p)
        return st

    def propose(self, X: np.ndarray, y: np.ndarray, candidates: np.ndarray,
                batch_size: int, seed: int = 0,
                pending: Optional[np.ndarray] = None) -> List[int]:
        raise NotImplementedError


class HallucinationStrategy(BaseStrategy):
    """``hallucination_ref``: refit, then per slot score every candidate on
    the host-facing path (``gp.predict``, or ``ops.gp_mean_std`` on the
    factor core: one ``score_cov`` a slot), UCB argmax, hallucinate."""

    def propose(self, X, y, candidates, batch_size, seed=0, pending=None):
        st = self.gp.fit(X, y)
        n_pend = 0 if pending is None else len(pending)
        if n_pend:
            st = self._absorb_pending(st, pending)
        n_evals = len(y) + n_pend
        picked: List[int] = []
        avail = np.ones(len(candidates), dtype=bool)
        for b in range(batch_size):
            mu, sd = self._predict(st, candidates)
            beta = adaptive_beta(n_evals, self.domain_size, batch_index=b)
            acq = ucb(mu, sd, beta)
            acq[~avail] = -np.inf
            idx = int(np.argmax(acq))
            picked.append(idx)
            avail[idx] = False
            if b + 1 < batch_size:
                st = self.gp.hallucinate(st, candidates[idx])
        return picked


class FusedHallucinationStrategy(BaseStrategy):
    """GP-BUCB with the whole batch loop on the device: observations are
    absorbed incrementally (O(n^2) appends, a refit every ``refit_every``
    new points), and the picks leave the device once.  Picks the
    candidates ``HallucinationStrategy`` picks on fixed seeds."""

    def propose(self, X, y, candidates, batch_size, seed=0, pending=None):
        n_pend = 0 if pending is None else len(pending)
        st = self.gp.observe(X, y)
        st = self.gp.ensure_capacity(st, batch_size + n_pend)
        return self.pick_from_state(st, candidates, batch_size,
                                    pending=pending)

    def pick_from_state(self, st, candidates, batch_size, pending=None):
        """Window the state and run the fused program against it.
        ``pending`` rides into the program: the L-based path appends it by
        Cholesky rows, the factor core by ``scoring.absorb_pending``."""
        n_pend = 0 if pending is None else len(pending)
        na = _window(st, st.n + n_pend + batch_size)
        self._update_cond_proxy(st, na)
        dev = self.device
        C = to_device(candidates, dev, np.float32)
        win = (st.X[:na], st.y[:na], st.mask[:na], st.L[:na, :na])
        tail = (C, st.ls, st.var, st.noise, st.n, self.domain_size,
                batch_size)
        if n_pend:
            P = to_device(pending, dev, np.float32)
        if self.factor_core:
            Linv = st.Linv[:na, :na]
            picks = (fused_propose_pallas_pending(*win, Linv, P, *tail)
                     if n_pend else fused_propose_pallas(*win, Linv, *tail))
        else:
            picks = (fused_propose_pending(*win, P, *tail) if n_pend
                     else fused_propose(*win, *tail))
        return [int(i) for i in to_host(picks)]   # one exit


class ClusteringStrategy(BaseStrategy):
    """Groves & Pyzer-Knapp 2018 batch selection for one study.

    ``propose`` runs ``acquisition.fused_cluster_propose`` on the device:
    pending absorb, posterior and UCB through the factor core, top set,
    weighted k-means and one pick a cluster; only the picks leave it.
    ``propose_host`` is the numpy pipeline kept as its parity oracle.
    The factor core is the only scorer: the default is ``kinv_jnp``, and an
    explicit ``chol`` raises."""

    def __init__(self, *args, top_frac: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        if self.scorer == "chol":
            if self._scorer_explicit:
                raise ValueError(
                    "ClusteringStrategy scores through the shared factor "
                    "core; scorer must be 'kinv_jnp' or 'kinv_pallas'")
            self.scorer = "kinv_jnp"
            self.gp.track_factor = True
        self.top_frac = top_frac

    def _n_top(self, S: int, batch_size: int) -> int:
        return n_top_candidates(S, batch_size, self.top_frac)

    def propose(self, X, y, candidates, batch_size, seed=0, pending=None):
        S = len(candidates)
        batch_size = min(batch_size, S)
        st = self.gp.observe(X, y)
        n_pend = 0 if pending is None else len(pending)
        st = self.gp.ensure_capacity(st, n_pend)
        na = _window(st, st.n + n_pend)
        self._update_cond_proxy(st, na)
        dev = self.device
        d = st.X.shape[1]
        P = to_device(np.asarray(pending if n_pend else np.zeros(
            (0, d)), np.float32).reshape(n_pend, d), dev)
        C = to_device(candidates, dev, np.float32)
        picks = fused_cluster_propose(
            st.X[:na], st.y[:na], st.mask[:na], st.L[:na, :na],
            st.Linv[:na, :na], P, C, st.ls, st.var, st.noise, st.n,
            self.domain_size, seed, batch_size=batch_size,
            n_top=self._n_top(S, batch_size))
        return [int(i) for i in to_host(picks)]   # one exit

    def propose_host(self, X, y, candidates, batch_size, seed=0,
                     pending=None):
        """Numpy pipeline (the parity oracle of the device program): the
        standardized acquisition surface on the L-based path, the
        descending-sorted top slice, host-facing k-means, and each
        cluster's argmax excluding earlier picks."""
        batch_size = min(batch_size, len(candidates))
        st = self.gp.observe(X, y)
        n_pend = 0 if pending is None else len(pending)
        if n_pend:
            st = self._absorb_pending(st, pending)
        mu, var_s = posterior(
            st.X, st.y, st.mask, st.L,
            to_device(candidates, self.device, np.float32),
            st.ls, st.var, st.noise)
        mu, var_s = to_host(mu, var_s)
        sd = np.sqrt(var_s)
        beta = adaptive_beta(len(y) + n_pend, self.domain_size)
        acq = ucb(mu, sd, beta)
        if batch_size == 1:
            return [int(np.argmax(acq))]
        n_top = self._n_top(len(candidates), batch_size)
        top = np.argsort(-acq, kind="stable")[:n_top]
        w = acq[top] - acq[top].min() + 1e-6
        assign = kmeans_assign(candidates[top], w, batch_size, seed=seed,
                               device=self.device)
        picked: List[int] = []
        for c in range(batch_size):
            members = top[assign == c]
            members = members[~np.isin(members, picked)]
            if len(members) == 0:   # empty cluster: back-fill from the
                members = top[~np.isin(top, picked)]   # unpicked remainder
            if len(members) == 0:
                break
            picked.append(int(members[np.argmax(acq[members])]))
        return picked


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
    "bayesian": FusedHallucinationStrategy,     # mango's default name
    "hallucination": FusedHallucinationStrategy,
    "hallucination_ref": HallucinationStrategy,  # the numpy reference loop
    "clustering": ClusteringStrategy,
    "random": RandomStrategy,
}


def check_strategy(name: str) -> None:
    """Raise ``ValueError`` for an unknown strategy name."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"choose from {sorted(STRATEGIES)}")
