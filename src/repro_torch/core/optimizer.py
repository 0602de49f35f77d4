"""Ask/tell optimizer core: the one engine behind every tuner and scheduler.

The PyTorch counterpart of ``repro.core.optimizer``.  ``AskTellOptimizer``
owns the parameter space, the strategy, the RNG and a trial ledger with
stable ids behind four calls:

    trials = opt.ask(n)          # propose n new configurations
    opt.tell(trial.id, value)    # observe a completed trial
    opt.tell_failed(trial.id)    # a crashed / dropped / non-finite trial
    sd = opt.state_dict()        # full serializable snapshot (JSON-able)

The array-shaped state lives in a ``StudyLedger`` and an optimizer is a view
into one of its rows (a private bank of one unless a ``StudyBank`` passes
its shared ledger).  A GP, clustering or TPE ask past the random phase is
served by the bank's batched device pipeline on ``device`` (``cuda`` unless
``"cpu"`` is asked for); a ``hallucination_ref`` ask by its strategy's own
``propose`` on the same device.  ``strategy_kwargs`` (TPE's ``gamma`` and
``pending_penalty``, clustering's ``top_frac``, the GP strategies'
``scorer``) are forwarded to the strategy, whose constructor raises
``TypeError`` on an unknown key at the first ask.  Trials that never come
back are simply never told; ``tell_failed`` (or a non-finite ``tell``)
records the loss without reaching the GP.
``state_dict``/``load_state_dict`` carry the ledger, the RNG stream and the
GP fit schedule (the bank's, or the strategy GP's for ``hallucination_ref``,
replayed by ``GaussianProcess.restore_exact``), so a killed run resumes to
the exact proposals of an uninterrupted one.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.spaces import ParamSpace
from repro_torch.core.strategies import STRATEGIES, check_strategy
from repro_torch.core.studybank import (S_FAILED, S_OBSERVED, S_PENDING,
                                        StudyLedger, _y_standardization,
                                        rng_from_state)
from repro_torch.device import DeviceLike, resolve_device

PENDING = "pending"
OBSERVED = "observed"
FAILED = "failed"

# strategies whose asks are served by the bucketed StudyBank pipeline; the
# reference strategy (hallucination_ref) and random keep their own paths
_BANKABLE = {"bayesian", "hallucination", "tpe", "clustering"}

_STATUS_CODE = {PENDING: S_PENDING, OBSERVED: S_OBSERVED, FAILED: S_FAILED}
_STATUS_NAME = {v: k for k, v in _STATUS_CODE.items()}


class Trial:
    """One proposed configuration, tracked from ask to tell.

    Attached to a ``StudyLedger`` (every trial an optimizer hands out is),
    ``status``/``value``/``obs_seq`` read through to the ledger arrays.
    Detached construction keeps a plain record."""

    __slots__ = ("id", "params", "_led", "_b",
                 "_status", "_value", "_obs_seq")

    def __init__(self, id: int, params: Dict[str, Any],
                 status: str = PENDING, value: Optional[float] = None,
                 obs_seq: Optional[int] = None, *,
                 _ledger: Optional[StudyLedger] = None, _study: int = 0):
        self.id = id
        self.params = params
        self._led = _ledger
        self._b = _study
        self._status = status
        self._value = value
        self._obs_seq = obs_seq

    @property
    def status(self) -> str:
        if self._led is None:
            return self._status
        return _STATUS_NAME.get(int(self._led.status[self._b, self.id]),
                                PENDING)

    @status.setter
    def status(self, v: str) -> None:
        self._status = v
        if self._led is not None:
            code = _STATUS_CODE[v]
            # entering/leaving the observed set changes the GP system:
            # invalidate the bank's obs_stamp-keyed device cache.  Pending
            # churn (ask / tell_failed) deliberately does not bump.
            if (code == S_OBSERVED or
                    int(self._led.status[self._b, self.id]) == S_OBSERVED):
                self._led.obs_stamp += 1
            self._led.status[self._b, self.id] = code

    @property
    def value(self) -> Optional[float]:
        if self._led is None:
            return self._value
        if int(self._led.status[self._b, self.id]) != S_OBSERVED:
            return None
        return float(self._led.y[self._b, self.id])

    @value.setter
    def value(self, v: Optional[float]) -> None:
        self._value = v
        if self._led is not None and v is not None:
            self._led.y[self._b, self.id] = float(v)
            self._led.obs_stamp += 1

    @property
    def obs_seq(self) -> Optional[int]:
        if self._led is None:
            return self._obs_seq
        s = int(self._led.obs_seq[self._b, self.id])
        return None if s < 0 else s

    @obs_seq.setter
    def obs_seq(self, v: Optional[int]) -> None:
        self._obs_seq = v
        if self._led is not None and v is not None:
            self._led.obs_seq[self._b, self.id] = int(v)
            self._led.obs_stamp += 1

    def __repr__(self) -> str:
        return (f"Trial(id={self.id}, params={self.params!r}, "
                f"status={self.status!r}, value={self.value!r}, "
                f"obs_seq={self.obs_seq!r})")


def _to_jsonable(cfg: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in cfg.items():
        if isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, dict):
            # conditional (Choice) params nest {"_choice": ..., child: ...}
            out[k] = _to_jsonable(v)
        else:
            out[k] = v
    return out


class AskTellOptimizer:
    """Serializable ask/tell engine over the batch-selection strategies."""

    def __init__(self, param_space, *, optimizer: str = "bayesian",
                 seed: int = 0, sign: float = 1.0,
                 domain_size: Optional[float] = None,
                 mc_samples: Optional[int] = None, fit_steps: int = 40,
                 refit_every: int = 8,
                 strategy_kwargs: Optional[Dict[str, Any]] = None,
                 ledger: Optional[StudyLedger] = None,
                 study_index: int = 0, device: DeviceLike = None):
        self.space = (param_space if isinstance(param_space, ParamSpace)
                      else ParamSpace(param_space))
        check_strategy(optimizer)
        self.device = resolve_device(device)
        self.optimizer = optimizer
        self.mc_samples = mc_samples
        self.fit_steps = fit_steps
        self.refit_every = refit_every
        # strategy-specific knobs forwarded verbatim to the constructor
        # (unknown keys raise TypeError there)
        self.strategy_kwargs = dict(strategy_kwargs or {})
        self.domain_size = domain_size or self.space.domain_size
        self.sign = sign                   # +1 maximize, -1 minimize
        self._rng = np.random.default_rng(seed)
        self._led = (ledger if ledger is not None
                     else StudyLedger(1, self.space.dim))
        self._b = int(study_index)
        if not 0 <= self._b < self._led.n_studies:
            raise ValueError(f"study_index {study_index} out of range for "
                             f"a {self._led.n_studies}-study ledger")
        if self._led.dim != self.space.dim:
            raise ValueError("ledger dim does not match the param space")
        self._trials: Dict[int, Trial] = {}   # insertion order == ask order
        self._best_trace: List[float] = []    # raw best-so-far snapshots
        self._strat = None
        self._gp_snapshot = None   # pending restore from load_state_dict
        # the bank engine serving this view's asks: the owning StudyBank
        # (set by its constructor) or a lazily-built bank of one
        self._bank = None

    # ---- ledger-backed counters (the view's scalars ARE the array row) ----
    @property
    def _next_id(self) -> int:
        return int(self._led.n_trials[self._b])

    @_next_id.setter
    def _next_id(self, v: int) -> None:
        self._led.ensure_capacity(v)
        self._led.n_trials[self._b] = v

    @property
    def _ask_count(self) -> int:
        return int(self._led.ask_count[self._b])

    @_ask_count.setter
    def _ask_count(self, v: int) -> None:
        self._led.ask_count[self._b] = v

    @property
    def _obs_count(self) -> int:
        return int(self._led.obs_count[self._b])

    @_obs_count.setter
    def _obs_count(self, v: int) -> None:
        self._led.obs_count[self._b] = v

    @property
    def _n_failed(self) -> int:
        return int(self._led.n_failed[self._b])

    @_n_failed.setter
    def _n_failed(self, v: int) -> None:
        self._led.n_failed[self._b] = v

    # ------------------------------------------------------------- ledger
    def trials(self) -> List[Trial]:
        return list(self._trials.values())

    def pending_trials(self) -> List[Trial]:
        return [t for t in self._trials.values() if t.status == PENDING]

    def observed_trials(self) -> List[Trial]:
        """Observed trials in completion (tell) order, so the GP history is
        append-only."""
        obs = [t for t in self._trials.values() if t.status == OBSERVED]
        obs.sort(key=lambda t: t.obs_seq)
        return obs

    @property
    def num_trials(self) -> int:
        return len(self._trials)

    @property
    def n_observed(self) -> int:
        return len(self.observed_trials())

    @property
    def n_failed(self) -> int:
        return self._n_failed

    # ----------------------------------------------------------- strategy
    def _ensure_strategy(self):
        if self._strat is None:
            self._strat = STRATEGIES[self.optimizer](
                self.space.dim, self.domain_size, fit_steps=self.fit_steps,
                refit_every=self.refit_every, device=self.device,
                **self.strategy_kwargs)
            if self.optimizer not in _BANKABLE:
                # the reference strategy replays its GP from the snapshot;
                # bank-served paths restored theirs into the ledger when
                # the state dict was loaded
                gp = getattr(self._strat, "gp", None)
                if gp is not None and self._gp_snapshot is not None:
                    obs = self.observed_trials()
                    if obs:
                        gp.restore_exact(
                            self.space.encode([t.params for t in obs]),
                            self._signed_y(obs), self._gp_snapshot)
                self._gp_snapshot = None
        return self._strat

    def _engine(self):
        """The StudyBank serving this view's asks: the owning bank, else a
        lazily-built bank of one over the private ledger."""
        if self._bank is None:
            from repro_torch.core.studybank import StudyBank
            self._bank = StudyBank._wrap_view(self)
        return self._bank

    def _signed_y(self, obs: List[Trial]) -> np.ndarray:
        return np.asarray([self.sign * t.value for t in obs],
                          dtype=np.float32)

    # ---------------------------------------------------------------- ask
    def ask(self, n: int = 1) -> List[Trial]:
        """Propose ``n`` new trials; they enter the ledger as pending."""
        if n < 1:
            raise ValueError("ask(n) requires n >= 1")
        strat = self._ensure_strategy()
        obs = self.observed_trials()
        seed = self._ask_count
        if not strat.needs_gp:
            n_mc = self.mc_samples or self.space.mc_samples(n)
            cands = self.space.sample(n_mc, self._rng)
            idx = strat.propose(None, [], self.space.encode(cands), n,
                                seed=seed)
            chosen = [cands[i] for i in idx]
        elif len(obs) < 2:
            # not enough observations to model: explore at random (the
            # drivers' initial_random phase lands here too)
            chosen = self.space.sample(n, self._rng)
        elif self.optimizer in _BANKABLE:
            # bank-of-one: the bucketed StudyBank pipeline serves the ask,
            # with candidates from this view's own RNG via the columnar
            # sampler (the exact byte stream ``sample`` would consume)
            n_mc = self.mc_samples or self.space.mc_samples(n)
            cols = self.space.sample_columns(n_mc, self._rng)
            cfgs, enc = self._engine().ask_view(self, n, cols, n_mc)
            self._ask_count += 1
            return self._register_asked(list(cfgs), enc)
        else:
            n_mc = self.mc_samples or self.space.mc_samples(n)
            cands = self.space.sample(n_mc, self._rng)
            C = self.space.encode(cands)
            X = self.space.encode([t.params for t in obs])
            y = self._signed_y(obs)
            pend = self.pending_trials()
            P = (self.space.encode([t.params for t in pend])
                 if pend else None)
            idx = strat.propose(X, y, C, n, seed=seed, pending=P)
            chosen = [cands[i] for i in idx]
        self._ask_count += 1
        return self._register_asked(chosen)

    def _register_asked(self, chosen: List[Dict[str, Any]],
                        enc: Optional[np.ndarray] = None) -> List[Trial]:
        """Enter proposed configs into the ledger as pending trials."""
        if enc is None:
            enc = self.space.encode(list(chosen))
        led, b = self._led, self._b
        out = []
        for p, row in zip(chosen, enc):
            tid = self._next_id
            self._next_id = tid + 1          # grows ledger capacity too
            led.X[b, tid, :] = row
            led.status[b, tid] = S_PENDING
            led.obs_seq[b, tid] = -1
            t = Trial(tid, dict(p), _ledger=led, _study=b)
            self._trials[tid] = t
            out.append(t)
        return out

    # --------------------------------------------------------------- tell
    def _get_pending(self, trial_id: int) -> Trial:
        t = self._trials.get(trial_id)
        if t is None:
            raise KeyError(f"unknown trial id {trial_id!r} "
                           "(tell before ask?)")
        if t.status != PENDING:
            raise ValueError(f"trial {trial_id} already {t.status}")
        return t

    def tell(self, trial_id: int, value: float) -> Trial:
        """Observe a completed trial.  Non-finite values count as failures
        (they must never reach the surrogate)."""
        t = self._get_pending(trial_id)
        v = float(value)
        if not np.isfinite(v):
            t.status = FAILED
            self._n_failed += 1
            return t
        t.status = OBSERVED
        t.value = v
        t.obs_seq = self._obs_count
        self._obs_count += 1
        # drivers may rebind t.params to the exact config the objective ran
        # (the batch tuner does): re-encode so the ledger row matches
        self._led.X[self._b, t.id, :] = self.space.encode([t.params])[0]
        return t

    def tell_failed(self, trial_id: int) -> Trial:
        """Record a crashed/dropped trial; it is never observed."""
        t = self._get_pending(trial_id)
        t.status = FAILED
        self._n_failed += 1
        return t

    # ------------------------------------------------- idempotent tell (WAL)
    def tell_once(self, trial_id: int, value: float):
        """Idempotent ``tell``: returns ``(trial, applied)``.  A trial that
        is already observed/failed is left untouched; an unknown id still
        raises ``KeyError``."""
        t = self._trials.get(trial_id)
        if t is None:
            raise KeyError(f"unknown trial id {trial_id!r} "
                           "(tell before ask?)")
        if t.status != PENDING:
            return t, False
        return self.tell(trial_id, value), True

    def tell_failed_once(self, trial_id: int):
        """Idempotent ``tell_failed``; same contract as ``tell_once``."""
        t = self._trials.get(trial_id)
        if t is None:
            raise KeyError(f"unknown trial id {trial_id!r} "
                           "(tell before ask?)")
        if t.status != PENDING:
            return t, False
        return self.tell_failed(trial_id), True

    def observe_params(self, params: Dict[str, Any], value: float) -> Trial:
        """Observe a configuration that never went through ``ask``; it
        enters the ledger directly as observed/failed.  Everything that can
        fail runs before any state mutates."""
        params = dict(params)
        v = float(value)
        enc = self.space.encode([params])[0]
        led, b = self._led, self._b
        tid = self._next_id
        self._next_id = tid + 1
        t = Trial(tid, params, _ledger=led, _study=b)
        self._trials[tid] = t
        led.X[b, tid, :] = enc
        led.status[b, tid] = S_PENDING
        if np.isfinite(v):
            t.status = OBSERVED
            t.value = v
            t.obs_seq = self._obs_count
            self._obs_count += 1
        else:
            t.status = FAILED
            self._n_failed += 1
        return t

    # ------------------------------------------------------------ results
    def snapshot_trace(self) -> None:
        """Append the current raw best to the best-so-far trace."""
        obs = self.observed_trials()
        if obs:
            self._best_trace.append(
                self.sign * max(self.sign * t.value for t in obs))

    def results(self, iterations: Optional[int] = None, wall: float = 0.0):
        from repro_torch.core.tuner import TunerResults
        obs = self.observed_trials()
        if obs:
            best = max(obs, key=lambda t: self.sign * t.value)
            best_y, best_p = best.value, best.params
        else:
            best_y, best_p = float("nan"), {}
        return TunerResults(
            best_objective=best_y,
            best_params=best_p,
            params_tried=[t.params for t in obs],
            objective_values=[t.value for t in obs],
            best_trace=list(self._best_trace),
            iterations=(self._ask_count if iterations is None
                        else iterations),
            n_failed=self._n_failed,
            wall_time_s=wall,
        )

    # --------------------------------------------------------- state dict
    def _gp_export(self) -> Optional[Dict[str, Any]]:
        """Fit-schedule snapshot for the state dict's ``"gp"`` key, in the
        v1 format: the live strategy GP's when it has one (the reference
        strategy's propose path), else the ledger row's bank fit schedule,
        else whatever snapshot a load handed us that has not been consumed
        yet."""
        gp = getattr(self._strat, "gp", None) if self._strat else None
        snap = gp.export_state() if gp is not None else None
        if snap is not None:
            return snap
        led, b = self._led, self._b
        if int(led.have_fit[b]):
            return {
                "n_fit": int(led.n_fit[b]),
                "log_params": {
                    "log_ls": np.asarray(led.log_ls[b],
                                         np.float32).tolist(),
                    "log_var": np.float32(led.log_var[b]).tolist(),
                    "log_noise": np.float32(led.log_noise[b]).tolist(),
                }}
        return self._gp_snapshot

    def state_dict(self) -> Dict[str, Any]:
        """Full JSON-able snapshot: ledger (pending trials included), RNG
        stream, counters, and the GP fit schedule."""
        return {
            "version": 1,
            "next_id": self._next_id,
            "ask_count": self._ask_count,
            "n_failed": self._n_failed,
            "sign": self.sign,
            "best_trace": list(self._best_trace),
            "trials": [{"id": t.id, "params": _to_jsonable(t.params),
                        "status": t.status, "value": t.value,
                        "obs_seq": t.obs_seq}
                       for t in self._trials.values()],
            "rng_state": self._rng.bit_generator.state,
            "gp": self._gp_export(),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        led, b = self._led, self._b
        led.reset_study(b)
        self._next_id = sd["next_id"]
        self._ask_count = sd["ask_count"]
        self._n_failed = sd["n_failed"]
        self.sign = sd.get("sign", 1.0)
        self._best_trace = list(sd.get("best_trace", []))
        self._trials = {}
        recs = sd["trials"]
        if recs:
            enc = self.space.encode([rec["params"] for rec in recs])
        for i, rec in enumerate(recs):
            tid = rec["id"]
            t = Trial(tid, rec["params"], _ledger=led, _study=b)
            led.X[b, tid, :] = enc[i]
            led.status[b, tid] = _STATUS_CODE[rec["status"]]
            if rec["value"] is not None:
                led.y[b, tid] = float(rec["value"])
            seq = rec.get("obs_seq")
            led.obs_seq[b, tid] = -1 if seq is None else int(seq)
            self._trials[tid] = t
        self._obs_count = 1 + max(
            (t.obs_seq for t in self._trials.values()
             if t.obs_seq is not None), default=-1)
        self._rng = rng_from_state(sd["rng_state"])
        self._gp_snapshot = sd.get("gp")
        self._strat = None
        snap = self._gp_snapshot
        if snap and self.optimizer in _BANKABLE:
            # the bank keeps its fit schedule in the ledger: restore the
            # log-hypers and the frozen standardization over the first
            # n_fit observations, so the resumed bank replays bit-identical
            # proposals
            obs = self.observed_trials()
            if obs:
                lp = snap["log_params"]
                led.log_ls[b] = np.asarray(lp["log_ls"], np.float32)
                led.log_var[b] = np.float32(lp["log_var"])
                led.log_noise[b] = np.float32(lp["log_noise"])
                n_fit = max(1, min(int(snap["n_fit"]), len(obs)))
                led.n_fit[b] = n_fit
                led.have_fit[b] = 1
                led.y_mean[b], led.y_std[b] = _y_standardization(
                    self._signed_y(obs)[:n_fit])
                led.obs_stamp += 1   # defensive: hypers changed

    # ------------------------------------------------------- file checkpoint
    def save(self, path, iteration: int = 0) -> None:
        """Atomically write ``{"iteration", "optimizer"}`` to ``path``."""
        p = Path(path)
        tmp = p.with_suffix(".tmp")
        with open(tmp, "w") as fh:
            fh.write(json.dumps({"iteration": iteration,
                                 "optimizer": self.state_dict()}))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, p)  # atomic swap: a crash never publishes a torn file

    def load(self, path) -> int:
        """Load a ``save`` checkpoint; returns the stored iteration."""
        state = json.loads(Path(path).read_text())
        self.load_state_dict(state["optimizer"])
        return state["iteration"]
