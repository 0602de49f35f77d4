"""Tuner: the synchronous batch driver over ``AskTellOptimizer``.

The PyTorch counterpart of ``repro.core.tuner``.  All optimizer state lives
in the ask/tell core; this class runs the paper's Fig. 1 workflow: ask a
batch, dispatch it through the objective, tell back whatever subset returns,
repeat.  The objective receives a list of configurations and returns
``(evals, params)``, any subset in any order; missing entries are told as
failed and never reach the surrogate.

Config keys (mirroring Mango's ``conf_dict``):
  batch_size (1), num_iteration (20), initial_random (2),
  optimizer ("bayesian" | "hallucination" | "hallucination_ref" |
  "clustering" | "tpe" | "random"),
  domain_size (None -> heuristic), mc_samples (None -> heuristic),
  seed (0), early_stopping (callable(results) -> bool),
  checkpoint_path (None), fit_steps (40), refit_every (8),
  scheduler (None; a ``repro_torch.scheduler`` scheduler — then
  ``objective`` is a per-trial callable it wraps into the batch objective;
  a scheduler with ``make_engine`` also supplies the ask/tell core),
  strategy_kwargs (None; TPE's ``gamma`` and ``pending_penalty``,
  clustering's ``top_frac``, the GP strategies' ``scorer``; an unknown key
  raises ``TypeError`` at the first ask), device (None ->
  "cuda"; "cpu" runs the plain PyTorch versions on the CPU).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.optimizer import AskTellOptimizer, Trial

DEFAULTS = dict(batch_size=1, num_iteration=20, initial_random=2,
                optimizer="bayesian", domain_size=None, mc_samples=None,
                seed=0, early_stopping=None, checkpoint_path=None,
                fit_steps=40, refit_every=8, scheduler=None,
                strategy_kwargs=None, device=None)


@dataclasses.dataclass
class TunerResults:
    best_objective: float
    best_params: Dict[str, Any]
    params_tried: List[Dict[str, Any]]
    objective_values: List[float]
    best_trace: List[float]          # best-so-far per iteration
    iterations: int
    n_failed: int
    wall_time_s: float

    def as_dict(self):
        return dataclasses.asdict(self)

    def __getitem__(self, key):      # legacy dict-style access
        return getattr(self, key)


class Tuner:
    def __init__(self, param_space: Dict[str, Any],
                 objective: Callable[..., Any],
                 config: Optional[Dict[str, Any]] = None):
        self.conf = {**DEFAULTS, **(config or {})}
        unknown = set(self.conf) - set(DEFAULTS)
        if unknown:
            raise ValueError(f"unknown Tuner config keys: {sorted(unknown)}")
        sched = self.conf["scheduler"]
        if sched is not None:
            # objective is a per-trial fn; the scheduler wraps it into the
            # paper's batch objective
            objective = sched.make_objective(objective)
        self.objective = objective
        if sched is not None and hasattr(sched, "make_engine"):
            # the scheduler supplies the ask/tell core itself (e.g.
            # ServiceScheduler: a remote study on the durable tuning
            # service, where strategy config lives server-side)
            self.opt = sched.make_engine(param_space, self.conf)
        else:
            self.opt = AskTellOptimizer(
                param_space, optimizer=self.conf["optimizer"],
                seed=self.conf["seed"],
                domain_size=self.conf["domain_size"],
                mc_samples=self.conf["mc_samples"],
                fit_steps=self.conf["fit_steps"],
                refit_every=self.conf["refit_every"],
                strategy_kwargs=self.conf["strategy_kwargs"],
                device=self.conf["device"])
        self.space = self.opt.space
        self._iteration = 0
        ckpt = self.conf["checkpoint_path"]
        if ckpt and Path(ckpt).exists():
            self.load_state(ckpt)

    # ------------------------------------------------------------- plumbing
    def _run_batch(self, trials: List[Trial]) -> None:
        """Dispatch a batch and tell back whatever subset comes back."""
        out = self.objective([t.params for t in trials])
        if out is None:
            evals, params = [], []
        elif isinstance(out, tuple) and len(out) == 2:
            evals, params = out
        else:  # plain list of values, aligned with the batch
            evals, params = list(out), [t.params for t in trials]
        if len(evals) != len(params):
            raise ValueError(
                "objective must return (evals, params) of equal length")
        remaining = list(trials)
        for v, p in zip(evals, params):
            t = self._match(remaining, p)
            if t is None and remaining:
                # objectives may return transformed configs: the returned
                # params are authoritative; pair with a pending slot so the
                # failure count stays len(batch) - len(evals)
                t = remaining.pop(0)
            if t is not None:
                t.params = dict(p)
                self.opt.tell(t.id, v)
            else:   # more results than the batch had slots
                self.opt.observe_params(p, v)
        for t in remaining:   # never came back -> failed (paper contract)
            self.opt.tell_failed(t.id)

    @staticmethod
    def _match(remaining: List[Trial], params) -> Optional[Trial]:
        """Pair a returned config with its pending trial: identity first,
        then equality."""
        for i, t in enumerate(remaining):
            if t.params is params:
                return remaining.pop(i)
        for i, t in enumerate(remaining):
            try:
                if t.params == params:
                    return remaining.pop(i)
            except ValueError:     # array-valued params: skip equality
                continue
        return None

    # ---------------------------------------------------------------- public
    def maximize(self) -> TunerResults:
        return self._run(sign=1.0)

    def minimize(self) -> TunerResults:
        return self._run(sign=-1.0)

    # mango-compatible alias
    run = maximize

    def _run(self, sign: float) -> TunerResults:
        self.opt.sign = sign
        t0 = time.perf_counter()
        bs = self.conf["batch_size"]

        if self.opt.num_trials == 0:
            n0 = max(self.conf["initial_random"], 1)
            self._run_batch(self.opt.ask(n0))
            self._checkpoint()

        while self._iteration < self.conf["num_iteration"]:
            self._run_batch(self.opt.ask(bs))
            self._iteration += 1
            self.opt.snapshot_trace()
            self._checkpoint()
            es = self.conf["early_stopping"]
            if es and self.opt.n_observed and es(self._partial_results()):
                break
        return self._partial_results(wall=time.perf_counter() - t0)

    def _partial_results(self, wall: float = 0.0) -> TunerResults:
        return self.opt.results(iterations=self._iteration, wall=wall)

    # ------------------------------------------------------------ checkpoint
    def _checkpoint(self):
        path = self.conf["checkpoint_path"]
        if path:
            self.opt.save(path, iteration=self._iteration)

    def load_state(self, path):
        self._iteration = self.opt.load(path)
