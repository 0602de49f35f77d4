"""Asynchronous tuner: the completion-event driver over ``AskTellOptimizer``.

The PyTorch counterpart of ``repro.core.async_tuner``.  The synchronous
tuner waits for a whole batch before proposing again; with heterogeneous
trial times, workers idle at every barrier.  ``AsyncTuner`` keeps up to
``batch_size`` trials in flight: whenever one completes it is told back to
the ask/tell core and one replacement trial is asked.  The core hands the
pending set to the bank pipeline: GP-BUCB and clustering absorb the
in-flight rows (``gp.bank_absorb``), TPE adds them to the bad split when
``pending_penalty`` is on.

The event loop blocks on the scheduler's completion condition
(``wait_any``), waking exactly when a trial finishes.  Any scheduler works:
native async ones are used directly, batch-objective ones are wrapped by
``BatchToAsyncAdapter`` (``repro_torch.scheduler.as_async``).

Because the ledger (including in-flight trials) lives in the core,
``checkpoint_path`` gives the async loop the same kill/resume guarantee as
the sync tuner: pending trials are re-dispatched on resume and the
remaining proposals replay exactly.

The core is a local ``AskTellOptimizer`` on ``device`` (``cuda`` unless
``"cpu"`` is asked for), unless the scheduler supplies one through
``make_engine`` (``ServiceScheduler``: a remote study on the durable tuning
service, whose strategy settings live server-side).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from repro_torch.core.optimizer import AskTellOptimizer
from repro_torch.core.tuner import TunerResults
from repro_torch.device import DeviceLike
from repro_torch.scheduler.base import as_async


class AsyncTuner:
    def __init__(self, param_space: Dict[str, Any],
                 trial_fn: Callable[[Dict[str, Any]], float],
                 scheduler, num_evals: int = 40, batch_size: int = 4,
                 initial_random: int = 4, seed: int = 0,
                 mc_samples: Optional[int] = None,
                 poll_interval: float = 0.01, refit_every: int = 8,
                 optimizer: str = "bayesian", fit_steps: int = 40,
                 domain_size: Optional[float] = None,
                 early_stopping: Optional[Callable[[TunerResults], bool]]
                 = None,
                 checkpoint_path: Optional[str] = None,
                 strategy_kwargs: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        self.trial_fn = trial_fn
        # poll_interval only matters for submit-only schedulers without a
        # completion condition; everything in-repo wakes on wait_any
        self.sched = as_async(scheduler, poll=poll_interval)
        self.num_evals = num_evals
        self.batch_size = batch_size
        self.initial_random = initial_random
        self.poll = poll_interval
        self.early_stopping = early_stopping
        self.checkpoint_path = checkpoint_path
        if hasattr(scheduler, "make_engine"):
            # scheduler-supplied ask/tell core (ServiceScheduler: a remote
            # study on the durable service; strategy config is server-side)
            self.opt = scheduler.make_engine(param_space, None)
        else:
            self.opt = AskTellOptimizer(
                param_space, optimizer=optimizer, seed=seed,
                domain_size=domain_size, mc_samples=mc_samples,
                fit_steps=fit_steps, refit_every=refit_every,
                strategy_kwargs=strategy_kwargs, device=device)
        self.space = self.opt.space
        if checkpoint_path and Path(checkpoint_path).exists():
            self.load_state(checkpoint_path)

    # ---------------------------------------------------------------- public
    def maximize(self) -> TunerResults:
        return self._run(sign=1.0)

    def minimize(self) -> TunerResults:
        return self._run(sign=-1.0)

    def _done_count(self) -> int:
        return self.opt.n_observed + self.opt.n_failed

    def _run(self, sign: float) -> TunerResults:
        self.opt.sign = sign
        t0 = time.perf_counter()
        opt = self.opt
        inflight = {}   # TaskHandle -> trial id

        def dispatch(trial):
            handle = self.sched.submit(self.trial_fn, trial.params)
            inflight[handle] = trial.id

        # resume: the ledger still holds trials that were in flight when the
        # run died — re-dispatch them so the replay matches the
        # uninterrupted schedule
        for t in opt.pending_trials():
            dispatch(t)
        if opt.num_trials == 0:
            n0 = min(max(self.initial_random, 1), self.num_evals)
            for t in opt.ask(n0):
                dispatch(t)

        while self._done_count() < self.num_evals:
            # keep the pipeline full: one replacement ask per free slot
            while (opt.num_trials < self.num_evals
                   and len(inflight) < self.batch_size):
                for t in opt.ask(1):
                    dispatch(t)
            done = self.sched.wait_any(list(inflight))
            for handle in done:
                trial_id = inflight.pop(handle)
                if handle.error is None:
                    opt.tell(trial_id, handle.result)
                else:
                    opt.tell_failed(trial_id)
                opt.snapshot_trace()
            self._checkpoint()
            es = self.early_stopping
            if es and opt.n_observed and es(self._partial_results()):
                break
        return self._partial_results(wall=time.perf_counter() - t0)

    def _partial_results(self, wall: float = 0.0) -> TunerResults:
        return self.opt.results(iterations=self._done_count(), wall=wall)

    # ------------------------------------------------------------ checkpoint
    def _checkpoint(self):
        if self.checkpoint_path:
            self.opt.save(self.checkpoint_path,
                          iteration=self._done_count())

    def load_state(self, path):
        self.opt.load(path)
