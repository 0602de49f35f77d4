"""Local schedulers: serial (paper Listing 3), thread pool, process pool.

All three implement the batch-objective protocol; ``.as_async()`` (from
``BatchSchedulerBase``) returns the submit/wait_any view.  Copies of the
JAX package's ``repro.scheduler.local`` classes, but for the process pool's
start method: its workers are spawned, never forked.
"""
from __future__ import annotations

import concurrent.futures as cf
import logging
import multiprocessing
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.scheduler.base import BatchSchedulerBase, Objective, TrialFn

_log = logging.getLogger(__name__)


class SerialScheduler(BatchSchedulerBase):
    """Sequential evaluation; failed trials are dropped (partial results)."""

    def make_objective(self, trial_fn: TrialFn) -> Objective:
        def objective(params_list):
            evals, params = [], []
            for par in params_list:
                try:
                    evals.append(float(trial_fn(par)))
                    params.append(par)
                except Exception as e:
                    # dropped -> tuner never observes it (paper's
                    # fault-tolerance contract), but the drop is visible
                    _log.debug("trial dropped (%s): %r", par, e)
            return evals, params

        return objective


class ThreadScheduler(BatchSchedulerBase):
    """Threaded evaluation with a per-batch deadline.

    Results that miss the deadline (stragglers) are not waited for: the
    batch returns partially, the paper's missing-results contract.  Trials
    run on daemon threads gated by a semaphore (at most ``n_workers``
    concurrent), so an abandoned straggler never blocks interpreter exit.
    """

    def __init__(self, n_workers: int = 4, timeout: Optional[float] = None):
        self.n_workers = n_workers
        self.timeout = timeout

    def make_objective(self, trial_fn: TrialFn) -> Objective:
        def objective(params_list):
            cv = threading.Condition()
            gate = threading.BoundedSemaphore(self.n_workers)
            cancelled = threading.Event()
            evals: List[float] = []
            params: List[Dict[str, Any]] = []
            state = {"left": len(params_list)}

            def run(par):
                try:
                    with gate:
                        # deadline already fired while queued behind the
                        # gate: never start the trial
                        if cancelled.is_set():
                            return
                        v = float(trial_fn(par))
                    with cv:
                        evals.append(v)
                        params.append(par)
                except Exception as e:
                    # dropped -> tuner never observes it, but visibly
                    _log.debug("trial dropped (%s): %r", par, e)
                finally:
                    with cv:
                        state["left"] -= 1
                        cv.notify_all()

            for par in params_list:
                threading.Thread(target=run, args=(par,), daemon=True,
                                 name="mango-thread-worker").start()
            deadline = (None if self.timeout is None
                        else time.monotonic() + self.timeout)
            with cv:
                while state["left"] > 0:
                    rem = (None if deadline is None
                           else deadline - time.monotonic())
                    if rem is not None and rem <= 0:
                        break  # deadline: return what we have
                    cv.wait(rem)
                # snapshot under the lock: a straggler landing after the
                # deadline appends to the dead lists, not the result
                out = (list(evals), list(params))
            cancelled.set()
            return out

        return objective


class ProcessScheduler(BatchSchedulerBase):
    """Process-pool evaluation (trial_fn must be picklable).

    One pool per batch, as in the reference; failed trials are dropped and
    a batch past ``timeout`` cancels what has not started.  Workers are
    spawned, not forked: a parent that has touched the card holds a CUDA
    context, which a forked child cannot use (a forkserver context, which
    would also do, started its pools no faster on an H100 machine:
    ``chip_smoke.py`` phase 20a).
    """

    def __init__(self, n_workers: int = 2, timeout: Optional[float] = None):
        self.n_workers = n_workers
        self.timeout = timeout

    def make_objective(self, trial_fn: TrialFn) -> Objective:
        def objective(params_list):
            evals, params = [], []
            ctx = multiprocessing.get_context("spawn")
            with cf.ProcessPoolExecutor(max_workers=self.n_workers,
                                        mp_context=ctx) as ex:
                futs = {ex.submit(trial_fn, par): par for par in params_list}
                try:
                    for fut in cf.as_completed(futs, timeout=self.timeout):
                        par = futs[fut]
                        try:
                            evals.append(float(fut.result()))
                            params.append(par)
                        except Exception as e:
                            # dropped -> tuner never observes it
                            _log.debug("trial dropped (%s): %r", par, e)
                except cf.TimeoutError:
                    for fut in futs:
                        fut.cancel()
            return evals, params

        return objective
