"""Task-queue scheduler reproducing the paper's Celery/Kubernetes deployment.

Semantics modeled on Listing 4 (``train_clf.delay(par)`` + ``process.get()``):

  * tasks are pushed to a queue consumed by a pool of long-lived workers,
  * a per-batch deadline bounds the ``get()`` — stragglers are abandoned,
  * worker failures (injected for testing: ``failure_rate``) surface as
    dropped results, not batch failures,
  * optional ``max_retries`` re-enqueues failed tasks (beyond-paper, matches
    Celery's ``task_acks_late`` production configuration),
  * an async API (``submit`` / ``gather``) used by the asynchronous tuner.

Fault injection exists so the test-suite can drill the tuner's partial-result
contract under worker crashes and stragglers deterministically: each task
carries its own RNG seeded from ``(faults.seed, submit sequence)``, so the
injected failure/straggler set is a pure function of the submission order —
identical across runs regardless of how worker threads race on the queue
(the old shared ``random.Random`` made the dropped set depend on thread
scheduling).

A copy of the JAX package's ``repro.scheduler.distributed``: the same
seeding gives the same dropped set for the same seed and submit order.
"""
from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.sanitizers import assert_holds
from repro_torch.scheduler.base import Objective, TaskHandle, TrialFn


@dataclasses.dataclass
class FaultInjection:
    failure_rate: float = 0.0       # P(worker raises) per task
    straggler_rate: float = 0.0     # P(task sleeps straggler_delay)
    straggler_delay: float = 1.0    # seconds
    seed: int = 0


class _Task(TaskHandle):
    __slots__ = ("retries", "rng")

    def __init__(self, params, rng: Optional[random.Random] = None):
        super().__init__(params)
        self.retries = 0
        # per-task fault RNG, seeded from (faults.seed, submit sequence):
        # injected failures/stragglers are a pure function of the task, so
        # two runs drop identical task sets no matter how the queue races
        # tasks across worker threads (a shared — or even per-worker — RNG
        # couldn't give that: task -> worker assignment is nondeterministic)
        self.rng = rng


class TaskQueueScheduler:
    """Celery-like distributed task queue with a local worker pool.

    Implements both scheduler protocols natively: the batch objective
    (``make_objective``) and the async submit/wait_any interface — task
    completion signals ``_done_cv``, so ``AsyncTuner`` wakes exactly when a
    trial finishes instead of polling.
    """

    def __init__(self, n_workers: int = 4, timeout: Optional[float] = None,
                 max_retries: int = 0,
                 faults: Optional[FaultInjection] = None):
        self.n_workers = n_workers
        self.timeout = timeout
        self.max_retries = max_retries
        self.faults = faults or FaultInjection()
        self._task_seq = 0              # submit counter seeding task RNGs
        self._q: "queue.Queue[Optional[Tuple[_Task, TrialFn]]]" = queue.Queue()
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._outstanding = 0           # submitted tasks not yet finished
        self._lock = threading.Lock()
        self._done_cv = threading.Condition()
        self._started = False
        self.stats = {"completed": 0, "failed": 0, "retried": 0,
                      "straggled": 0}

    # ------------------------------------------------------------ lifecycle
    def start(self):
        with self._lock:
            if self._started:
                return
            self._started = True
            for i in range(self.n_workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"mango-worker-{i}", daemon=True)
                t.start()
                self._workers.append(t)

    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Stop the worker pool.  ``timeout=None`` keeps the legacy
        semantics: stop immediately, abandoning whatever is in flight.
        With a ``timeout``, first *drain*: new submits are refused while
        every already-queued task runs to completion (retries included),
        then the workers are stopped.  Returns whether the queue was fully
        drained — the durable service checks this before snapshotting so a
        graceful stop can't orphan pending trials."""
        drained = True
        if timeout is not None:
            with self._done_cv:
                # set under the cv: pairs with submit's atomic
                # check+increment, see there
                self._draining.set()
                self._done_cv.wait_for(self._drained_locked, timeout)
                drained = self._drained_locked()
        self._stop.set()
        for _ in self._workers:
            self._q.put(None)
        return drained

    def _worker_loop(self):
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                return
            task, fn = item
            try:
                # the task's own RNG decides its fate (no lock needed — one
                # worker holds a task at a time, and retries re-enqueue the
                # same object, drawing the next values of its stream)
                fail = task.rng.random() < self.faults.failure_rate
                straggle = task.rng.random() < self.faults.straggler_rate
                if straggle:
                    self._bump("straggled")
                    time.sleep(self.faults.straggler_delay)
                if fail:
                    raise RuntimeError("injected worker failure")
                task.result = float(fn(task.params))
                self._bump("completed")
                self._finish(task)
            except Exception as e:  # noqa: BLE001
                if task.retries < self.max_retries:
                    task.retries += 1
                    self._bump("retried")
                    self._q.put((task, fn))
                else:
                    task.error = e
                    self._bump("failed")
                    self._finish(task)

    def _bump(self, key: str) -> None:
        # bare ``stats[k] += 1`` is a read-modify-write that loses counts
        # when workers race on the same key
        with self._lock:
            self.stats[key] += 1

    def _finish(self, task: _Task) -> None:
        # notify under the condition lock: wait_any's predicate check and
        # wait are serialized against this, so completions are never missed
        # (a retried task is not finished — it re-enqueues without landing
        # here, so it stays outstanding until its final attempt)
        with self._done_cv:
            task.done.set()
            self._outstanding -= 1
            self._done_cv.notify_all()

    # ------------------------------------------------------------- async API
    def submit(self, fn: TrialFn, params: Dict[str, Any]) -> _Task:
        with self._done_cv:
            # the drain/stop check and the outstanding increment are one
            # critical section (shutdown sets _draining under this same
            # cv), so a submit racing shutdown(timeout) either counts
            # toward the drain or raises — drained=True can't leave a
            # task running behind the caller's back
            if self._stop.is_set() or self._draining.is_set():
                # start() after shutdown() is a no-op (_started stays
                # True), so the task would land in a queue no worker ever
                # drains and wait_any would hang until its timeout; during
                # a drain the whole point is that the in-flight set only
                # shrinks
                raise RuntimeError(
                    "submit() after shutdown(): this scheduler's workers "
                    "have exited or are draining; create a new "
                    "TaskQueueScheduler")
            self._outstanding += 1
        self.start()
        with self._lock:
            seq = self._task_seq
            self._task_seq += 1
        task = _Task(params,
                     rng=random.Random(self.faults.seed * 1_000_003 + seq))
        self._q.put((task, fn))
        return task

    def wait_any(self, handles: List[TaskHandle],
                 timeout: Optional[float] = None) -> List[TaskHandle]:
        """Block until at least one submitted task completes; wakes on the
        completion condition, not a poll loop."""
        if not handles:
            return []
        with self._done_cv:
            self._done_cv.wait_for(
                lambda: any(h.done.is_set() for h in handles), timeout)
            return [h for h in handles if h.done.is_set()]

    def _drained_locked(self) -> bool:
        """Caller must hold ``_done_cv`` — ``_outstanding`` is only
        coherent under it (wait_for re-acquires before each call)."""
        assert_holds(self._done_cv)
        return self._outstanding == 0

    def gather(self, tasks: List[_Task], timeout: Optional[float] = None
               ) -> Tuple[List[float], List[Dict[str, Any]]]:
        # monotonic deadline: a wall-clock (NTP) step must not stretch or
        # collapse the per-batch timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        evals, params = [], []
        for t in tasks:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if t.done.wait(remaining) and t.error is None:
                evals.append(t.result)
                params.append(t.params)
        return evals, params

    # --------------------------------------------------------- batch objective
    def make_objective(self, trial_fn: TrialFn) -> Objective:
        def objective(params_list):
            tasks = [self.submit(trial_fn, par) for par in params_list]
            return self.gather(tasks, timeout=self.timeout)

        return objective
