"""Scheduler abstraction (paper §2.4).

Mango's key design decision: the optimizer never talks to a scheduling
framework.  Two execution protocols drive the same ask/tell core:

  * **Batch** (``Scheduler``): a factory that wraps a per-trial callable
    into the paper's batch objective — takes a list of configurations,
    returns partial ``(evals, params)``.  The synchronous ``Tuner`` loop
    uses this directly.
  * **Async** (``AsyncScheduler``): ``submit(fn, params) -> TaskHandle``
    plus ``wait_any(handles)`` — a completion-event interface the
    ``AsyncTuner`` event loop blocks on.  Implementations signal a
    ``threading.Condition`` when a trial finishes, so the event loop wakes
    exactly then (no polling).

``BatchToAsyncAdapter`` bridges the two: any batch-objective scheduler
(serial, thread pool, process pool, task queue) becomes submittable one
trial at a time, keeping its own fault semantics (a dropped trial surfaces
as a failed handle).  ``as_async`` picks the right view automatically, so
both tuners accept *any* scheduler.

The port's own copy of the JAX package's ``repro.scheduler.base`` (the port
imports nothing of it); ``assert_holds`` is re-exported from the port's
``repro_torch.analysis.sanitizers``.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Tuple)

from repro_torch.analysis.sanitizers import assert_holds

TrialFn = Callable[[Dict[str, Any]], float]
Objective = Callable[[List[Dict[str, Any]]],
                     Tuple[List[float], List[Dict[str, Any]]]]


class Scheduler(Protocol):
    def make_objective(self, trial_fn: TrialFn) -> Objective:
        """Wrap a single-config callable into Mango's batch objective."""
        ...


class TaskHandle:
    """A single in-flight trial: result/error land here, ``done`` is set
    last (and the owning scheduler's condition is notified)."""

    __slots__ = ("params", "result", "error", "done")

    def __init__(self, params: Dict[str, Any]):
        self.params = params
        self.result: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class AsyncScheduler(Protocol):
    def submit(self, fn: TrialFn, params: Dict[str, Any]) -> TaskHandle:
        """Dispatch one trial; returns immediately with its handle."""
        ...

    def wait_any(self, handles: List[TaskHandle],
                 timeout: Optional[float] = None) -> List[TaskHandle]:
        """Block until at least one handle completes (or timeout); return
        the completed subset."""
        ...


class BatchSchedulerBase:
    """Mixin for batch-objective schedulers: ``as_async()`` returns the
    submit-style view of this scheduler."""

    def make_objective(self, trial_fn: TrialFn) -> Objective:
        raise NotImplementedError

    def as_async(self, coalesce: bool = False) -> "BatchToAsyncAdapter":
        return BatchToAsyncAdapter(self, coalesce=coalesce)


def _identity(x):
    return x


class _WeakTrial:
    """The adapter's cached view of a trial fn: calls it through a weak
    reference.  It pickles as the live fn itself, so a process pool's
    workers receive the fn (the JAX package's closure over the weak
    reference cannot be pickled: there every ``ProcessScheduler`` trial
    submitted through the adapter was dropped)."""

    __slots__ = ("ref",)

    def __init__(self, fn: TrialFn):
        self.ref = weakref.ref(fn)

    def _live(self) -> TrialFn:
        live = self.ref()
        if live is None:
            raise RuntimeError("trial fn was garbage-collected while cached")
        return live

    def __call__(self, par):
        return self._live()(par)

    def __reduce__(self):
        return _identity, (self._live(),)


class BatchToAsyncAdapter:
    """Drive a batch-objective ``Scheduler`` one trial at a time.

    Each ``submit`` runs a single-element batch through the wrapped
    scheduler's objective on its own daemon thread (the driver caps
    in-flight trials, so thread count stays bounded; daemon threads mean an
    abandoned straggler can never block interpreter exit), preserving the
    scheduler's fault/deadline semantics: an empty partial result means the
    trial was dropped and surfaces as a failed handle.  Completion signals
    the shared condition variable, so ``wait_any`` wakes exactly when a
    trial lands.

    ``coalesce=True`` batches instead: submits enqueue, and a single
    dispatcher thread drains the whole queue into ONE objective call per
    (objective, drain) group.  Schedulers with per-batch setup cost — a
    ``ProcessScheduler`` builds a fresh process pool per objective call, a
    task-queue scheduler pays a round-trip — amortize that cost over every
    trial queued while the previous dispatch ran, at the price of
    dispatch-granular (not trial-granular) completion.  Fault semantics
    are the batch contract's: results are matched back to handles
    identity-first (the scheduler echoes the params object) then by
    equality, and a submitted trial missing from the partial result
    surfaces as a failed handle.
    """

    def __init__(self, scheduler: Scheduler, coalesce: bool = False):
        self.scheduler = scheduler
        self.coalesce = bool(coalesce)
        self._queue: List[tuple] = []   # (handle, objective, pinned fn)
        self._dispatcher: Optional[threading.Thread] = None
        self._cv = threading.Condition()
        self._outstanding = 0           # submitted, not yet done
        self._closed = False            # shutdown() called: submit refused
        # keyed by the fn object itself, weakly: an ``id(fn)`` key outlives
        # the fn, so a later fn allocated at the recycled address would
        # silently inherit the *old* objective (and every entry would leak
        # for the adapter's lifetime)
        self._objectives: "weakref.WeakKeyDictionary[TrialFn, Objective]" \
            = weakref.WeakKeyDictionary()

    def _objective_for(self, fn: TrialFn) -> Tuple[Objective, TrialFn]:
        """Returns (objective, pin): ``pin`` is the exact fn object the
        cached objective weak-references, and the caller must keep it
        alive for the trial's duration.  Lookups are by equality, so an
        equal-but-distinct callable (a fresh bound-method object) can hit
        an entry wrapping an *earlier* object — pinning the wrapped object
        itself (not the argument) is what makes that reuse safe."""
        try:
            ent = self._objectives.get(fn)
            if ent is not None:
                wrapped = ent[0]()
                if wrapped is not None:
                    return ent[1], wrapped
            # the objective must not hold fn strongly, or the cache entry
            # (value -> fn -> key) could never be collected; the weak
            # indirection is resolved per call, and ``submit`` pins the
            # wrapped fn for each in-flight trial's duration
            call_fn = _WeakTrial(fn)
            obj = self.scheduler.make_objective(call_fn)
            self._objectives[fn] = (call_fn.ref, obj)
            return obj, fn
        except TypeError:
            # unhashable / non-weak-referenceable callables: skip the cache
            return self.scheduler.make_objective(fn), fn

    def submit(self, fn: TrialFn, params: Dict[str, Any]) -> TaskHandle:
        handle = TaskHandle(params)
        objective, pin = self._objective_for(fn)
        with self._cv:
            # closed-check and increment are one critical section:
            # shutdown() flips _closed under this same lock, so a submit
            # racing a drain either lands before _closed (counted in
            # _outstanding, so drained=True waits for it) or raises —
            # never a trial running after shutdown reported drained
            if self._closed:
                raise RuntimeError(
                    "submit() after shutdown(): this adapter is "
                    "draining/stopped and accepts no new trials")
            self._outstanding += 1
            if self.coalesce:
                self._queue.append((handle, objective, pin))
                if self._dispatcher is None:
                    self._dispatcher = threading.Thread(
                        target=self._drain_loop, daemon=True,
                        name="mango-async-coalesce")
                    self._dispatcher.start()
                self._cv.notify_all()
                return handle

        def run(_pin_fn=pin):   # keep the wrapped fn alive for this trial
            try:
                evals, _ = objective([params])
                if evals:
                    handle.result = float(evals[0])
                else:
                    handle.error = RuntimeError(
                        "trial dropped by scheduler (fault/deadline)")
            except Exception as e:  # noqa: BLE001
                handle.error = e
            with self._cv:
                handle.done.set()
                self._outstanding -= 1
                self._cv.notify_all()

        threading.Thread(target=run, daemon=True,
                         name="mango-async-adapter").start()
        return handle

    # ---- coalescing dispatcher -------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._queue)
                batch, self._queue = self._queue, []
            # group by cached objective (== by trial fn): one scheduler
            # dispatch per group, preserving submit order across groups
            groups: Dict[int, tuple] = {}
            order: List[int] = []
            for h, obj, pin in batch:
                k = id(obj)
                if k not in groups:
                    groups[k] = (obj, [])
                    order.append(k)
                groups[k][1].append((h, pin))
            for k in order:
                obj, items = groups[k]
                self._dispatch_group(obj, items)

    def _dispatch_group(self, objective: Objective, items: List[tuple]):
        """One batch dispatch; match the partial result back to handles
        (identity first, then equality — the tuner's matching contract)."""
        try:
            evals, params = objective([h.params for h, _ in items])
            remaining = list(items)
            for v, par in zip(evals, params):
                hit = next((i for i, (h, _) in enumerate(remaining)
                            if h.params is par), None)
                if hit is None:
                    hit = next((i for i, (h, _) in enumerate(remaining)
                                if h.params == par), None)
                if hit is None and remaining:
                    hit = 0   # unmatchable result: consume in submit order
                if hit is None:
                    continue  # more results than submitted handles
                remaining.pop(hit)[0].result = float(v)
            for h, _ in remaining:
                h.error = RuntimeError(
                    "trial dropped by scheduler (fault/deadline)")
        except Exception as e:  # noqa: BLE001
            for h, _ in items:
                if h.result is None and h.error is None:
                    h.error = e
        with self._cv:
            for h, _ in items:
                h.done.set()
            self._outstanding -= len(items)
            self._cv.notify_all()

    def wait_any(self, handles: List[TaskHandle],
                 timeout: Optional[float] = None) -> List[TaskHandle]:
        if not handles:
            return []
        with self._cv:
            self._cv.wait_for(
                lambda: any(h.done.is_set() for h in handles), timeout)
            return [h for h in handles if h.done.is_set()]

    # ------------------------------------------------------- graceful drain
    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting submits; with a ``timeout``, block until every
        in-flight trial has completed (drained) or the deadline passes.
        ``timeout=None`` closes immediately without waiting.  Returns
        whether the adapter is fully drained — a service caller snapshots
        only after a ``True`` here, so a stop can't orphan pending trials.
        Safe to call more than once."""
        with self._cv:
            self._closed = True
            if timeout is None:
                return self._drained_locked()
            self._cv.wait_for(self._drained_locked, timeout)
            return self._drained_locked()

    def _drained_locked(self) -> bool:
        """Caller must hold ``_cv`` — ``_outstanding`` is only coherent
        under it (wait_for re-acquires before each predicate call)."""
        assert_holds(self._cv)
        return self._outstanding == 0


class _PollingWaitShim:
    """Wrap a scheduler that has ``submit`` but no ``wait_any`` (third-party
    implementations): fall back to polling the done events."""

    def __init__(self, scheduler, poll: float = 0.01):
        self._sched = scheduler
        self._poll = poll

    def submit(self, fn, params):
        return self._sched.submit(fn, params)

    def wait_any(self, handles, timeout=None):
        if not handles:
            return []
        # monotonic: an NTP wall-clock step must not corrupt the deadline
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            done = [h for h in handles if h.done.is_set()]
            if done or (deadline is not None
                        and time.monotonic() >= deadline):
                return done
            time.sleep(self._poll)


def as_async(scheduler, poll: float = 0.01,
             coalesce: bool = False) -> AsyncScheduler:
    """Return the async (submit/wait_any) view of any scheduler.  ``poll``
    only applies to the shim around submit-only schedulers; everything else
    wakes on a completion condition.  ``coalesce`` batches queued submits
    into one dispatch per drain (batch-objective schedulers only)."""
    if hasattr(scheduler, "submit"):
        if hasattr(scheduler, "wait_any"):
            return scheduler
        return _PollingWaitShim(scheduler, poll=poll)
    if hasattr(scheduler, "make_objective"):
        return BatchToAsyncAdapter(scheduler, coalesce=coalesce)
    raise TypeError(f"{scheduler!r} implements neither the batch nor the "
                    "async scheduler protocol")
