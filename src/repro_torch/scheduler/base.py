"""Scheduler abstraction (paper §2.4).

Mango's key design decision: the optimizer never talks to a scheduling
framework.  A scheduler (``Scheduler``) is a factory that wraps a per-trial
callable into the paper's batch objective: it takes a list of
configurations and returns partial ``(evals, params)``.  The synchronous
``Tuner`` loop uses it directly.

A copy of the batch half of the JAX package's ``repro.scheduler.base``, plus
the lock-ownership assertion ``assert_holds`` of ``repro.analysis.sanitizers``:
the port imports nothing of either.  The submit/wait_any protocol and its adapters come with the async
tuner.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Protocol, Tuple

# caller-must-hold lock checks run only in debug mode (REPRO_DEBUG_LOCKS=1)
_DEBUG_LOCKS = os.environ.get("REPRO_DEBUG_LOCKS", "") not in ("", "0")


def assert_holds(lock) -> None:
    """Assert the calling thread holds ``lock`` (a no-op outside debug
    mode).  RLock/Condition check true ownership; a plain Lock only
    held-by-someone."""
    if not _DEBUG_LOCKS:
        return
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        if not owned():
            raise AssertionError(
                f"assert_holds: {lock!r} is not held by "
                f"{threading.current_thread().name}")
        return
    locked = getattr(lock, "locked", None)
    if locked is not None and not locked():
        raise AssertionError(
            f"assert_holds: {lock!r} is not held (plain Lock: ownership "
            "is unverifiable, only held-by-someone)")


TrialFn = Callable[[Dict[str, Any]], float]
Objective = Callable[[List[Dict[str, Any]]],
                     Tuple[List[float], List[Dict[str, Any]]]]


class Scheduler(Protocol):
    def make_objective(self, trial_fn: TrialFn) -> Objective:
        """Wrap a single-config callable into Mango's batch objective."""
        ...


class BatchSchedulerBase:
    """Base class of the batch-objective schedulers."""

    def make_objective(self, trial_fn: TrialFn) -> Objective:
        raise NotImplementedError
