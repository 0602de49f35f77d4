"""PyTorch port, the schedulers of the paper's fault-tolerance claim: the
task queue with seeded fault injection, its retries, stats, shutdown drain
and submit/shutdown races, the batch adapter's drain, the process pool
(spawned workers, so a trial may use the card while the tuner holds it), and
the drivers' signatures against the JAX package's.

Copies of the JAX package's ``tests/test_scheduler.py`` cases, on the port.
The JAX package is imported inside the tests that compare with it, so the
card test runs where JAX is absent (``--noconftest``)."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import inspect
import threading
import time

import numpy as np
import pytest
import torch
from scipy.stats import uniform

from repro_torch.core import AsyncTuner, Tuner
from repro_torch.core import tuner as tuner_mod
from repro_torch.scheduler import (BatchToAsyncAdapter, FaultInjection,
                                   ProcessScheduler, SerialScheduler,
                                   TaskQueueScheduler, as_async)
from repro_torch.scheduler.base import _PollingWaitShim

SPACE = {"x": uniform(0, 1)}


def trial(p):
    return -(p["x"] - 0.5) ** 2


def flaky_trial(p):
    """Module level, so a spawned worker can unpickle it."""
    if p["x"] > 0.8:
        raise RuntimeError("boom")
    return trial(p)


def card_trial(p):
    """Computes the objective on the card, in a worker process."""
    x = torch.tensor([p["x"]], dtype=torch.float64, device="cuda")
    return float((-(x - 0.5) ** 2).item())


# --------------------------------------------------------------------------- #
# task queue: fault injection, retries, determinism, stats
# --------------------------------------------------------------------------- #
def test_taskqueue_submit_after_shutdown_raises():
    sched = TaskQueueScheduler(n_workers=2)
    h = sched.submit(trial, {"x": 0.4})
    assert sched.wait_any([h], timeout=5.0) == [h]
    sched.shutdown()
    with pytest.raises(RuntimeError, match="shutdown"):
        sched.submit(trial, {"x": 0.5})


def test_taskqueue_stats_consistent_under_worker_races():
    """Counter increments run under the scheduler lock: completed+failed
    must exactly equal the number of finished tasks."""
    sched = TaskQueueScheduler(
        n_workers=8, max_retries=1,
        faults=FaultInjection(failure_rate=0.3, seed=3))
    tasks = [sched.submit(trial, {"x": v})
             for v in np.linspace(0, 1, 64)]
    evals, _ = sched.gather(tasks, timeout=30.0)
    assert all(t.done.is_set() for t in tasks)
    assert sched.stats["completed"] + sched.stats["failed"] == 64
    assert sched.stats["completed"] == len(evals)
    sched.shutdown()


def test_taskqueue_fault_injection_and_retry():
    sched = TaskQueueScheduler(
        n_workers=4, timeout=2.0, max_retries=2,
        faults=FaultInjection(failure_rate=0.5, seed=7))
    obj = sched.make_objective(trial)
    evals, params = obj([{"x": v} for v in np.linspace(0, 1, 12)])
    # with 2 retries at 50% failure, nearly all should eventually land
    assert len(evals) >= 8
    assert sched.stats["retried"] > 0
    sched.shutdown()


def _dropped(sched_cls, faults_cls, n=40, n_workers=8, max_retries=0,
             **faults):
    sched = sched_cls(n_workers=n_workers, max_retries=max_retries,
                      faults=faults_cls(**faults))
    batch = [{"x": round(v, 6)} for v in np.linspace(0, 1, n)]
    tasks = [sched.submit(trial, p) for p in batch]
    sched.gather(tasks, timeout=30.0)
    dropped = frozenset(t.params["x"] for t in tasks if t.error is not None)
    sched.shutdown()
    return dropped


@pytest.mark.parametrize("straggler_rate", [0.0, 0.4])
def test_taskqueue_fault_injection_is_deterministic(straggler_rate):
    """Injected failures are a pure function of (faults.seed, submit
    order): two runs at failure_rate=0.5 drop identical task sets although
    the queue races tasks across 8 worker threads."""
    kw = dict(failure_rate=0.5, seed=13, straggler_rate=straggler_rate,
              straggler_delay=0.01)
    first = _dropped(TaskQueueScheduler, FaultInjection, **kw)
    assert 0 < len(first) < 40        # the injection actually fired
    for _ in range(2):
        assert _dropped(TaskQueueScheduler, FaultInjection, **kw) == first


def test_taskqueue_fault_determinism_unaffected_by_retry_races():
    """Retries draw from the failed task's own RNG stream, so the final
    survivor set stays deterministic under max_retries too."""
    kw = dict(n=32, n_workers=6, max_retries=1, failure_rate=0.5, seed=5)
    assert _dropped(TaskQueueScheduler, FaultInjection, **kw) == \
        _dropped(TaskQueueScheduler, FaultInjection, **kw)


@pytest.mark.parametrize("max_retries,straggler_rate", [(0, 0.0), (0, 0.4),
                                                        (1, 0.0)])
def test_taskqueue_dropped_set_matches_repro(max_retries, straggler_rate):
    """The same FaultInjection seed and submit order drop the same tasks
    in the port and in the JAX package's scheduler."""
    from repro.scheduler import FaultInjection as JFault
    from repro.scheduler import TaskQueueScheduler as JQueue
    kw = dict(max_retries=max_retries, failure_rate=0.5, seed=13,
              straggler_rate=straggler_rate, straggler_delay=0.01)
    got = _dropped(TaskQueueScheduler, FaultInjection, **kw)
    assert 0 < len(got) < 40
    assert got == _dropped(JQueue, JFault, **kw)


def test_taskqueue_no_faults_full_batch():
    sched = TaskQueueScheduler(n_workers=2)
    evals, params = sched.make_objective(trial)(
        [{"x": v} for v in (0.1, 0.5, 0.9)])
    assert len(evals) == 3
    sched.shutdown()


def test_end_to_end_tuning_under_faults():
    sched = TaskQueueScheduler(
        n_workers=4, timeout=1.0, max_retries=1,
        faults=FaultInjection(failure_rate=0.25, straggler_rate=0.15,
                              straggler_delay=3.0, seed=11))
    res = Tuner(SPACE, sched.make_objective(trial),
                dict(optimizer="bayesian", batch_size=4, num_iteration=6,
                     seed=0, mc_samples=1000, fit_steps=10,
                     device="cpu")).maximize()
    assert res.best_objective > -0.01
    assert res.n_failed > 0  # faults actually happened
    sched.shutdown()


def test_async_tuner_continuous_batching():
    sched = TaskQueueScheduler(n_workers=4)
    res = AsyncTuner(SPACE, trial, sched, num_evals=12, batch_size=4,
                     seed=0, mc_samples=800, device="cpu").maximize()
    assert len(res["objective_values"]) == 12
    assert res["best_objective"] > -0.05
    sched.shutdown()


# --------------------------------------------------------------------------- #
# graceful drain shutdown
# --------------------------------------------------------------------------- #
def test_task_queue_shutdown_drains_in_flight():
    """shutdown(timeout=) lets queued work finish before stopping the
    workers, and refuses new submits while draining."""
    sched = TaskQueueScheduler(n_workers=2)
    release = threading.Event()

    def slowish(p):
        release.wait(10)
        return trial(p)

    handles = [sched.submit(slowish, {"x": 0.1 * i}) for i in range(4)]
    drainer = {}
    t = threading.Thread(
        target=lambda: drainer.update(drained=sched.shutdown(timeout=10.0)))
    t.start()
    time.sleep(0.05)          # drain has started: submits must be refused
    with pytest.raises(RuntimeError, match="drain"):
        sched.submit(slowish, {"x": 0.9})
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert drainer["drained"] is True
    assert all(h.done.is_set() and h.error is None for h in handles)


def test_task_queue_shutdown_timeout_reports_undrained():
    sched = TaskQueueScheduler(n_workers=1)
    sched.submit(lambda p: time.sleep(5) or 0.0, {"x": 0.5})
    assert sched.shutdown(timeout=0.1) is False


def test_batch_adapter_shutdown_drains_and_refuses_submits():
    release = threading.Event()

    def gated(p):
        release.wait(10)
        return trial(p)

    adapter = BatchToAsyncAdapter(SerialScheduler())
    handles = [adapter.submit(gated, {"x": 0.2}) for _ in range(3)]
    out = {}
    t = threading.Thread(
        target=lambda: out.update(d=adapter.shutdown(timeout=10.0)))
    t.start()
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="shutdown"):
        adapter.submit(gated, {"x": 0.3})      # submit-during-drain
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert out["d"] is True
    assert all(h.done.is_set() for h in handles)
    # already-drained second call is a cheap no-op
    assert adapter.shutdown() is True


def test_coalescing_adapter_shutdown_counts_queued_trials():
    """A coalesced batch is outstanding until its dispatch lands: the
    drain waits for the whole group, not just the submit."""
    release = threading.Event()

    def gated(p):
        release.wait(10)
        return trial(p)

    adapter = SerialScheduler().as_async(coalesce=True)
    handles = [adapter.submit(gated, {"x": 0.1 * i}) for i in range(4)]
    assert adapter.shutdown(timeout=0.05) is False
    release.set()
    assert adapter.shutdown(timeout=10.0) is True
    assert all(h.done.is_set() and h.error is None for h in handles)


def _race(make, submit_fn, rounds):
    for _ in range(rounds):
        sched = make()
        accepted = []
        barrier = threading.Barrier(2)

        def spam(sched=sched, accepted=accepted, barrier=barrier):
            barrier.wait()
            for i in range(100):
                try:
                    accepted.append(submit_fn(sched, {"x": 0.01 * i}))
                except RuntimeError:
                    return

        t = threading.Thread(target=spam)
        t.start()
        barrier.wait()
        assert sched.shutdown(timeout=10.0) is True
        t.join(10)
        assert not t.is_alive()
        assert all(h.done.is_set() for h in accepted)


def test_batch_adapter_submit_shutdown_race_cannot_orphan():
    """submit's closed-check and outstanding-increment are one critical
    section under the adapter lock: a submit racing shutdown(timeout) is
    either counted by the drain or refused, so drained=True means every
    accepted trial completed."""
    _race(lambda: BatchToAsyncAdapter(SerialScheduler()),
          lambda a, p: a.submit(trial, p), rounds=25)


def test_task_queue_submit_shutdown_race_cannot_orphan():
    """Same contract for TaskQueueScheduler: the drain check and the
    outstanding increment share the completion cv."""
    _race(lambda: TaskQueueScheduler(n_workers=2),
          lambda s, p: s.submit(trial, p), rounds=10)


# --------------------------------------------------------------------------- #
# process pool
# --------------------------------------------------------------------------- #
def test_process_scheduler_drops_failures_in_spawned_workers():
    """One pool per batch, workers spawned (not forked); a raising trial
    is dropped and the rest come back.  Through the async adapter the
    trial still reaches a worker (the adapter's cached wrapper pickles as
    the trial fn; the JAX package's could not be pickled, so there it came
    back as a failed handle)."""
    sched = ProcessScheduler(n_workers=2, timeout=60.0)
    batch = [{"x": v} for v in (0.1, 0.9, 0.5)]
    evals, params = sched.make_objective(flaky_trial)(batch)
    assert sorted(p["x"] for p in params) == [0.1, 0.5]
    assert sorted(evals) == sorted(trial(p) for p in params)
    adapter = as_async(sched)
    h = adapter.submit(flaky_trial, batch[0])
    assert h.done.wait(60)
    assert h.error is None and h.result == trial(batch[0])
    assert adapter.shutdown(timeout=10.0) is True


@pytest.mark.cuda
def test_cuda_process_scheduler_trial_runs_on_the_card():
    """The tuner's process already holds a CUDA context; spawned workers
    still run their trials on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.zeros(1, device="cuda")          # this process holds a context
    res = Tuner(SPACE, card_trial,
                dict(batch_size=2, num_iteration=2, seed=0,
                     mc_samples=200, fit_steps=10,
                     scheduler=ProcessScheduler(n_workers=2))).maximize()
    assert res.n_failed == 0
    assert len(res.objective_values) == 2 + 2 * 2
    assert res.objective_values == pytest.approx(
        [trial(p) for p in res.params_tried], rel=1e-12)


# --------------------------------------------------------------------------- #
# signatures against the JAX package (only the documented differences)
# --------------------------------------------------------------------------- #
_DROPPED = {"use_pallas", "pallas_interpret"}


def _params(fn):
    return [(p.name, p.default, p.kind)
            for p in inspect.signature(fn).parameters.values()]


def test_tuner_defaults_match_repro():
    from repro.core import tuner as jtuner
    want = {k: v for k, v in jtuner.DEFAULTS.items() if k not in _DROPPED}
    got = dict(tuner_mod.DEFAULTS)
    assert got.pop("device") is None
    assert list(got.items()) == list(want.items())


def test_async_tuner_signature_matches_repro():
    """The reference's parameters in the reference's order (poll_interval
    9th), less the Pallas switches, plus ``device`` last."""
    from repro.core.async_tuner import AsyncTuner as JAsyncTuner
    want = [p for p in _params(JAsyncTuner.__init__) if p[0] not in _DROPPED]
    got = _params(AsyncTuner.__init__)
    assert got[-1][:2] == ("device", None)
    assert got[:-1] == want
    assert got[9][:2] == ("poll_interval", 0.01)   # self, then 9th


def test_as_async_and_adapter_shutdown_signatures_match_repro():
    from repro.scheduler import base as jbase
    from repro_torch.scheduler import base
    assert _params(base.as_async) == _params(jbase.as_async)
    assert _params(base.BatchToAsyncAdapter.shutdown) == \
        _params(jbase.BatchToAsyncAdapter.shutdown)
    assert _params(base._PollingWaitShim.__init__) == \
        _params(jbase._PollingWaitShim.__init__)
    for name in ("ProcessScheduler", "ThreadScheduler", "SerialScheduler",
                 "TaskQueueScheduler", "ServiceScheduler"):
        import repro.scheduler as J
        import repro_torch.scheduler as P
        assert _params(getattr(P, name).__init__) == \
            _params(getattr(J, name).__init__), name


def test_poll_interval_reaches_the_shim():
    """``as_async(poll=)`` and ``AsyncTuner(poll_interval=)`` set the
    polling period of a submit-only scheduler's shim."""
    class SubmitOnly:
        def submit(self, fn, params):
            return SerialScheduler().as_async().submit(fn, params)

    shim = as_async(SubmitOnly(), poll=0.25)
    assert isinstance(shim, _PollingWaitShim) and shim._poll == 0.25
    at = AsyncTuner(SPACE, trial, SubmitOnly(), 4, 2, 2, 0, None, 0.05,
                    device="cpu")
    assert at.poll == 0.05 and at.sched._poll == 0.05
    assert at.opt.refit_every == 8
    res = at.maximize()
    assert len(res.objective_values) == 4


def test_scheduler_exports_match_repro():
    import repro.scheduler as J
    import repro_torch.scheduler as P
    assert set(P.__all__) == set(J.__all__) | {"assert_holds"}
