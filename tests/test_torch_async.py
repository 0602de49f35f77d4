"""PyTorch port, the async driver and the submit/wait_any half of the
scheduler protocol: ``AsyncTuner`` with TPE replays the JAX package's
trials and its own proposals across a kill, and the adapters that make any
batch scheduler submittable keep their fault and coalescing contracts."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import gc
import threading
import time

import numpy as np
import pytest
from scipy.stats import uniform

from repro_torch.core import AsyncTuner, TunerResults
from repro_torch.scheduler import (BatchToAsyncAdapter, SerialScheduler,
                                   TaskHandle, ThreadScheduler, as_async)
from repro_torch.scheduler.base import _PollingWaitShim

SPACE = {"x": uniform(0, 1), "y": uniform(0, 1)}
FAST = dict(mc_samples=500, fit_steps=10, device="cpu")


def quad(p):
    return -(p["x"] - 0.7) ** 2 - (p["y"] - 0.2) ** 2


class InlineScheduler:
    """Deterministic async scheduler: trials complete synchronously inside
    ``submit``, and ``wait_any`` hands back one completion at a time in
    dispatch order, so the async loop is a reproducible sequence."""

    def __init__(self, handle_cls=TaskHandle):
        self.handle_cls = handle_cls

    def submit(self, fn, params):
        h = self.handle_cls(params)
        try:
            h.result = float(fn(params))
        except Exception as e:  # noqa: BLE001
            h.error = e
        h.done.set()
        return h

    def wait_any(self, handles, timeout=None):
        return [h for h in handles if h.done.is_set()][:1]


TPE_KW = dict(optimizer="tpe", num_evals=10, batch_size=2, initial_random=2,
              seed=7, strategy_kwargs={"pending_penalty": True})


@pytest.mark.parametrize("optimizer", ["tpe", "random",
                                       "hallucination_ref"])
def test_async_tuner_matches_repro(optimizer):
    """Same seed, same inline scheduler: the port's async run tries the JAX
    package's configs in the same order (TPE with in-flight trials in the
    bad split; the reference GP-BUCB loop hallucinating them, on the
    factor core, against the JAX package's Pallas kernels in interpret
    mode)."""
    from repro.core import AsyncTuner as JAsyncTuner
    from repro.scheduler.base import TaskHandle as JTaskHandle

    kw = dict(TPE_KW, optimizer=optimizer, mc_samples=500, fit_steps=10)
    if optimizer != "tpe":
        kw.pop("strategy_kwargs")
    if optimizer == "hallucination_ref":   # the trial in flight absorbed
        kw["strategy_kwargs"] = {"scorer": "kinv_pallas"}
    want = JAsyncTuner(SPACE, quad, InlineScheduler(JTaskHandle),
                       **kw).maximize()
    got = AsyncTuner(SPACE, quad, InlineScheduler(), device="cpu",
                     **kw).maximize()
    assert isinstance(got, TunerResults)
    assert got.params_tried == want.params_tried
    assert got.objective_values == want.objective_values
    assert got.best_trace == want.best_trace


def test_tpe_async_kill_resume_replays_proposals(tmp_path):
    """In-flight TPE trials are serialized in the ledger and re-dispatched
    on resume; the remaining proposals replay bit for bit."""
    kw = dict(TPE_KW, **FAST)
    full = AsyncTuner(SPACE, quad, InlineScheduler(), **kw).maximize()
    ckpt = tmp_path / "tpe_async.json"
    stopped = AsyncTuner(SPACE, quad, InlineScheduler(),
                         checkpoint_path=str(ckpt),
                         early_stopping=lambda r: r.iterations >= 5,
                         **kw).maximize()
    assert stopped.iterations == 5
    assert AsyncTuner(SPACE, quad, InlineScheduler(),
                      checkpoint_path=str(ckpt), **kw).opt.pending_trials()
    resumed = AsyncTuner(SPACE, quad, InlineScheduler(),
                         checkpoint_path=str(ckpt), **kw).maximize()
    assert resumed.params_tried == full.params_tried
    assert resumed.objective_values == full.objective_values


def test_async_gp_tuner_through_thread_adapter_tells_failures():
    """GP-BUCB through a thread-pool batch scheduler viewed as async: every
    trial ends observed or failed, and failures never reach the model."""
    def trial(p):
        if p["x"] > 0.9:
            raise RuntimeError("worker lost")
        return quad(p)

    res = AsyncTuner(SPACE, trial, ThreadScheduler(n_workers=3),
                     num_evals=12, batch_size=3, seed=1, **FAST).maximize()
    assert len(res.params_tried) + res.n_failed == 12
    assert all(np.isfinite(res.objective_values))
    assert res.best_objective == max(res.objective_values)


def test_async_tuner_minimizes_and_defaults_to_cuda():
    res = AsyncTuner(SPACE, lambda p: -quad(p), InlineScheduler(),
                     optimizer="tpe", num_evals=8, batch_size=2,
                     seed=3, **FAST).minimize()
    assert res.best_objective == min(res.objective_values)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncTuner(SPACE, quad, InlineScheduler())


# ------------------------------------------------------------ adapters
def test_as_async_picks_the_right_view():
    native = InlineScheduler()
    assert as_async(native) is native

    class SubmitOnly:
        def submit(self, fn, params):
            return native.submit(fn, params)

    shim = as_async(SubmitOnly())
    assert isinstance(shim, _PollingWaitShim)
    h = shim.submit(quad, {"x": 0.7, "y": 0.2})
    assert shim.wait_any([h], timeout=1.0) == [h] and h.result == 0.0
    assert shim.wait_any([], timeout=1.0) == []
    assert isinstance(as_async(SerialScheduler()), BatchToAsyncAdapter)
    with pytest.raises(TypeError, match="neither"):
        as_async(object())


def test_polling_shim_times_out_on_a_pending_handle():
    h = TaskHandle({"x": 0.0})

    class Never:
        def submit(self, fn, params):
            return h

    shim = as_async(Never())
    t0 = time.monotonic()
    assert shim.wait_any([shim.submit(quad, {})], timeout=0.05) == []
    assert time.monotonic() - t0 >= 0.05


def test_adapter_drops_failed_trials_as_failed_handles():
    def flaky(p):
        if p["x"] > 0.5:
            raise RuntimeError("boom")
        return quad(p)

    adapter = SerialScheduler().as_async()
    ok = adapter.submit(flaky, {"x": 0.1, "y": 0.0})
    bad = adapter.submit(flaky, {"x": 0.9, "y": 0.0})
    for h in (ok, bad):
        assert h.done.wait(10)
    assert ok.error is None and ok.result == pytest.approx(
        quad({"x": 0.1, "y": 0.0}))
    assert bad.result is None and isinstance(bad.error, RuntimeError)


def test_adapter_objective_cache_is_weak_and_per_object():
    """The objective cache keys on the fn object, weakly: a collected fn
    leaves no entry, and a new fn never inherits a stale objective."""
    class CountingScheduler(SerialScheduler):
        def __init__(self):
            self.built = []

        def make_objective(self, trial_fn):
            self.built.append(trial_fn)
            return super().make_objective(trial_fn)

    sched = CountingScheduler()
    adapter = BatchToAsyncAdapter(sched)

    def make_fn(c):
        def fn(p):
            return c
        return fn

    f1 = make_fn(1.0)
    obj1 = adapter._objective_for(f1)[0]
    assert adapter._objective_for(f1)[0] is obj1
    assert len(sched.built) == 1
    del f1
    gc.collect()
    assert len(adapter._objectives) == 0
    f2 = make_fn(2.0)
    obj2 = adapter._objective_for(f2)[0]
    assert obj2 is not obj1 and len(sched.built) == 2
    assert obj2([{"x": 0.0}])[0] == [2.0]


def test_adapter_pins_wrapped_fn_for_equal_bound_methods():
    class Trialer:
        def trial(self, p):
            return float(p["x"])

    t = Trialer()
    adapter = BatchToAsyncAdapter(SerialScheduler())
    m1, m2 = t.trial, t.trial
    obj1, _ = adapter._objective_for(m1)
    obj2, pin2 = adapter._objective_for(m2)
    assert obj2 is obj1 and pin2 is m1
    handles = [adapter.submit(t.trial, {"x": float(i)}) for i in range(4)]
    gc.collect()
    while not all(h.done.is_set() for h in handles):
        adapter.wait_any(handles, timeout=5.0)
    assert sorted(h.result for h in handles) == [0.0, 1.0, 2.0, 3.0]


class _GatedScheduler(SerialScheduler):
    """Counts objective calls; the first blocks until released."""

    def __init__(self):
        self.dispatches = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def make_objective(self, trial_fn):
        inner = super().make_objective(trial_fn)

        def objective(params_list):
            self.dispatches.append(len(params_list))
            if len(self.dispatches) == 1:
                self.entered.set()
                self.release.wait(10)
            return inner(params_list)

        return objective


def _one(p):
    return -(p["x"] - 0.5) ** 2


@pytest.mark.parametrize("coalesce", [True, False])
def test_adapter_coalesces_queued_submits_only_when_asked(coalesce):
    """Coalescing: submits queued behind a dispatch in flight ride one
    later objective call (8 submits, 2 dispatches).  Default: one
    dispatch per trial."""
    sched = _GatedScheduler()
    if not coalesce:
        sched.release.set()
    adapter = sched.as_async(coalesce=coalesce)
    h0 = adapter.submit(_one, {"x": 0.125})
    assert sched.entered.wait(10)
    later = [adapter.submit(_one, {"x": i / 16.0}) for i in range(1, 8)]
    sched.release.set()
    for h in [h0] + later:
        assert h.done.wait(10) and h.error is None
        assert h.result == pytest.approx(_one(h.params))
    want = [1, 7] if coalesce else [1] * 8
    assert sorted(sched.dispatches) == sorted(want)


def test_coalescing_adapter_keeps_fault_semantics():
    sched = _GatedScheduler()

    def flaky(p):
        if p["x"] > 0.5:
            raise RuntimeError("boom")
        return _one(p)

    adapter = sched.as_async(coalesce=True)
    first = adapter.submit(flaky, {"x": 0.1})
    assert sched.entered.wait(10)
    ok = adapter.submit(flaky, {"x": 0.2})
    bad = adapter.submit(flaky, {"x": 0.9})
    sched.release.set()
    for h in (first, ok, bad):
        assert h.done.wait(10)
    assert first.error is None and ok.error is None
    assert bad.result is None and isinstance(bad.error, RuntimeError)
