"""PyTorch port, the Tuner driver on the CPU: its random phase matches
``repro.Tuner`` bitwise, its checkpoint resume is exact, and it runs the
GP-BUCB path through both local schedulers."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import math
import threading

import numpy as np
import pytest
from scipy.stats import uniform

from repro.core import Tuner as JTuner
from repro_torch.core import Tuner
from repro_torch.scheduler import SerialScheduler, ThreadScheduler, base

SPACE = {"x1": uniform(-5, 15), "x2": range(0, 16), "mode": ["low", "high"]}


def branin(p):
    x1, x2 = p["x1"], float(p["x2"])
    b, c, t = 5.1 / (4 * math.pi ** 2), 5 / math.pi, 1 / (8 * math.pi)
    v = (x2 - b * x1 ** 2 + c * x1 - 6.0) ** 2 + 10 * (1 - t) * np.cos(x1) + 10
    return float(v + (12.0 if p["mode"] == "high" else 0.0))


def batch_objective(params_list):
    return [branin(p) for p in params_list], list(params_list)


FAST = dict(mc_samples=300, fit_steps=10, seed=5)


@pytest.mark.parametrize("opt,iters", [("random", 6), ("bayesian", 0)])
def test_random_phase_matches_repro_bitwise(opt, iters):
    """The initial random batch (and every random-strategy batch) is a host
    draw: the same configs and values as the JAX package."""
    conf = dict(FAST, optimizer=opt, batch_size=3, num_iteration=iters,
                initial_random=4)
    want = JTuner(SPACE, batch_objective, dict(conf)).minimize()
    got = Tuner(SPACE, batch_objective, dict(conf, device="cpu")).minimize()
    assert got.params_tried == want.params_tried
    assert got.objective_values == want.objective_values
    assert got.best_trace == want.best_trace


def test_checkpoint_resume_is_exact(tmp_path):
    """A run stopped after 3 iterations and resumed to 6 tries exactly the
    configs of an uninterrupted 6-iteration run."""
    conf = dict(FAST, batch_size=2, device="cpu")
    full = Tuner(SPACE, batch_objective,
                 dict(conf, num_iteration=6)).minimize()
    path = tmp_path / "ckpt.json"
    Tuner(SPACE, batch_objective,
          dict(conf, num_iteration=3, checkpoint_path=str(path))).minimize()
    resumed = Tuner(SPACE, batch_objective,
                    dict(conf, num_iteration=6,
                         checkpoint_path=str(path))).minimize()
    assert resumed.params_tried == full.params_tried
    assert resumed.iterations == 6


@pytest.mark.parametrize("sched", [SerialScheduler(),
                                   ThreadScheduler(n_workers=3)])
def test_gp_tuner_through_schedulers(sched):
    """GP-BUCB asks through a per-trial scheduler; failed trials are told
    failed and never observed."""
    def trial(p):
        if p["mode"] == "high" and p["x2"] == 0:
            raise RuntimeError("worker lost")
        return branin(p)

    res = Tuner(SPACE, trial, dict(FAST, batch_size=3, num_iteration=5,
                                   scheduler=sched, device="cpu")).minimize()
    assert len(res.params_tried) + res.n_failed == 2 + 3 * 5
    assert all(math.isfinite(v) for v in res.objective_values)
    assert res.best_objective == min(res.objective_values)
    assert len(res.best_trace) == 5


@pytest.mark.parametrize("debug", [False, True])
def test_assert_holds_checks_ownership_only_in_debug_mode(monkeypatch, debug):
    """``assert_holds`` passes a held lock; an unheld one raises only when
    lock checks are on (``REPRO_DEBUG_LOCKS``)."""
    from repro_torch.analysis import sanitizers
    monkeypatch.setattr(sanitizers, "_DEBUG_LOCKS", debug)
    cv = threading.Condition()
    with cv:
        base.assert_holds(cv)
    if debug:
        with pytest.raises(AssertionError, match="not held"):
            base.assert_holds(cv)
    else:
        base.assert_holds(cv)


def test_config_validation():
    with pytest.raises(ValueError, match="unknown Tuner config"):
        Tuner(SPACE, batch_objective, {"use_pallas": True, "device": "cpu"})
