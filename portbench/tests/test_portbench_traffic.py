"""The traffic generator's invariants (a stationary bucket, the fit phases
of each mix, the same sizes for every seed) and the metric arithmetic on
made-up samples."""
import json

import numpy as np
import pytest

from portbench import fleet, harness, peaks, trace

CFG = json.loads((harness.PB / "configs" / "mango-gp-bucb-h6.json")
                 .read_text())


def _traffic(name):
    return json.loads((harness.PB / "traffic" / f"{name}.json").read_text())


def _pow2(n):
    p = 16
    while p < n:
        p *= 2
    return p


def simulate(traffic, B, batch, refit_every, rounds, seed):
    """The fleet's observation counts and fit schedule as ``Fleet`` drives
    them (warm asks included), without the program: per ask the bucket and
    the studies due a refit."""
    sizes = fleet.start_sizes(traffic, B, seed)
    lag = fleet.lagging(traffic, B)
    obs = sizes - batch * lag
    n_fit = np.zeros(B, np.int64)
    have = np.zeros(B, bool)
    out = []

    def ask():
        na = _pow2(max(16, int(obs.max()) + 4 + batch))
        due = ~have | (obs - n_fit >= refit_every)
        n_fit[due] = obs[due]
        have[:] = True
        out.append((na, due.copy()))

    ask()
    obs[:] += batch
    obs[lag] += batch
    start = (obs.copy(), n_fit.copy())
    for _ in range(rounds):
        ask()
        obs[:] += batch
        back = obs >= traffic["restore_at"]
        obs[back] = start[0][back]
        n_fit[back] = start[1][back]
    return out


@pytest.mark.parametrize("mix", ["long.staggered", "long.lockstep"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 987654321012])
def test_bucket_is_stationary(mix, seed):
    t = _traffic(mix)
    asks = simulate(t, CFG["n_studies"], CFG["batch_size"],
                    CFG["refit_every"], 400, seed)
    assert {na for na, _ in asks} == {1024}


def test_staggered_mix_refits_every_ask():
    asks = simulate(_traffic("long.staggered"), CFG["n_studies"],
                    CFG["batch_size"], CFG["refit_every"], 400, 5)
    counts = [int(d.sum()) for _, d in asks[1:]]
    assert min(counts) >= 1
    assert 8 <= np.mean(counts) <= 24


def test_lockstep_mix_refits_every_second_ask():
    asks = simulate(_traffic("long.lockstep"), CFG["n_studies"],
                    CFG["batch_size"], CFG["refit_every"], 400, 5)
    counts = [int(d.sum()) for _, d in asks[1:]]
    assert counts[0::2] == [0] * len(counts[0::2])
    assert counts[1::2] == [CFG["n_studies"]] * len(counts[1::2])


def test_every_seed_gets_the_same_sizes():
    t = _traffic("long.staggered")
    a = fleet.start_sizes(t, 32, 1)
    b = fleet.start_sizes(t, 32, 2 ** 33 + 5)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() == 760 and a.max() == 1000 and not (a % 8).any()
    assert fleet.lagging(t, 32).sum() == 16


def test_objective_matches_the_published_maximum():
    h6 = harness.load_module(harness.PB / "objectives" / "neg_hartmann6.py")
    x_star = np.array([0.20169, 0.150011, 0.476874, 0.275332, 0.311652,
                       0.6573])
    assert abs(h6.evaluate(x_star) - 3.32237) < 1e-4
    X = np.random.default_rng(0).uniform(size=(5, 3, 6))
    assert h6.evaluate(X).shape == (5, 3)


def test_percentile_and_rate_readers():
    ctx = {"asks": [{"ms": float(v)} for v in range(1, 101)], "told": 640,
           "window_s": 32.0, "setup_s": 12.5}
    assert harness.reader("ask_p90_ms")(ctx) == pytest.approx(90.1)
    assert harness.reader("trials_per_s")(ctx) == pytest.approx(20.0)
    assert harness.reader("setup_s")(ctx) == 12.5


def test_busy_time_counts_overlaps_once():
    ev = [trace.Event("k1", 0.0, 1.0), trace.Event("k2", 0.5, 1.5),
          trace.Event("k3", 3.0, 4.0)]
    assert trace.busy_s(ev) == pytest.approx(2.5)
    assert trace.kernel_count(ev + [trace.Event("Memcpy HtoD", 5, 6)]) == 3
    assert trace.kernel_time(ev, "k1") == pytest.approx(1.0)


def test_idle_gaps_go_to_the_innermost_annotation():
    dev = [trace.Event("k", 0.0, 1.0), trace.Event("k", 2.0, 3.0),
           trace.Event("k", 6.0, 7.0)]
    host = [trace.Event("pb:ask_all", 0.0, 3.5),
            trace.Event("pb:draw.sample_columns", 1.0, 2.0),
            trace.Event("pb:evaluate_tell", 4.0, 6.0)]
    gaps = dict(trace.idle_gaps(dev, host, 0.0, 8.0))
    assert gaps["pb:draw.sample_columns"] == pytest.approx(1.0)
    assert gaps["pb:evaluate_tell"] == pytest.approx(3.0)
    assert gaps["pb:outside"] == pytest.approx(1.0)


def test_roofline_reader_on_a_made_up_profile():
    cfg = harness.bank_config(CFG)
    k = np.full(32, 900)
    bound = peaks.score_cov_s(k, cfg["mc_samples"], cfg["dim"])
    prof = {"dev": [trace.Event("void score_cov_streamed<...>", 0.0,
                                4 * bound)],
            "asks": [{"k_obs": k}, {"k_obs": k}], "window_s": 1.0,
            "busy_s": 0.25}
    ctx = {"cfg": cfg, "profile": prof}
    assert harness.reader("score_cov_roofline")(ctx) == pytest.approx(50.0)
    assert harness.reader("var_downdate_roofline")(ctx) is None
    assert harness.reader("device_idle_pct")(ctx) == pytest.approx(75.0)
    assert harness.reader("launches_per_ask")(ctx) == pytest.approx(0.5)


def test_whole_ask_share_is_a_share():
    cfg = harness.bank_config(CFG)
    k = np.full(32, 900)
    due = np.arange(32) % 2 == 0
    a = {"k_obs": k, "due": due, "round": 0}
    t = harness.reader("ask_mfu_pct").__globals__["ask_bound_s"](a, cfg)
    fit = peaks.fit_s(k[due], cfg["fit_steps"], cfg["dim"])
    assert fit < t < 1.0
    ctx = {"cfg": cfg, "asks": [dict(a, ms=1e3 * t * 4)], "profile": None}
    assert harness.reader("ask_mfu_pct")(ctx) == pytest.approx(25.0)


def test_bounds_grow_with_the_work():
    assert peaks.score_cov_s([1000], 16800, 6) > peaks.score_cov_s(
        [500], 16800, 6)
    assert peaks.var_downdate_s([900], 16800, 6) == pytest.approx(
        4 * (16800 * 900 + 16800 * 6 + 4 * 16800 + 906)
        / peaks.PEAK_BYTES)
    n = 900
    assert peaks.fit_s([n], 40, 6) == pytest.approx(
        40 * (n * n * 20 + n ** 3 + 2 * n * n * 8) / peaks.PEAK_FP32)
