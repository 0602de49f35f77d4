"""PyTorch port, the ask path's spans and counters (``core.telemetry``):
one record per ``ask_all`` with its stages nested, the fit's rows against
the rows written back, cache hits, the exits' bytes, the ring's bound,
the recorder off (nothing recorded, picks unchanged), the profiler's
annotations and the ``no_retrace`` audit with the recorder on.  Everything
runs on the CPU."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import collections
import sys

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.analysis import sanitizers
from repro_torch.analysis.sanitizers import no_retrace
from repro_torch.core import telemetry
from repro_torch.core.optimizer import AskTellOptimizer
from repro_torch.core.studybank import StudyBank

SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(0, 1)}
STAGES = {"ask.draw": "ask", "ask.obs": "ask", "ask.obs.gather": "ask.obs",
          "ask.obs.fit": "ask.obs", "ask.obs.factors": "ask.obs",
          "ask.obs.copy": "ask.obs", "ask.pick": "ask",
          "ask.register": "ask"}


def _observe(bank, b, k, rng):
    for _ in range(k):
        x, y = rng.uniform(size=2)
        bank.study(b).observe_params(
            {"x": float(x), "y": float(y)},
            float(-(x - 0.3) ** 2 - (y - 0.5) ** 2))


def _bank(n_obs=(8, 8, 8, 8), seed=0, optimizer="bayesian"):
    bank = StudyBank(SPACE, len(n_obs), optimizer=optimizer, seed=seed,
                     mc_samples=64, fit_steps=3, refit_every=4, device="cpu")
    rng = np.random.default_rng([seed, 7])
    for b, k in enumerate(n_obs):
        _observe(bank, b, k, rng)
    return bank


def _last(bank, k=1):
    return telemetry.records(bank.telemetry_id)[-k:]


@pytest.fixture(autouse=True)
def _recorder_on():
    prev = telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(prev)


@pytest.mark.parametrize("optimizer", ["bayesian", "clustering"])
def test_one_record_per_ask_with_nested_stages(optimizer):
    bank = _bank(n_obs=(4, 4, 4, 4), optimizer=optimizer)
    before = len(telemetry.records(bank.telemetry_id))
    for r in range(3):
        for b, ts in enumerate(bank.ask_all(2)):
            for t in ts:
                bank.tell(b, t.id, float(np.cos(r + b + t.id)))
    recs = telemetry.records(bank.telemetry_id)
    assert len(recs) == before + 3
    assert [r.ask for r in recs[1:]] == [r.ask + 1 for r in recs[:-1]]
    for r in recs:
        names = [s[0] for s in r.spans]
        assert r.root == "ask" and r.spans[0][1] == -1
        assert names.count("ask") == 1
        assert set(names) == {"ask"} | set(STAGES)
        assert [s[4] for s in r.spans if s[0] == "ask.pick"] == [
            "cluster" if optimizer == "clustering" else "gp"]
        for name, parent, t0, t1, _ in r.spans[1:]:
            p = r.spans[parent]
            assert p[0] == STAGES[name]
            assert p[2] <= t0 <= t1 <= p[3]
        # siblings in order, none overlapping
        kids = [s for s in r.spans if s[1] == 0]
        assert all(a[3] <= b[2] for a, b in zip(kids, kids[1:]))
        assert r.counters["na"] == 16 and not r.profiled
        assert r.spans[0][3] - r.spans[0][2] >= sum(s[3] - s[2]
                                                    for s in kids)


def test_fit_rows_against_due_rows():
    """Four studies fit at the bucket shape; two are due and written
    back."""
    bank = _bank()
    bank.ask_all(1)
    first, = _last(bank)
    assert first.counters["fit_rows"] == 4
    assert first.counters["due_rows"] == 4
    _observe(bank, 0, 4, np.random.default_rng(1))
    _observe(bank, 1, 4, np.random.default_rng(2))
    n_fit = bank.ledger.n_fit.copy()
    bank.ask_all(1)
    rec, = _last(bank)
    assert rec.counters["fit_rows"] == 4
    assert rec.counters["due_rows"] == 2
    assert list(bank.ledger.n_fit != n_fit) == [True, True, False, False]


def test_cache_hit_counts_and_runs_no_fit(monkeypatch):
    from repro_torch.core import gp
    bank = _bank()
    bank.ask_all(2)
    fits = []
    fit = gp.BANK_ENTRY_POINTS["fit_hypers_bank"]
    monkeypatch.setitem(gp.BANK_ENTRY_POINTS, "fit_hypers_bank",
                        lambda *a, **k: fits.append(1) or fit(*a, **k))
    bank.ask_all(2)             # nothing told: the stage is cached
    rec, = _last(bank)
    names = [s[0] for s in rec.spans]
    assert rec.counters["obs_cache_hits"] == 1
    assert rec.counters["fit_rows"] == rec.counters["due_rows"] == 0
    assert "ask.obs" in names and "ask.obs.fit" not in names
    assert fits == []


def test_d2h_bytes_are_the_exits_arrays(monkeypatch):
    real = sanitizers.to_host
    seen = []

    def spy(*tensors):
        out = real(*tensors)
        arrays = out if len(tensors) > 1 else (out,)
        seen.append(sum(a.nbytes for a, t in zip(arrays, tensors)
                        if isinstance(t, torch.Tensor)))
        return out

    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("repro_torch")
                and getattr(mod, "to_host", None) is real):
            monkeypatch.setattr(mod, "to_host", spy)
    bank = _bank()
    bank.ask_all(2)
    rec, = _last(bank)
    assert rec.counters["exits"] == len(seen) == 3
    assert rec.counters["d2h_bytes"] == sum(seen)
    B, na, d, n = 4, 16, 2, 2
    # L and L^-1, cond, the hyperparameters, the picks (int64)
    assert sum(seen) == (2 * B * na * na * 4 + B * 4 + B * (d + 2) * 4
                         + B * n * 8)
    assert rec.counters["uploads"] > 0 and rec.counters["h2d_bytes"] > 0


def test_ring_stays_bounded(monkeypatch):
    assert telemetry.RING.maxlen == telemetry.RING_SIZE == 4096
    monkeypatch.setattr(telemetry, "RING", collections.deque(maxlen=3))
    bank = _bank()
    for _ in range(5):
        bank.ask_all(1)
    recs = telemetry.records()
    assert len(recs) == 3
    assert [r.ask for r in recs] == [recs[0].ask, recs[0].ask + 1,
                                     recs[0].ask + 2]


def test_disabled_records_nothing_and_picks_are_identical():
    def drive(bank):
        out = []
        for r in range(4):
            trials = bank.ask_all(2)
            out.append([[t.params for t in ts] for ts in trials])
            for b, ts in enumerate(trials):
                for j, t in enumerate(ts):
                    bank.tell(b, t.id, float(np.sin(7 * r + 3 * b + j)))
        return out

    on = drive(_bank(seed=3))
    n = len(telemetry.RING)
    assert telemetry.set_enabled(False) is True
    last = telemetry.RING[-1] if n else None
    off = drive(_bank(seed=3))
    assert len(telemetry.RING) == n and (not n or telemetry.RING[-1] is last)
    assert off == on


def test_profiler_sees_the_spans_and_is_not_entered_without_one(
        monkeypatch):
    bank = _bank()
    bank.ask_all(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        bank.ask_all(2)
    rec, = _last(bank)
    assert rec.profiled
    keys = {e.key for e in prof.key_averages()}
    assert {"ask", "ask.draw", "ask.obs", "ask.pick",
            "ask.register"} <= keys

    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    bank.ask_all(2)
    rec, = _last(bank)
    assert not rec.profiled and entered == []


def test_no_retrace_holds_with_the_recorder_on():
    bank = _bank(n_obs=(6, 7, 8, 9))
    with no_retrace(raise_on_violation=False) as rep:
        bank.ask_all(2)
    first, = _last(bank)
    assert first.counters["new_signatures"] == sum(
        v for k, v in rep.deltas.items() if not k.startswith("build:"))
    rng = np.random.default_rng(5)
    for b in range(4):
        _observe(bank, b, 1, rng)
    with no_retrace():
        bank.ask_all(2)
    rec, = _last(bank)
    assert rec.counters["new_signatures"] == 0
    assert rec.counters["builds"] == 0
    assert rec.counters["entry_calls"] >= 4


def test_view_ask_and_summary():
    opt = AskTellOptimizer(SPACE, optimizer="bayesian", seed=1,
                           mc_samples=64, fit_steps=3, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):
        for t in opt.ask(1):
            opt.tell(t.id, float(rng.normal()))
    bank = opt._engine()
    recs = telemetry.records(bank.telemetry_id)
    assert recs and all(r.root == "ask_view" for r in recs)
    assert {s[0] for s in recs[-1].spans} >= {"ask_view", "ask.obs",
                                              "ask.pick", "ask.register"}
    s = telemetry.summary(bank.telemetry_id)
    assert s["asks"] == len(recs)
    assert s["spans"]["ask_view"]["n"] == len(recs)
    assert 0 <= s["spans"]["ask.pick"]["median_ms"] <= \
        s["spans"]["ask.pick"]["p90_ms"]
    assert s["counters"]["na"] == 16.0
    assert telemetry.summary(bank.telemetry_id, last=0)["asks"] == 0


def test_a_failed_ask_leaves_no_record_and_the_next_one_records(
        monkeypatch):
    bank = _bank()
    bank.ask_all(1)
    n = len(telemetry.records(bank.telemetry_id))

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(bank, "_pick_gp", boom)
    with pytest.raises(RuntimeError, match="boom"):
        bank.ask_all(1)
    monkeypatch.undo()
    assert len(telemetry.records(bank.telemetry_id)) == n
    assert getattr(sanitizers._TALLY, "t", None) is None
    bank.ask_all(1)
    rec, = _last(bank)
    assert rec.root == "ask" and len(telemetry.records(
        bank.telemetry_id)) == n + 1


@pytest.mark.parametrize("on", [True, False])
def test_crossings_are_counted_only_inside_a_recorded_ask(on, monkeypatch):
    """The crossing tally runs while a recorded ask does: outside an ask,
    and in every ask while the recorder is off, nothing is counted."""
    bank = _bank()
    telemetry.set_enabled(on)
    seen = []
    real_start = sanitizers.start_tally

    def start():
        t = real_start()
        seen.append(t)
        return t

    monkeypatch.setattr(sanitizers, "start_tally", start)
    bank.ask_all(1)
    assert getattr(sanitizers._TALLY, "t", None) is None
    sanitizers.to_host(torch.zeros(3))
    sanitizers.to_device(np.zeros(3), "cpu")
    if on:
        t, = seen
        assert t.exits == _last(bank)[0].counters["exits"] == 3
    else:
        assert seen == []
