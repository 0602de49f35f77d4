"""Native-valued histories and tells, and the candidate check on columns
with atoms.

The Hartmann-6 cells run through the value-agnostic fleet and the
discrete-aware ``candidate_ks`` exactly as through the float-only code it
replaced (frozen copies below); the test objective ``mixed_kinds``, with
every kind of parameter of the port's spaces, runs end to end on the CPU
for GP-BUCB and clustering, holds a sound draw under the limit, and its
discrete faults fail the check."""
import json
import math

import numpy as np
import pytest
import torch

from portbench import faults, fleet, harness, reference
from portbench_tiny import MIXED, tiny_files, tiny_run

H6 = harness.load_module(harness.PB / "objectives" / "neg_hartmann6.py")
MK = harness.load_module(harness.PB / "objectives" / "mixed_kinds.py")
H6_CELLS = ("gp_bucb.long.staggered", "clustering.long.staggered",
            "gp_bucb.long.lockstep", "tpe.h6.long")
DISCRETE_FAULTS = ("categorical_short", "onehot_shifted",
                   "ordinal_log_scale")


# ------------------------------------------- the float-only code, frozen
def frozen_histories(n_studies, length, seed, objective):
    rng = np.random.default_rng([seed, 2])
    X = rng.uniform(size=(n_studies, length, objective.DIM))
    return X, objective.evaluate(X)


def frozen_study_state(X, y, study_seed, names):
    trials = [{"id": i, "params": dict(zip(names, map(float, row))),
               "status": "observed", "value": float(v), "obs_seq": i}
              for i, (row, v) in enumerate(zip(X, y))]
    return {"version": 1, "next_id": len(trials), "ask_count": 0,
            "n_failed": 0, "sign": 1.0, "best_trace": [], "trials": trials,
            "rng_state": np.random.default_rng(study_seed).bit_generator.state,
            "gp": None}


def frozen_tell(self, trials):
    names = self.objective.NAMES
    rows = np.array([[[t.params[k] for k in names] for t in ts]
                     for ts in trials], np.float64)
    vals = self.objective.evaluate(rows)
    enc = self.objective.encode(rows)
    for b, ts in enumerate(trials):
        for j, t in enumerate(ts):
            self.bank.tell(b, t.id, float(vals[b, j]))
        self.records[b].append(enc[b], vals[b])
        self.n_obs[b] += len(ts)
    return int(rows.shape[0] * rows.shape[1])


def frozen_warm(self):
    self.tell(self.ask())
    for b in np.nonzero(self.lag)[0]:
        b = int(b)
        n = int(self.sizes[b])
        X = self.hist_X[b, n - self.batch:n]
        y = self.hist_y[b, n - self.batch:n]
        v = self.bank.study(b)
        for row, val in zip(X, y):
            v.observe_params(dict(zip(self.objective.NAMES,
                                      map(float, row))), float(val))
        self.records[b].append(self.objective.encode(X), y)
        self.n_obs[b] += self.batch
    self.starts = [v.state_dict() for v in self.bank.studies]
    self.start_records = [fleet.Record(r.X.copy(), r.y.copy(), r.n)
                          for r in self.records]
    self.tell(self.ask())


def frozen_pick_rows(trials, objective):
    return objective.encode(np.array(
        [[[t.params[k] for k in objective.NAMES] for t in ts]
         for ts in trials], np.float64))


def frozen_candidate_ks(C, cdf):
    x = torch.sort(cdf(C.to(torch.float64)), dim=1).values
    S = x.shape[1]
    i = torch.arange(1, S + 1, dtype=torch.float64, device=x.device)
    above = (i / S)[None, :, None] - x
    below = x - ((i - 1) / S)[None, :, None]
    return math.sqrt(S) * torch.maximum(above.amax(1), below.amax(1))


# ------------------------------------------------ the Hartmann-6 cells
def _drive(cell, seed, frozen, monkeypatch, rounds=3):
    """A tiny fleet of ``cell`` loaded, warmed and driven ``rounds`` asks,
    through the frozen code or the current; returns it and each ask's
    trials."""
    with monkeypatch.context() as m:
        if frozen:
            m.setattr(fleet, "histories", frozen_histories)
            m.setattr(fleet, "study_state", frozen_study_state)
            m.setattr(fleet.Fleet, "tell", frozen_tell)
            m.setattr(fleet.Fleet, "warm", frozen_warm)
        files = tiny_files(cell)
        cfg = harness.bank_config(files["config"])
        bank = harness.make_bank(cfg, H6, seed, "cpu")
        fl = fleet.Fleet(bank, files["traffic"], cfg["batch_size"], seed,
                         H6)
        fl.load(seed + 1)
        fl.warm()
        asked = []
        for _ in range(rounds):
            trials = fl.ask()
            asked.append(trials)
            fl.tell(trials)
            fl.restore_due()
    return fl, asked


@pytest.mark.parametrize("cell", H6_CELLS)
def test_h6_histories_records_and_picks_are_bit_identical(cell,
                                                          monkeypatch):
    seed = 2 ** 31 + 41
    X, y = fleet.histories(4, 40, seed, H6)
    X0, y0 = frozen_histories(4, 40, seed, H6)
    assert X.dtype == X0.dtype and np.array_equal(X, X0)
    assert np.array_equal(y, y0)
    assert fleet.study_state(X[1], y[1], 7, H6.NAMES) == \
        frozen_study_state(X0[1], y0[1], 7, H6.NAMES)
    new, asked = _drive(cell, seed, False, monkeypatch)
    old, asked0 = _drive(cell, seed, True, monkeypatch)
    for r, r0 in zip(new.records, old.records):
        assert r.n == r0.n and np.array_equal(r.X, r0.X)
        assert np.array_equal(r.y, r0.y)
    assert np.array_equal(new.n_obs, old.n_obs)
    for trials, trials0 in zip(asked, asked0):
        got = harness.pick_rows(trials, H6)
        assert got.dtype == np.float32
        assert np.array_equal(got, frozen_pick_rows(trials0, H6))


@pytest.mark.parametrize("cell", H6_CELLS)
def test_h6_candidate_ks_readings_are_bit_identical(cell, monkeypatch):
    """On every block a tiny run judges, the discrete-aware statistic
    reads exactly what the float-only one read."""
    files = tiny_files(cell)
    ref = files["reference"]
    real, pairs = ref.candidate_ks, []

    def candidate_ks(C, cdf, cdf_left=None):
        got = real(C, cdf, cdf_left)
        pairs.append((got, frozen_candidate_ks(C, cdf)))
        return got

    monkeypatch.setattr(ref, "candidate_ks", candidate_ks)
    res = tiny_run(cell, seconds=1.0, seed=2 ** 32 + 17)
    assert res["correct"], res["check"]
    assert pairs and all(torch.equal(a, b) for a, b in pairs)


# ------------------------------------------------ every kind of parameter
def _program_space():
    from repro_torch.core.spaces import ParamSpace
    return ParamSpace(MK.space())


def _program_draw(seed, B=2, S=32768):
    """The port's own candidate draw of B studies x S rows, (B, S, DIM)."""
    space = _program_space()
    cols = space.sample_columns(B * S, np.random.default_rng(seed))
    return torch.as_tensor(np.asarray(space.encode_columns(cols, B * S),
                                      np.float32).reshape(B, S, -1))


def test_native_rows_encode_as_the_program_encodes_them():
    """The harness's encoding, written from the port's documented rules,
    gives the program's float32 rows bit for bit; states of native rows
    are JSON-serialisable and keep each value's type."""
    rows = MK.history(np.random.default_rng(3), 2, 300)
    assert MK.DIM == _program_space().dim == 16 and len(MK.NAMES) == 11
    got = MK.encode(rows)
    flat = [fleet.params(r, MK.NAMES) for r in rows.reshape(-1, 11)]
    want = _program_space().encode(flat).astype(np.float32)
    assert got.dtype == np.float32
    assert np.array_equal(got.reshape(-1, MK.DIM), want)
    state = fleet.study_state(rows[0], MK.evaluate(rows[0]), 5, MK.NAMES)
    back = json.loads(json.dumps(state))
    assert back["trials"] == state["trials"]
    p = state["trials"][0]["params"]
    assert type(p["optimizer"]) is str and type(p["augment"]) is bool
    assert type(p["units"]) is int and type(p["dropout"]) is float
    assert p["epochs"] == 200 and p["schedule"]["_choice"] in (
        "cosine", "step")


@pytest.mark.parametrize("cell", sorted(MIXED))
def test_a_sound_mixed_run_is_correct(cell):
    res = tiny_run(cell, seconds=1.5)
    assert res["correct"], res["check"]
    assert res["check"]["missing_picks"]["value"] == 0
    assert res["readings"]["candidate_ks"]["n"] >= 4 * MK.DIM


@pytest.mark.parametrize("seed", range(10))
def test_discrete_candidate_ks_holds_a_sound_draw(seed):
    """The port's draw at the cells' 32,768 candidates, two studies:
    every column of the mixed space under the limit of 6.0."""
    C = _program_draw(2 ** 31 + seed)
    ks = reference.candidate_ks(C, MK.candidate_cdf, MK.candidate_cdf_left)
    assert ks.shape == (2, MK.DIM)
    assert float(ks.max()) < 6.0


def test_the_continuous_statistic_misreads_a_one_hot_column():
    """F(x) on both sides reads a one-hot column's tie as a gap near
    sqrt(S) (1 - 1/k): the reason the check takes F(x-) below a point."""
    C = _program_draw(2 ** 31 + 99)
    onehot = MK.SPACE.columns_of("optimizer")
    ks = frozen_candidate_ks(C, MK.candidate_cdf)[:, onehot]
    assert float(ks.min()) > 0.5 * math.sqrt(C.shape[1]) * (1 - 1 / 3)


def _brute_ks(x: np.ndarray, F, F_left) -> float:
    """sup |F_n - F| of a sample x, at every sample value and just left of
    it."""
    x = np.sort(x)
    v = np.unique(x)
    S = len(x)
    Fn = np.searchsorted(x, v, side="right") / S
    Fn_left = np.searchsorted(x, v, side="left") / S
    return float(max(np.abs(Fn - F(v)).max(),
                     np.abs(Fn_left - F_left(v)).max()))


def test_discrete_candidate_ks_is_the_exact_distance():
    """Against sup |F_n - F| found point by point, on every column of a
    small draw (atoms, continuous parts, and a Choice's imputed child)."""
    C = _program_draw(2 ** 31 + 5, B=1, S=500)
    ks = reference.candidate_ks(C, MK.candidate_cdf, MK.candidate_cdf_left)
    for j in range(MK.DIM):
        def col(fn):
            def F(v):
                block = torch.zeros((1, len(v), MK.DIM), dtype=torch.float64)
                block[0, :, j] = torch.as_tensor(v)
                return fn(block)[0, :, j].numpy()
            return F
        want = _brute_ks(C[0, :, j].double().numpy(), col(MK.candidate_cdf),
                         col(MK.candidate_cdf_left))
        assert float(ks[0, j]) / math.sqrt(500) == pytest.approx(
            want, abs=1e-12)


@pytest.fixture
def program(monkeypatch):
    from repro_torch.core import gp
    monkeypatch.setattr(gp, "BANK_ENTRY_POINTS", dict(gp.BANK_ENTRY_POINTS))
    return monkeypatch


@pytest.mark.parametrize("cell", sorted(MIXED))
@pytest.mark.parametrize("fault", DISCRETE_FAULTS)
def test_a_discrete_fault_fails_the_candidate_check(cell, fault, program):
    files = tiny_files(cell)
    assert faults.breaks(fault, files["config"]["optimizer"],
                         files["objective"].space())
    faults.plant(fault, program.setattr)
    res = tiny_run(cell, seconds=1.5)
    assert not res["correct"], res["check"]
    c = res["check"]
    assert (c["candidate_ks"]["value"] > c["candidate_ks"]["limit"]
            or c["candidate_faults"]["value"] > 0), c
