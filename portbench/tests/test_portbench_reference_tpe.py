"""The plain TPE reference against the port's numpy oracle and its TPE ask
on the CPU at a tiny fleet, the control (bfloat16 exponents) against
both, the TPE bound and its readers, and the judge's numbers of the GP
cells held to the formula they had before the TPE numbers joined them."""
import math

import numpy as np
import pytest
import torch

from portbench import harness, peaks, reference_tpe, trace
from portbench_tiny import load_bench, tiny_run

H6 = harness.load_module(harness.PB / "objectives" / "neg_hartmann6.py")


@pytest.mark.parametrize("seed", range(4))
def test_reference_picks_are_the_ports_oracle(seed):
    """``TPEStrategy.propose_host`` (the port's numpy oracle, float32) and
    the float64 reference pick the same candidates where the reference
    sees no near-tie among its best, and each oracle pick lies within
    float32 rounding of the reference's pick of its slot."""
    from repro_torch.core.tpe import TPEStrategy
    rng = np.random.default_rng(seed)
    n = [40, 200, 760, 1012][seed]
    X = rng.uniform(size=(n, 6)).astype(np.float32)
    y = H6.evaluate(X.astype(np.float64))
    C = rng.uniform(size=(3000, 6)).astype(np.float32)
    oracle = TPEStrategy(6, 1e12, gamma=0.25).propose_host(X, y, C, 4)
    ref = reference_tpe.scores(torch.as_tensor(C), X, y, 0.25)
    gaps = reference_tpe.pick_gaps(ref, np.array(oracle))
    assert np.abs(gaps).max() < 1e-4
    best = torch.sort(ref, descending=True).values[:5]
    if float((best[:-1] - best[1:]).min()) > 1e-3:
        assert oracle == reference_tpe.top(ref, 4).tolist()


def test_split_and_bandwidth_follow_the_rule():
    y = np.array([3.0, 1.0, 2.0, 2.0, 0.5])
    # ceil(0.25 * 5) = 2 best: 3.0 and the earlier of the tied 2.0s
    assert reference_tpe.split(y, 0.25).tolist() == [True, False, True,
                                                      False, False]
    assert reference_tpe.split(y[:1], 0.25).tolist() == [True]
    P = torch.tensor([[0.0, 0.5], [1.0, 0.5]], dtype=torch.float64)
    base = 2 ** (-1 / 6) * 0.5 + 1e-3
    # std 0.5 -> scale 1.0; std 0 -> clipped to 0.1
    np.testing.assert_allclose(reference_tpe.bandwidth(P).numpy(),
                               [base, 0.1 * base], rtol=1e-12)


def test_reference_judges_the_tpe_port_at_a_tiny_fleet():
    """The port's TPE asks on the CPU (the scorer's plain version, float32)
    against the float64 reference: every score within float32 rounding,
    every pick the reference's best; the bfloat16 control reads far above
    the port."""
    res = tiny_run("tpe.h6.long", seconds=2.0,
                   precisions=("float64", reference_tpe.CONTROL))
    r = res["readings"]
    assert res["correct"], res["check"]
    assert r["tpe_score_gap"]["n"] >= 8
    assert r["tpe_score_gap"]["max"] < 1e-4
    assert r["tpe_pick_gap"]["max"] < 1e-5
    assert r["control.tpe_score_gap"]["max"] > 100 * r["tpe_score_gap"]["max"]
    for k in ("na_changes", "missing_picks", "candidate_faults",
              "invalid_trials"):
        assert res["check"][k]["value"] == 0, k


def test_a_block_of_the_wrong_form_is_a_candidate_fault():
    cfg = {"optimizer": "tpe", "dim": 2, "n_studies": 1, "mc_samples": 3,
           "batch_size": 1, "gamma": 0.25}
    C = torch.zeros((1, 3, 8))
    C[0, 0, 5] = 0.5     # a padded column that is not zero
    for bad in (C, torch.zeros((1, 4, 8)), None):
        got = reference_tpe.judge_ask({"C": bad}, cfg, "cpu", None)
        assert got["candidate_faults"] == [1.0]
        assert got["missing_picks"] == [1.0]


def test_tpe_bound_is_chip_smokes_at_the_kernel_tables_shape():
    """Phase 2's fleet shape: 64 studies of 200, 199 or 198 weighted rows,
    16,800 candidates, 6 dimensions: bound by the exponentials."""
    ns = [200 - b % 3 for b in range(64)]
    t = peaks.tpe_scores_s(ns, 16800, 6)
    assert 0.306e-3 <= t <= 0.3075e-3
    assert t == pytest.approx(16800 * sum(ns) * 6 / peaks.PEAK_EXP)


def test_tpe_readers_on_made_up_asks():
    cfg = harness.bank_config(harness.cell_files(
        load_bench(), "tpe.h6.long")["config"])
    k = np.full(64, 900)
    bound = peaks.tpe_scores_s(k, cfg["mc_samples"], cfg["dim"])
    prof = {"dev": [trace.Event("void tpe_kde_kernel<false, 8>(...)", 0.0,
                                4 * bound),
                    trace.Event("void score_cov_kernel<...>", 0.0, 1.0)],
            "asks": [{"k_obs": k}, {"k_obs": k}]}
    ctx = {"cfg": cfg, "profile": prof}
    assert harness.reader("tpe_scores_roofline")(ctx) == pytest.approx(50.0)
    a = {"k_obs": k, "due": np.zeros(64, bool), "round": 0, "ms": 8e3 * bound}
    ctx = {"cfg": cfg, "asks": [a], "profile": None}
    assert harness.reader("ask_mfu_pct")(ctx) == pytest.approx(12.5)


def judge_before(recorded, cfg, files, device, asks, failed, precisions):
    """The harness's ``judge`` as it was before a reference could add
    numbers: the thirteen values and the readings' summary."""
    reference = files["reference"]
    cdf = files["objective"].candidate_cdf
    readings = {}
    for rec in recorded:
        for k, v in reference.judge_ask(rec, cfg, device, cdf,
                                        precisions).items():
            readings.setdefault(k, []).extend(float(x) for x in v)
    repeats = reference.repeated_blocks(
        [r["C"] for r in recorded if r.get("C") is not None])
    nas = {x for a in asks for x in a["na"]}
    unseen = sum(1 for a in asks if not a["na"])

    def worst(name):
        v = readings.get(name)
        return max(v) if v and all(math.isfinite(x) for x in v) else None

    values = {
        "fit_gap": worst("fit_gap"),
        "std_gap": worst("std_gap"),
        "mu_gap": worst("mu_gap"),
        "sig2_gap": worst("sig2_gap"),
        "pick_gap": worst("pick_gap"),
        "picks_outside_top_set": float(sum(
            g > 0 for g in readings.get("top_set_gap", []))),
        "head_mismatches": float(sum(readings.get("head_mismatch", []))),
        "candidate_ks": worst("candidate_ks"),
        "candidate_faults": float(
            sum(readings.get("candidate_faults", [])) + repeats),
        "missing_picks": float(sum(readings.get("missing_picks", []))),
        "schedule_faults": float(sum(readings.get("schedule_faults", []))),
        "na_changes": float(max(len(nas) - 1, 0) + unseen),
        "invalid_trials": float(failed),
    }
    summary = {k: {"n": len(v), "max": worst(k), "sum": float(sum(v))}
               for k, v in readings.items()}
    return {"values": values, "readings": summary}


@pytest.mark.parametrize("cell", ["gp_bucb.long.staggered",
                                  "clustering.long.staggered",
                                  "gp_bucb.long.lockstep"])
def test_the_gp_cells_judge_the_same_thirteen_values(cell, monkeypatch):
    """On the same recorded asks of a GP cell at a fixed seed, the judge
    gives exactly the values and readings of its formula before the TPE
    numbers joined it, and no other number; the TPE capture stays empty."""
    seen = []
    real = harness.judge

    def judge(*a):
        got = real(*a)
        seen.append((got, judge_before(*a), a[0]))
        return got

    monkeypatch.setattr(harness, "judge", judge)
    res = tiny_run(cell, seconds=1.0, seed=2 ** 32 + 17)
    assert res["correct"], res["check"]
    (got, before, recorded), = seen
    assert got == before
    assert len(got["values"]) == 13
    assert recorded and all(r["tpe_scores"] is None for r in recorded)
