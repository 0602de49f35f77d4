"""The plain reference against the port on the CPU at a tiny fleet, the
control (TF32, emulated here by rounding) against both, the candidate
block the harness captures, and the clustering head run again."""
import copy

import numpy as np
import pytest
import torch

from portbench import harness, reference
from portbench_tiny import tiny_files, tiny_run

H6 = harness.load_module(harness.PB / "objectives" / "neg_hartmann6.py")


def test_candidates_are_the_banks_draw():
    """The block the probe captures at ``bank_prescale_C`` is the bank's
    own draw of the ask, and it reads as a uniform draw."""
    from portbench.fleet import Fleet
    files = tiny_files("gp_bucb.long.staggered")
    cfg = harness.bank_config(files["config"])
    seed = 2 ** 31 + 99
    bank = harness.make_bank(cfg, H6, seed, "cpu")
    fl = Fleet(bank, files["traffic"], cfg["batch_size"], seed, H6)
    fl.load(seed + 1)
    fl.warm()
    probe = harness.Probe("cpu", False)
    probe.install()
    try:
        rng = copy.deepcopy(bank._rng)
        probe.capture = {"C": [], "u": [], "scores": []}
        fl.ask()
    finally:
        probe.uninstall()
    B, S = cfg["n_studies"], cfg["mc_samples"]
    cols = bank.space.sample_columns(B * S, rng)
    want = bank.space.encode_columns(cols, B * S).astype(np.float32)
    got = torch.cat(probe.capture["C"])
    np.testing.assert_array_equal(got.numpy(), want.reshape(B, S, -1))
    ks = reference.candidate_ks(got, H6.candidate_cdf)
    assert ks.shape == (B, 6) and float(ks.max()) < 2.5
    assert reference.repeated_blocks([got, got.clone()]) == B


def test_kolmogorov_statistic_sees_a_cut_draw():
    rng = np.random.default_rng(5)
    C = torch.as_tensor(rng.uniform(size=(2, 16800, 6)))
    assert float(reference.candidate_ks(C, H6.candidate_cdf).max()) < 2.5
    cut = reference.candidate_ks(0.9 * C, H6.candidate_cdf)
    assert float(cut.min()) > 10.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    got = reference.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


def test_posterior_matches_a_direct_solve():
    rng = np.random.default_rng(0)
    X, y = rng.uniform(size=(30, 6)), rng.normal(size=30)
    C = torch.as_tensor(rng.uniform(size=(50, 6)))
    ym, ys = reference.standardization(y)
    gp = reference.GP(X, y, np.full(6, -0.5), 0.2, -4.0, ym, ys,
                      reference.Precision("float64"), "cpu")
    mu, sig2, _ = gp.scores(C)
    K = gp.L @ gp.L.T
    Kc = gp.cross(C)
    z = (torch.as_tensor(np.asarray(y, np.float32)).double() - ym) / ys
    np.testing.assert_allclose(mu, Kc @ torch.linalg.solve(K, z),
                               rtol=1e-9, atol=1e-9)
    direct = gp.var + gp.noise - (Kc * torch.linalg.solve(K, Kc.T).T).sum(-1)
    np.testing.assert_allclose(sig2, torch.clamp(direct, min=1e-10),
                               rtol=1e-7, atol=1e-12)


def test_reference_judges_the_port_at_a_tiny_fleet():
    """The port's asks on the CPU (its kernels' plain versions, float32)
    against the float64 reference: every number small, every pick the
    reference's best or on a near-tie; the emulated TF32 control reads far
    above the port."""
    res = tiny_run("gp_bucb.long.staggered", seconds=2.0,
                   precisions=("float64", "tf32"))
    r = res["readings"]
    assert res["failed"] == 0
    assert r["fit_gap"]["n"] >= 1 and r["fit_gap"]["max"] < 1e-4
    assert r["std_gap"]["max"] < 1e-5
    assert r["mu_gap"]["max"] < 1e-3 and r["sig2_gap"]["max"] < 1e-3
    assert r["pick_gap"]["max"] < 1e-4
    assert r["control.sig2_gap"]["max"] > 10 * r["sig2_gap"]["max"]
    assert res["check"]["na_changes"]["value"] == 0
    assert res["check"]["missing_picks"]["value"] == 0


def test_reference_judges_the_clustering_port():
    res = tiny_run("clustering.long.staggered", seconds=2.0)
    r = res["readings"]
    assert r["top_set_gap"]["max"] == 0.0
    assert res["check"]["picks_outside_top_set"]["value"] == 0
    assert r["head_mismatch"]["n"] >= 4
    assert res["check"]["head_mismatches"]["value"] == 0
    assert r["sig2_gap"]["max"] < 1e-3
    assert r["fit_gap"]["max"] < 1e-4


@pytest.mark.parametrize("seed", range(4))
def test_cluster_head_is_the_ports_head(seed):
    """The reference's float64 head against the port's ``cluster_pick`` on
    the same surface, candidates and uniforms, at the cells' size: the same
    picks wherever the reference sees no near-tie, and few near-ties."""
    from repro_torch.core import gp
    from repro_torch.core.kmeans import kmeans_uniforms
    rng = np.random.default_rng(seed)
    R, S, n, n_top = 8, 16800, 4, 3360
    C = rng.uniform(size=(R, S, 6)).astype(np.float32)
    acq = sum(rng.uniform(0.5, 2.0, (R, 1)) * np.exp(
        -((C - rng.uniform(size=(R, 1, 6))) ** 2).sum(-1) / 0.05)
        for _ in range(4)) + 0.05 * rng.normal(size=(R, S))
    acq = acq.astype(np.float32)
    u = kmeans_uniforms(np.arange(R) + 100 * seed, n)
    port = gp.cluster_pick(torch.as_tensor(acq), torch.as_tensor(C),
                           torch.as_tensor(u), n_top, n).numpy()
    judged = [reference.head_mismatch(
        torch.as_tensor(acq[b]).double(), torch.as_tensor(C[b]).double(),
        u[b].tolist(), port[b], n_top) for b in range(R)]
    assert [m for m in judged if m is not None] == [0.0] * sum(
        m is not None for m in judged)
    assert sum(m is None for m in judged) <= R // 2
    best4 = np.argsort(-acq[0], kind="stable")[:n]
    assert reference.head_mismatch(
        torch.as_tensor(acq[0]).double(), torch.as_tensor(C[0]).double(),
        u[0].tolist(), best4, n_top) in (1.0, None)


def test_fit_reference_follows_the_ports_fit():
    """One Adam fit of the reference against ``gp.fit_hypers_bank`` from
    the same warm start (float32 against float64: close, not equal)."""
    from repro_torch.core import gp
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(2, 40, 6))
    y = H6.evaluate(X)
    studies = []
    for b in range(2):
        ym, ys = reference.standardization(y[b])
        studies.append({"X": X[b], "y": y[b], "ym": ym, "ys": ys,
                        "start": {"log_ls": np.full(6, np.log(0.5)),
                                  "log_var": 0.0,
                                  "log_noise": np.log(1e-2)}})
    mine = reference.fit(studies, 40, "cpu")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    ym = t([s["ym"] for s in studies])
    ys = t([s["ys"] for s in studies])
    lls, lv, ln = gp.fit_hypers_bank(
        t(X), t(y), torch.ones(2, 40), t(np.full((2, 6), np.log(0.5))),
        torch.zeros(2), t(np.full(2, np.log(1e-2))), ym, ys, steps=40)
    np.testing.assert_allclose(lls.numpy(), mine[0], atol=2e-3)
    np.testing.assert_allclose(lv.numpy(), mine[1], atol=2e-3)
    np.testing.assert_allclose(ln.numpy(), mine[2], atol=2e-3)
