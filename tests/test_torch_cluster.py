"""PyTorch port, the clustering strategy (Groves & Pyzer-Knapp 2018) against
the JAX package: the host threefry bits, the batched k-means, the cluster
bank's picks, a three-family bank, and the Tuner.

The PRNG is bit for bit ``jax.random`` and the k-means assignments equal
``repro.core.kmeans._kmeans`` on continuous seeded data (no near-ties).
Picks are held as the GP bank tests hold GP-BUCB: equal, except where the
float64 replay of the pick (``chip_smoke.cluster_replay``) finds a
near-tie (``chip_smoke.CLUSTER_TIES``), after which that study is left
alone; where the replay finds none, its picks must equal the port's too.
Hyperparameters are frozen in the bank tests, as in
``test_gp_phase_picks_match_repro_at_bucket_edges``, so the two packages'
float32 fits (Adam, summed in their own orders) do not enter.  The card
test at the end skips without a card.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.core as T
from repro_torch.core import gp as gp_lib
from repro_torch.core import kmeans, prng
from repro_torch.core.strategies import n_top_candidates
from repro_torch.kernels.gp_acquisition import ops

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}
N_MC = 200


def _jax():
    import jax
    import jax.numpy as jnp

    import repro.core as J
    return jax, jnp, J


def _objective(p):
    return -(p["x"] - 0.3) ** 2 - (p["y"] - 0.5) ** 2


# --------------------------------------------------------------- PRNG
def test_prng_keys_match_jax():
    jax, jnp, _ = _jax()
    for seed in (0, 1, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.PRNGKey(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    seeds = np.array([0, 1, 5, 2 ** 31, 2 ** 32 - 1], np.uint32)
    want = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    np.testing.assert_array_equal(prng.PRNGKey(seeds), np.asarray(want))


def test_prng_split_chains_and_uniforms_match_jax():
    """Four links of ``key, sub = split(key)`` over a vector of keys, the
    uniform of every sub-key (bits compared), and a five-way split."""
    jax, jnp, _ = _jax()
    seeds = np.array([0, 3, 77, 2 ** 31 + 9], np.uint32)
    key = prng.PRNGKey(seeds)
    jkey = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    for _ in range(4):
        pair = prng.split(key)
        jpair = np.asarray(jax.vmap(jax.random.split)(jkey))
        np.testing.assert_array_equal(pair, jpair)
        u = prng.uniform(pair[:, 1])
        ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(
            jnp.asarray(jpair[:, 1])))
        assert u.dtype == np.float32
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
        key, jkey = pair[:, 0], jnp.asarray(jpair[:, 0])
    np.testing.assert_array_equal(
        prng.split(prng.PRNGKey(11), 5),
        np.asarray(jax.random.split(jax.random.PRNGKey(11), 5)))


# ------------------------------------------------------------- k-means
@pytest.mark.parametrize("n,d,k", [(400, 6, 4), (100, 6, 5), (40, 2, 3),
                                   (16, 3, 4)])
def test_kmeans_assignments_match_reference(n, d, k):
    """``kmeans.kmeans`` from ``kmeans_uniforms`` against
    ``repro.core.kmeans._kmeans`` on seeded weighted points, six seeds
    batched as six studies."""
    jax, jnp, _ = _jax()
    from repro.core.kmeans import _kmeans
    rng = np.random.default_rng(n + d + k)
    X = rng.uniform(size=(6, n, d)).astype(np.float32)
    w = (rng.uniform(size=(6, n)) ** 3 + 1e-6).astype(np.float32)
    seeds = np.array([0, 1, 2, 40, 2 ** 31, 2 ** 32 - 1], np.uint32)
    got = kmeans.kmeans(torch.as_tensor(X), torch.as_tensor(w),
                        torch.as_tensor(kmeans.kmeans_uniforms(seeds, k)))
    for b, s in enumerate(seeds):
        want = _kmeans(jnp.asarray(X[b]), jnp.asarray(w[b]),
                       jax.random.PRNGKey(int(s)), k)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_top_k_keeps_lax_top_k_order_on_ties():
    jax, jnp, _ = _jax()
    x = np.array([[1.0, 3.0, 3.0, -1.0, 3.0, 2.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 5.0, 0.0, -np.inf]], np.float32)
    vals, idx = gp_lib.top_k(torch.as_tensor(x), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# -------------------------------------------------------------- banks
def _frozen_bank(pkg, names, n_obs, seed=7, **kw):
    """A bank of ``names`` studies, each with ``n_obs`` noisy observations
    of its own and frozen hypers (no fit runs in the next three rounds)."""
    rng = np.random.default_rng(seed)
    bank = pkg.StudyBank(SPACE, len(names), optimizer=list(names),
                         seed=seed, mc_samples=N_MC, **kw)
    for b in range(len(names)):
        for _ in range(n_obs):
            p = {"x": float(rng.uniform(0, 1)),
                 "y": float(rng.uniform(-1, 1))}
            bank.study(b).observe_params(p, _objective(p)
                                         + 0.05 * float(rng.normal()))
    led = bank.ledger
    led.have_fit[:] = 1
    led.n_fit[:] = n_obs
    led.log_ls[:] = np.log([0.3, 0.6])
    led.log_var[:] = 0.1
    led.log_noise[:] = np.log(1e-2)
    led.y_mean[:] = -0.6
    led.y_std[:] = 0.5
    return bank


def _candidates(bank, state):
    """The candidate draw of the ask made from RNG state ``state``."""
    replay = np.random.default_rng(0)
    replay.bit_generator.state = state
    cols = bank.space.sample_columns(bank.n_studies * N_MC, replay)
    return bank.space.encode_columns(cols, bank.n_studies * N_MC).reshape(
        bank.n_studies, N_MC, -1)


def _index(bank, C, trials):
    return [int(np.flatnonzero((C == r).all(1))[0])
            for r in bank.space.encode([t.params for t in trials])]


def _surface(bank, C, b):
    """Study b's float64 UCB surface before the ask (its first GP-BUCB
    slot: the clustering head scores the same surface)."""
    led = bank.ledger
    ids = led.obs_ids(b)
    z = (led.y[b, ids].astype(np.float32) - led.y_mean[b]) / led.y_std[b]
    return chip_smoke.bucb_acquisition(
        led.X[b, ids], z, C[b], np.exp(led.log_ls[b]),
        np.exp(led.log_var[b]), np.exp(led.log_noise[b]) + 1e-5, [],
        bank.study(b).domain_size)


def _cluster_judge(bank, C, b, n, got, want):
    """True when the port's picks ``got`` and the reference's ``want``
    agree, or differ on a near-tie of the float64 replay; where the replay
    sees no near-tie its picks must equal the port's too.  Called right
    after the ask, whose k-means seed was the ask count before it."""
    u = kmeans.kmeans_uniforms(bank.ledger.ask_count[[b]] - 1, n)[0]
    n_top = n_top_candidates(N_MC, n, bank.strategy_kwargs.get(
        "top_frac", 0.2))
    picks, margins = chip_smoke.cluster_replay(_surface(bank, C, b), C[b], n,
                                               n_top, u)
    if chip_smoke.cluster_near_tie(margins):
        return True
    assert picks == got, (b, picks, got, margins)
    return got == want


def _three_rounds(names, jb, tb, n=3):
    """Three rounds of ask_all(n) -> tell in both banks; each study's picks
    judged by family until it first parts from the reference."""
    diverged, ties = set(), 0
    for _ in range(3):
        state = jb._rng.bit_generator.state
        C = _candidates(jb, state)
        jt, tt = jb.ask_all(n), tb.ask_all(n)
        for b, name in enumerate(names):
            if b in diverged:
                continue
            got, want = _index(jb, C[b], tt[b]), _index(jb, C[b], jt[b])
            if name == "tpe":
                assert got == want, b
            elif name == "clustering":
                assert _cluster_judge(jb, C, b, n, got, want), b
            elif got != want:
                oracle = (lambda prev, b=b: chip_smoke.bucb_acquisition(
                    *_gp_args(jb, C, b), prev, jb.study(b).domain_size))
                assert chip_smoke.picks_agree(got, want, oracle)[0], b
            if got != want:
                diverged.add(b)
                ties += 1
        for bank, trials in ((jb, jt), (tb, tt)):
            for b, ts in enumerate(trials):
                for t in ts:
                    bank.tell(b, t.id, _objective(t.params))
    return ties


def _gp_args(bank, C, b):
    led = bank.ledger
    ids = led.obs_ids(b)
    z = (led.y[b, ids].astype(np.float32) - led.y_mean[b]) / led.y_std[b]
    return (led.X[b, ids], z, C[b], np.exp(led.log_ls[b]),
            np.exp(led.log_var[b]), np.exp(led.log_noise[b]) + 1e-5)


@pytest.mark.parametrize("n_obs", [15, 16, 33])
def test_cluster_bank_picks_match_repro_over_three_rounds(n_obs):
    """Three clustering studies at a bucket edge, three rounds of
    ask_all(3) -> tell: the same picks as ``repro``'s StudyBank."""
    _, _, J = _jax()
    names = ["clustering"] * 3
    jb = _frozen_bank(J, names, n_obs)
    tb = _frozen_bank(T, names, n_obs, device="cpu")
    assert _three_rounds(names, jb, tb) == 0


def test_three_family_bank_matches_repro():
    """GP-BUCB, TPE and clustering studies in one bank over one candidate
    draw: TPE picks equal, GP and clustering picks equal up to their
    near-ties, and every family served in each round."""
    _, _, J = _jax()
    names = ["bayesian", "tpe", "clustering", "clustering", "tpe",
             "bayesian"]
    jb = _frozen_bank(J, names, 20)
    tb = _frozen_bank(T, names, 20, device="cpu")
    assert tb.optimizer == jb.optimizer == "mixed"
    assert _three_rounds(names, jb, tb) == 0


def _branin(p):
    x1, x2 = p["x1"], float(p["x2"])
    b, c, t = 5.1 / (4 * math.pi ** 2), 5 / math.pi, 1 / (8 * math.pi)
    v = (x2 - b * x1 ** 2 + c * x1 - 6.0) ** 2 \
        + 10 * (1 - t) * np.cos(x1) + 10
    return float(v + (12.0 if p["mode"] == "high" else 0.0))


BRANIN = {"x1": stats.uniform(-5, 15), "x2": range(0, 16),
          "mode": ["low", "high"]}


def test_clustering_tuner_matches_repro():
    """``Tuner(optimizer="clustering")``, batch 3, on the mixed Branin of
    the paper's Fig. 3: the same 21 configs as ``repro``'s Tuner (the
    hyperparameter fits, 10 Adam steps, agree closely enough here that no
    pick parts)."""
    _, _, J = _jax()
    conf = dict(optimizer="clustering", batch_size=3, num_iteration=6,
                seed=5, mc_samples=300, fit_steps=10, initial_random=3)

    def objective(ps):
        return [_branin(p) for p in ps], list(ps)

    want = J.Tuner(BRANIN, objective, dict(conf)).minimize()
    got = T.Tuner(BRANIN, objective, dict(conf, device="cpu")).minimize()
    assert len(got.params_tried) == 21
    assert got.params_tried == want.params_tried
    assert got.best_objective == want.best_objective


def test_top_frac_threads_to_the_pick_and_unknown_keys_raise(monkeypatch):
    """``strategy_kwargs={"top_frac": f}`` sizes the clustered top set in
    the optimizer, the Tuner and the AsyncTuner; an unknown key raises
    ``TypeError`` at the first ask, as in the reference."""
    seen = []
    orig = gp_lib.bank_cluster_pick

    def spy(*a, **k):
        seen.append(k["n_top"])
        return orig(*a, **k)

    # the bank calls its entry points through the registry
    monkeypatch.setitem(gp_lib.BANK_ENTRY_POINTS, "bank_cluster_pick", spy)
    opt = T.AskTellOptimizer(SPACE, optimizer="clustering", seed=0,
                             mc_samples=N_MC, fit_steps=5, device="cpu",
                             strategy_kwargs={"top_frac": 0.5})
    for t in opt.ask(2):
        opt.tell(t.id, _objective(t.params))
    opt.ask(2)
    assert seen == [100] and opt._strat.top_frac == 0.5
    T.Tuner(SPACE, lambda ps: ([_objective(p) for p in ps], list(ps)),
            dict(optimizer="clustering", batch_size=2, num_iteration=2,
                 mc_samples=N_MC, fit_steps=5, device="cpu",
                 strategy_kwargs={"top_frac": 0.3})).maximize()
    assert seen[1:] == [60, 60]
    from repro_torch.scheduler import SerialScheduler
    T.AsyncTuner(SPACE, _objective, SerialScheduler().as_async(),
                 optimizer="clustering", num_evals=6, batch_size=2,
                 initial_random=2, mc_samples=N_MC, fit_steps=5,
                 strategy_kwargs={"top_frac": 0.01},
                 device="cpu").maximize()
    assert seen[3:] and set(seen[3:]) == {4}   # 4 x batch 1 > 0.01 x 200
    bad = T.AskTellOptimizer(SPACE, optimizer="clustering", device="cpu",
                             strategy_kwargs={"top_fracc": 0.5})
    with pytest.raises(TypeError):
        bad.ask(1)
    with pytest.raises(TypeError):
        T.Tuner(SPACE, lambda ps: ([0.0] * len(ps), list(ps)),
                dict(optimizer="clustering", num_iteration=1, device="cpu",
                     strategy_kwargs={"gamma": 0.5})).maximize()


def test_cluster_pick_runs_score_cov_once_per_ask(monkeypatch):
    """A cluster bank's ask is one ``score_cov`` call for all its studies
    and no GP-BUCB downdate; the picks are distinct candidates."""
    calls = {"score_cov": 0, "var_downdate": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counting(*a, _o=orig, _n=name, **k):
            calls[_n] += 1
            return _o(*a, **k)

        monkeypatch.setattr(ops, name, counting)
    bank = _frozen_bank(T, ["clustering"] * 4, 12, device="cpu")
    for r in range(2):
        for b, ts in enumerate(bank.ask_all(4)):
            assert len({json.dumps(t.params) for t in ts}) == 4
            for t in ts:
                bank.tell(b, t.id, _objective(t.params))
    assert calls == {"score_cov": 2, "var_downdate": 0}


# ------------------------------------------------------------- card
@pytest.mark.cuda
def test_cuda_cluster_bank_picks_match_cpu():
    """A clustering bank asks the same picks on the card as on the CPU,
    except on near-ties of the float64 replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    names = ["clustering"] * 4
    banks = {dev: _frozen_bank(T, names, 30, device=dev)
             for dev in ("cuda", "cpu")}
    state = banks["cpu"]._rng.bit_generator.state
    C = _candidates(banks["cpu"], state)
    got = {dev: bank.ask_all(4) for dev, bank in banks.items()}
    for b in range(len(names)):
        g = _index(banks["cpu"], C[b], got["cuda"][b])
        c = _index(banks["cpu"], C[b], got["cpu"][b])
        assert _cluster_judge(banks["cpu"], C, b, 4, g, c), b
