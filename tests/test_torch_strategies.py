"""PyTorch port, the single-study strategies against the JAX package's on
the same numpy inputs, on the CPU: ``HallucinationStrategy``
(``hallucination_ref``), ``FusedHallucinationStrategy`` on the L-based path
and on the factor core, ``ClusteringStrategy.propose`` / ``propose_host``
and ``TPEStrategy.propose``.  The JAX side runs as its own tests run it:
jnp, or the Pallas kernels in interpret mode where ``kinv_pallas`` is
asked for.  The reference's cases of ``test_fused_proposal.py``,
``test_device_proposal_parity.py`` and ``test_strategies.py`` run on the
port.

Picks must be equal, except at a near-tie: a GP pick may differ where
``chip_smoke.picks_agree`` finds both within 1e-4 (relative) of the float64
GP-BUCB surface's best at the first differing slot (the surface from the
JAX side's fitted hyperparameters); a clustering pick where
``chip_smoke.cluster_replay``, the pick replayed in float64, sees a margin
under ``chip_smoke.CLUSTER_TIES``.  TPE picks must be equal.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.strategies as J
import repro.core.tpe as JT
import repro_torch.core.strategies as T
import repro_torch.core.tpe as TT
from repro.core import kmeans as j_kmeans
from repro_torch.core import kmeans as t_kmeans
from repro_torch.core import scoring as t_scoring

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DOM = 1e4


def _data(seed=0, n=20, n_cand=300, d=2, n_pend=3, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (-np.sum((X - 0.6) ** 2, -1)
         + noise * rng.normal(size=n)).astype(np.float32)
    C = rng.uniform(size=(n_cand, d)).astype(np.float32)
    P = rng.uniform(size=(n_pend, d)).astype(np.float32)
    return X, y, C, P


def _port(cls, **kw):
    return getattr(T, cls)(2, DOM, fit_steps=15, device="cpu", **kw)


def _jax(cls, **kw):
    return getattr(J, cls)(2, DOM, fit_steps=15, **kw)


def _gp_agree(got, want, jstrat, X, y, C, P=None):
    """Equal picks, or a near-tie of the float64 GP-BUCB surface under the
    JAX strategy's fitted GP."""
    if got == want:
        return True
    st = jstrat.gp.state
    z = (np.asarray(y, np.float32) - st.y_mean) / st.y_std
    ok, _ = chip_smoke.picks_agree(
        got, want, lambda prev: chip_smoke.bucb_acquisition(
            X, z, C, np.asarray(st.ls), float(st.var), float(st.noise),
            prev, DOM, P))
    return ok


def test_registry_and_validation():
    """The reference's names, its scorer errors and defaults; the Pallas
    switches are not taken (the device picks kernel or plain version)."""
    assert T.STRATEGIES["bayesian"] is T.FusedHallucinationStrategy
    assert T.STRATEGIES["hallucination_ref"] is T.HallucinationStrategy
    assert "_NOT_PORTED" not in vars(T)
    T.check_strategy("hallucination_ref")
    with pytest.raises(ValueError, match="unknown optimizer"):
        T.check_strategy("nope")
    with pytest.raises(ValueError, match="unknown scorer"):
        _port("HallucinationStrategy", scorer="nope")
    with pytest.raises(ValueError, match="factor core"):
        _port("ClusteringStrategy", scorer="chol")
    for flag in ("use_pallas", "pallas_interpret"):
        with pytest.raises(TypeError):
            _port("FusedHallucinationStrategy", **{flag: True})
    assert _port("HallucinationStrategy").scorer == "chol"
    assert _port("ClusteringStrategy").scorer == "kinv_jnp"
    assert _port("ClusteringStrategy", scorer="kinv_pallas").gp.track_factor


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_fused_matches_python_loop_and_jax(seed, batch):
    """The port's fused GP-BUCB picks what its Python loop picks, and what
    the JAX package's fused program picks."""
    X, y, C, _ = _data(seed=seed, n_cand=600)
    fused = _port("FusedHallucinationStrategy").propose(X, y, C, batch)
    assert fused == _port("HallucinationStrategy").propose(X, y, C, batch)
    js = _jax("FusedHallucinationStrategy")
    assert _gp_agree(fused, js.propose(X, y, C, batch), js, X, y, C)


def test_fused_parity_across_incremental_iterations():
    """Through the incremental observe path with a refit every ask
    (``refit_every=1``, the reference loop's schedule), three asks."""
    X, y, C, _ = _data(seed=3, n_cand=600)
    ref = _port("HallucinationStrategy")
    fused = _port("FusedHallucinationStrategy", refit_every=1)
    jfused = _jax("FusedHallucinationStrategy", refit_every=1)
    Xl, yl = list(X), list(y)
    for _ in range(3):
        Xa, ya = np.asarray(Xl, np.float32), np.asarray(yl, np.float32)
        picks = fused.propose(Xa, ya, C, batch_size=3)
        assert picks == ref.propose(Xa, ya, C, batch_size=3)
        assert picks == jfused.propose(Xa, ya, C, batch_size=3)
        for i in picks:
            Xl.append(C[i])
            yl.append(-((C[i][0] - 0.6) ** 2 + (C[i][1] - 0.4) ** 2))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pending_parity_three_way(seed):
    """Factor core with trials in flight: absorbed inside the program ==
    the host hallucination loop + the fused pick == the reference loop ==
    the JAX package's ``kinv_pallas`` (Pallas, interpret mode)."""
    X, y, C, P = _data(seed=seed)
    picks = _port("FusedHallucinationStrategy",
                  scorer="kinv_pallas").propose(X, y, C, 4, pending=P)
    host = _port("FusedHallucinationStrategy", scorer="kinv_pallas")
    st = host.gp.observe(X, y)
    st = host.gp.ensure_capacity(st, len(P) + 4)
    st = host._absorb_pending(st, P)
    assert picks == host.pick_from_state(st, C, 4)
    assert picks == _port("HallucinationStrategy").propose(X, y, C, 4,
                                                           pending=P)
    js = _jax("FusedHallucinationStrategy", use_pallas=True)
    assert _gp_agree(picks, js.propose(X, y, C, 4, pending=P), js, X, y, C,
                     P)


@pytest.mark.parametrize("seed", range(8))
def test_noiseless_near_tie_parity(seed):
    """The pick-flip surface (noiseless quadratic, fitted noise at its
    floor): the three scorers pick alike with trials in flight, as the JAX
    package's Cholesky path does; without pending, the factor core's
    ``hallucination_ref`` (one ``score_cov`` a slot) picks alike too."""
    X, y, C, P = _data(seed=seed, noise=0.0)
    picks = _port("FusedHallucinationStrategy").propose(X, y, C, 4,
                                                        pending=P)
    for sc in ("kinv_jnp", "kinv_pallas"):
        assert _port("FusedHallucinationStrategy", scorer=sc).propose(
            X, y, C, 4, pending=P) == picks
    js = _jax("FusedHallucinationStrategy")
    assert _gp_agree(picks, js.propose(X, y, C, 4, pending=P), js, X, y, C,
                     P)
    if seed < 4:
        assert _port("HallucinationStrategy", scorer="kinv_pallas").propose(
            X, y, C, 5) == _port("FusedHallucinationStrategy").propose(
            X, y, C, 5)


def test_cond_proxy_matches_jax():
    """Every GP propose stages the condition estimate of its window: None
    before, the JAX package's value after (1e-3 relative, the bank's
    tolerance for ``cond_estimate``)."""
    X, y, C, _ = _data(seed=0, noise=0.0)
    for cls, kw in (("FusedHallucinationStrategy", {"scorer": "kinv_jnp"}),
                    ("ClusteringStrategy", {})):
        t, j = _port(cls, **kw), _jax(cls, **kw)
        assert t.last_cond_proxy is None
        t.propose(X, y, C, 3)
        j.propose(X, y, C, 3)
        assert t.last_cond_proxy >= 1.0
        np.testing.assert_allclose(t.last_cond_proxy, j.last_cond_proxy,
                                   rtol=1e-3)


@pytest.mark.parametrize("noise", [1e-1, 1e-3, 1e-5])
def test_cond_estimate_within_2x_of_true(noise):
    """The power-iteration estimate behind ``last_cond_proxy`` lands within
    2x of ``np.linalg.cond`` on identity-padded RBF kernels; the diagonal
    bound ``cond_proxy_from_chol`` stays below it."""
    rng = np.random.default_rng(0)
    for na, n in [(32, 20), (64, 49)]:
        X = rng.uniform(size=(n, 3)).astype(np.float32)
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        K = (np.exp(-0.5 * d2) + np.eye(n) * noise).astype(np.float32)
        true = np.linalg.cond(K.astype(np.float64))
        Kp = np.eye(na, dtype=np.float32)
        Kp[:n, :n] = K
        L = torch.as_tensor(np.linalg.cholesky(
            Kp.astype(np.float64)).astype(np.float32))
        mask = torch.zeros(na)
        mask[:n] = 1.0
        est = float(t_scoring.cond_estimate(L[None], mask[None])[0])
        assert true / 2.0 <= est <= true * 2.0, (na, n, est, true)
        assert float(t_scoring.cond_proxy_from_chol(L, mask)) <= true * 1.01


def test_single_scoring_backend_dispatch(monkeypatch):
    """The factor-core GP-BUCB pick and the clustering pick both score
    through ``scoring.posterior_scores``, looked up when called."""
    calls = []
    orig = t_scoring.posterior_scores

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(t_scoring, "posterior_scores", spy)
    X, y, C, P = _data(seed=9, n_cand=317)
    _port("FusedHallucinationStrategy", scorer="kinv_pallas").propose(
        X, y, C, 3, pending=P)
    assert len(calls) == 1
    _port("ClusteringStrategy").propose(X, y, C, 3, pending=P)
    _port("ClusteringStrategy", scorer="kinv_pallas").propose(X, y, C, 3)
    assert calls == [(317, 8)] * 3
    _port("FusedHallucinationStrategy").propose(X, y, C, 3)   # chol: no
    assert len(calls) == 3


def _cluster_agree(got, want, strat, X, y, C, seed, batch, P=None):
    """Equal picks, or a near-tie of the float64 replay of the pick on the
    float64 UCB surface of the strategy's fitted GP."""
    if got == want:
        return True
    st = strat.gp.state
    z = (np.asarray(y, np.float32) - st.y_mean) / st.y_std
    acq = chip_smoke.bucb_acquisition(
        X, z, C, np.asarray(st.ls), float(st.var), float(st.noise), [], DOM,
        P)
    n_top = T.n_top_candidates(len(C), batch, 0.2)
    u = t_kmeans.kmeans_uniforms([seed], batch)[0]
    _, m = chip_smoke.cluster_replay(acq, C, batch, n_top, u)
    return chip_smoke.cluster_near_tie(m)


@pytest.mark.parametrize("seed,pend", [(0, False), (1, False), (2, False),
                                       (3, False), (0, True), (1, True)])
def test_clustering_device_host_and_jax(seed, pend):
    """``propose`` (the device program) == ``propose_host`` (the numpy
    pipeline) in the port, and == the JAX package's ``propose``."""
    X, y, C, P = _data(seed=seed, n_cand=300 if pend else 600)
    P = P if pend else None
    dev = _port("ClusteringStrategy").propose(X, y, C, 4, seed=seed,
                                              pending=P)
    host = _port("ClusteringStrategy")
    assert _cluster_agree(dev, host.propose_host(X, y, C, 4, seed=seed,
                                                 pending=P),
                          host, X, y, C, seed, 4, P)
    js = _jax("ClusteringStrategy")
    assert _cluster_agree(dev, js.propose(X, y, C, 4, seed=seed, pending=P),
                          js, X, y, C, seed, 4, P)


def test_batch_one_and_diversity():
    """Batch 1 reduces to the UCB argmax for every GP strategy; a
    hallucinated batch spreads out; clustering's batch is unique."""
    X, y, C, _ = _data(seed=2, n_cand=600)
    first = _port("HallucinationStrategy").propose(X, y, C, 1)[0]
    assert _port("ClusteringStrategy").propose(X, y, C, 1)[0] == first
    assert _port("ClusteringStrategy").propose_host(X, y, C, 1)[0] == first
    picked = _port("HallucinationStrategy").propose(X, y, C, 5)
    pts = C[picked]
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    np.fill_diagonal(d, 1.0)
    assert len(set(picked)) == 5 and d.min() > 1e-3
    assert len(set(_port("ClusteringStrategy").propose(X, y, C, 5))) == 5


def test_clustering_empty_cluster_backfill_never_duplicates():
    """Repeated candidate locations leave k-means clusters empty; the
    back-fill never picks an index twice, on either path."""
    X, y, _, _ = _data(seed=3)
    base = np.array([[0.1, 0.1], [0.5, 0.5], [0.9, 0.9]], np.float32)
    C = np.repeat(base, 7, axis=0)
    for seed in range(4):
        for path in ("propose", "propose_host"):
            s = T.ClusteringStrategy(2, DOM, fit_steps=10, device="cpu")
            picked = getattr(s, path)(X, y, C, batch_size=5, seed=seed)
            assert len(picked) == len(set(picked)) == 5


def test_clustering_propose_stays_on_device(monkeypatch):
    """The device program uses neither the host predict adapter nor the
    host k-means."""
    def boom(*a, **k):
        raise AssertionError("host acquisition/k-means path was used")

    monkeypatch.setattr(T.ClusteringStrategy, "_predict", boom)
    monkeypatch.setattr(T, "kmeans_assign", boom)
    X, y, C, _ = _data(seed=1)
    assert len(set(_port("ClusteringStrategy").propose(X, y, C, 5))) == 5


def test_kmeans_assign_matches_jax():
    """Two blobs split apart, and the assignment equals the JAX package's
    (the same uniforms from ``PRNGKey(seed)``)."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 0.05, (30, 2)),
                        rng.normal(1, 0.05, (30, 2))]).astype(np.float32)
    a = t_kmeans.kmeans_assign(X, np.ones(60, np.float32), 2, seed=0,
                               device="cpu")
    assert set(a.tolist()) == {0, 1} and a[0] != a[45]
    assert len(set(a[:30].tolist())) == 1
    Y = rng.uniform(size=(200, 3)).astype(np.float32)
    w = rng.uniform(size=200).astype(np.float32)
    for seed in range(3):
        np.testing.assert_array_equal(
            t_kmeans.kmeans_assign(Y, w, 5, seed=seed, device="cpu"),
            j_kmeans.kmeans_assign(Y, w, 5, seed=seed))
    np.testing.assert_array_equal(
        t_kmeans.kmeans_assign(Y[:3], w[:3], 5, device="cpu"), [0, 1, 2])


def test_gp_mean_std_matches_jax():
    """The single-study ``score_cov`` adapter against the JAX package's
    (Pallas, interpret mode) on one fitted GP: mean and deviation to 1e-4
    of their scale, with and without a tracked L^-1."""
    from repro.kernels.gp_acquisition import ops as j_ops
    from repro_torch.kernels.gp_acquisition import ops as t_ops
    X, y, C, _ = _data(seed=4)
    for track in (False, True):
        t = T.FusedHallucinationStrategy(
            2, DOM, fit_steps=15, device="cpu",
            scorer="kinv_jnp" if track else "chol")
        j = J.FusedHallucinationStrategy(
            2, DOM, fit_steps=15, scorer="kinv_jnp" if track else "chol")
        for got, want in zip(t_ops.gp_mean_std(t.gp.fit(X, y), C),
                             j_ops.gp_mean_std(j.gp.fit(X, y), C)):
            np.testing.assert_allclose(got, want,
                                       atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tpe_pick_parity_three_way(seed):
    """The numpy oracle, the port's device program and the JAX package's
    jitted program pick the same candidates, also on anisotropic data."""
    X, y, C, _ = _data(seed=seed, n_cand=300 + 100 * seed)
    picks = TT.TPEStrategy(2, DOM, device="cpu").propose_host(X, y, C, 4)
    assert TT.TPEStrategy(2, DOM, device="cpu").propose(X, y, C, 4) == picks
    assert JT.TPEStrategy(2, DOM).propose(X, y, C, 4) == picks
    rng = np.random.default_rng(seed)
    A = np.stack([rng.uniform(size=24), (rng.uniform(size=24) < 0.3),
                  0.5 + 0.02 * rng.normal(size=24)], 1).astype(np.float32)
    ya = (-(A[:, 0] - 0.6) ** 2 - 0.3 * A[:, 1]).astype(np.float32)
    CA = np.stack([rng.uniform(size=300), rng.uniform(size=300) < 0.5,
                   0.5 + 0.02 * rng.normal(size=300)], 1).astype(np.float32)
    assert TT.TPEStrategy(3, DOM, device="cpu").propose(A, ya, CA, 4) == \
        JT.TPEStrategy(3, DOM).propose_host(A, ya, CA, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tpe_pending_penalty(seed):
    """With the penalty the in-flight rows join the bad split: device ==
    host == JAX.  Without it pending rows change nothing, and a replacement
    pick repeats the pick in flight; with it, it moves away."""
    X, y, C, P = _data(seed=seed)
    pen = TT.TPEStrategy(2, DOM, pending_penalty=True, device="cpu")
    picks = pen.propose_host(X, y, C, 4, pending=P)
    assert pen.propose(X, y, C, 4, pending=P) == picks
    assert JT.TPEStrategy(2, DOM, pending_penalty=True).propose(
        X, y, C, 4, pending=P) == picks
    naive = TT.TPEStrategy(2, DOM, device="cpu")
    first = naive.propose(X, y, C, 1)
    assert naive.propose(X, y, C, 1, pending=C[first]) == first
    assert naive.propose(X, y, C, 4) == naive.propose(X, y, C, 4, pending=P)
    if seed == 1:
        assert pen.propose(X, y, C, 1, pending=C[first]) != first
    assert sorted(naive.propose(X, y, C[:3], 8)) == [0, 1, 2]


def test_random_strategy():
    s = T.RandomStrategy()
    assert len(set(s.propose(None, [], np.zeros((100, 2)), 8, seed=0))) == 8
    assert sorted(int(p) for p in s.propose(None, [], np.zeros((3, 2)), 8,
                                            seed=0)) == [0, 1, 2]
