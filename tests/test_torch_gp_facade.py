"""PyTorch port, one study's GP (``repro_torch.core.gp.GaussianProcess`` and
the single-study device math) against the JAX package's on the same numpy
inputs, on the CPU.

Tolerances are those of ``test_torch_gp.py``: log-hyperparameters after a
fit to 5e-4 (absolute, in log space: each Adam step's gradient differs in
its last bits between the two autodiff systems); L built from the same
hyperparameters to 1e-5 of its largest entry (float32 Cholesky in two
libraries, ``test_bank_factors_match_jax``), L^-1 and every factor after
rank-1 appends to 1e-4 of it (``test_factor_append_matches_jax``: the
inverse and the appends carry L's conditioning into the rounding);
posterior moments to 1e-4 relative of their scale.  Host-side state
(``n``, ``n_fit``, the frozen standardization, the snapshot format) is
compared exactly.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json

import jax
import numpy as np
import pytest

from repro.core import gp as j_gp
from repro_torch import convert
from repro_torch.core import gp as t_gp
from repro_torch.core import scoring as t_scoring


def _data(n=20, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _np(a):
    return None if a is None else np.asarray(jax.device_get(a), np.float32)


def _jax_fields(g):
    """A JAX ``GaussianProcess`` as the plain data of
    ``convert.gaussian_process_from_numpy``."""
    st = g.state
    state = None if st is None else {
        "X": st.X, "y": st.y, "mask": st.mask, "L": _np(st.L),
        "ls": _np(st.ls), "var": _np(st.var), "noise": _np(st.noise),
        "Linv": _np(st.Linv), "n": st.n, "y_mean": st.y_mean,
        "y_std": st.y_std}
    return {"dim": g.dim, "fit_steps": g.fit_steps,
            "warm_fit_steps": g.warm_fit_steps,
            "refit_every": g.refit_every, "track_factor": g.track_factor,
            "n_fit": g.n_fit, "state": state,
            "fit_params": None if g._fit_params is None else {
                k: _np(v) for k, v in g._fit_params.items()},
            "obs_X": g._obs_X, "obs_y": g._obs_y}


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _same_host_state(ts, js):
    assert ts.n == js.n
    assert ts.y_mean == js.y_mean and ts.y_std == js.y_std
    np.testing.assert_array_equal(ts.X.numpy(), js.X)
    np.testing.assert_array_equal(ts.mask.numpy(), js.mask)


@pytest.mark.parametrize("track", [False, True])
def test_fit_matches_jax(track):
    """A cold fit then a warm refit (the schedule ``observe`` runs): the
    log-hypers to 5e-4, n_fit and the host state exact."""
    X, y = _data(24)
    jg = j_gp.GaussianProcess(2, fit_steps=20, refit_every=4,
                              track_factor=track)
    tg = t_gp.GaussianProcess(2, fit_steps=20, refit_every=4,
                              track_factor=track, device="cpu")
    for n in (16, 24):            # 24 - 16 >= refit_every: a warm refit
        js, ts = jg.observe(X[:n], y[:n]), tg.observe(X[:n], y[:n])
        assert tg.n_fit == jg.n_fit == n
        for k in ("log_ls", "log_var", "log_noise"):
            np.testing.assert_allclose(tg._fit_params[k].numpy(),
                                       _np(jg._fit_params[k]), atol=5e-4)
        _same_host_state(ts, js)
        np.testing.assert_array_equal(ts.y.numpy(), js.y)
        assert (ts.Linv is None) == (js.Linv is None) == (not track)
    assert tg.export_state()["n_fit"] == 24


@pytest.mark.parametrize("track", [False, True])
def test_restore_exact_both_ways(track):
    """A snapshot of either package rebuilds the other's state: L from the
    same hyperparameters to 1e-5 of its largest entry, after 12 replayed
    appends (a buffer growth 16 -> 32 among them) to 1e-4; L^-1 to 1e-4
    (the triangular inverse adds L's conditioning to the rounding); the
    snapshot JSON-identical after a round trip."""
    X, y = _data(28, seed=1)
    jg = j_gp.GaussianProcess(2, fit_steps=10, refit_every=100,
                              track_factor=track)
    jg.fit(X[:16], y[:16])
    snap = json.loads(json.dumps(jg.export_state()))
    tg = t_gp.GaussianProcess(2, fit_steps=10, refit_every=100,
                              track_factor=track, device="cpu")
    for n, rel in ((16, 1e-5), (28, 1e-4)):
        js = j_gp.GaussianProcess(2, track_factor=track).restore_exact(
            X[:n], y[:n], snap)
        ts = tg.restore_exact(X[:n], y[:n], snap)
        _same_host_state(ts, js)
        _close(ts.y.numpy(), js.y, 1e-6)
        _close(ts.L.numpy(), _np(js.L), rel)
        if track:
            _close(ts.Linv.numpy(), _np(js.Linv), 1e-4)
    assert tg.export_state() == snap
    back = j_gp.GaussianProcess(2, track_factor=track).restore_exact(
        X, y, json.loads(json.dumps(tg.export_state())))
    _close(_np(back.L), ts.L.numpy(), 1e-4)


def test_convert_round_trip_and_pick_from_one_state():
    """A JAX-fitted GP moves to the port and back unchanged, and its
    predictions there match the JAX package's (1e-4 of their scale)."""
    X, y = _data(20, seed=2)
    jg = j_gp.GaussianProcess(2, fit_steps=15, track_factor=True)
    jg.observe(X, y)
    tg = convert.gaussian_process_from_numpy(_jax_fields(jg), device="cpu")
    back = convert.gaussian_process_to_numpy(tg)
    fields = _jax_fields(jg)
    for k in convert.GP_FIELDS:
        assert back[k] == fields[k]
    for k in convert.GP_STATE_ARRAYS:
        np.testing.assert_array_equal(back["state"][k], fields["state"][k])
    assert tg.export_state() == jg.export_state()
    C = np.random.default_rng(3).uniform(size=(50, 2)).astype(np.float32)
    (jm, jsd), (tm, tsd) = jg.predict(C), tg.predict(C)
    _close(tm, jm, 1e-4)
    _close(tsd, jsd, 1e-4)
    # observe with no new rows keeps the converted state (no refit)
    assert tg.observe(X, y) is tg.state and tg.n_fit == 20


def test_hallucinate_and_growth_match_jax():
    """Hallucinated rows (the phantom y at the posterior mean) across the
    16 -> 32 growth boundary: y to 1e-4 relative, L to 1e-4 of its
    largest entry, the GP-BUCB invariant (mean fixed, variance shrinks)."""
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(15, 1)).astype(np.float32)
    y = rng.normal(size=15).astype(np.float32)
    jg = j_gp.GaussianProcess(1, fit_steps=10)
    jst = jg.fit(X, y)
    tg = convert.gaussian_process_from_numpy(_jax_fields(jg), device="cpu")
    tst = tg.state
    probe = np.array([[0.5], [0.9]], np.float32)
    mu0, sd0 = tg.predict(probe, tst)
    for x in rng.uniform(size=(4, 1)).astype(np.float32):
        jst, tst = jg.hallucinate(jst, x), tg.hallucinate(tst, x)
    assert tst.n == jst.n == 19 and tst.X.shape[0] == 32
    _close(tst.y.numpy(), jst.y, 1e-4)
    _close(tst.L.numpy(), _np(jst.L), 1e-4)
    mu1, sd1 = tg.predict(probe, tst)
    np.testing.assert_allclose(mu1, mu0, atol=2e-3)
    assert (sd1 <= sd0 + 1e-6).all()


def test_observe_refit_rules_match_jax():
    """The refit schedule: appends below ``refit_every``, a refit on a
    rewritten prefix, a shrink, and the degenerate-standardization guard
    (constant first values, then a differing one), decided as the JAX
    package decides."""
    X, y = _data(20, seed=5)
    yc = np.zeros(20, np.float32)
    yc[8:] = 0.1
    for ys, steps in ((y, [(20, None), (20, 0), (10, None)]),
                      (yc, [(6, None), (8, None)])):
        jg = j_gp.GaussianProcess(2, fit_steps=8, refit_every=100)
        tg = t_gp.GaussianProcess(2, fit_steps=8, refit_every=100,
                                  device="cpu")
        for n, bump in steps:
            yy = ys[:n].copy()
            if bump is not None:
                yy[bump] += 1.0
            jg.observe(X[:n], yy)
            tg.observe(X[:n], yy)
            assert tg.n_fit == jg.n_fit and tg.state.n == jg.state.n


def test_posterior_and_chol_append_match_jax():
    """``posterior`` and ``chol_append`` / ``chol_factor_append`` on one
    state: moments and the appended row to 1e-4 of their scale."""
    X, y = _data(20, seed=6)
    jg = j_gp.GaussianProcess(2, fit_steps=10, track_factor=True)
    js = jg.fit(X, y)
    ts = convert.gp_state_from_numpy(_jax_fields(jg)["state"], "cpu")
    C = np.random.default_rng(4).uniform(size=(40, 2)).astype(np.float32)
    jm, jv = j_gp.posterior(js.X, js.y, js.mask, js.L, C, js.ls, js.var,
                            js.noise)
    tm, tv = t_gp.posterior(ts.X, ts.y, ts.mask, ts.L,
                            convert.torch.as_tensor(C), ts.ls, ts.var,
                            ts.noise)
    _close(tm.numpy(), _np(jm), 1e-4)
    _close(tv.numpy(), _np(jv), 1e-4)
    x = convert.torch.as_tensor(C[0])
    jL, _, _ = j_gp.chol_append(js.L, js.X, js.mask, 20, C[0], js.ls,
                                js.var, js.noise)
    tL, _, tmask = t_gp.chol_append(ts.L, ts.X, ts.mask, 20, x, ts.ls,
                                    ts.var, ts.noise)
    _close(tL.numpy()[20], _np(jL)[20], 1e-4)
    assert tmask[20] == 1.0 and ts.mask[20] == 0.0   # inputs untouched
    jL2, jLi2, _, _ = j_gp.chol_factor_append(
        js.L, js.Linv, js.X, js.mask, 20, C[0], js.ls, js.var, js.noise)
    tL2, tLi2, _, _ = t_gp.chol_factor_append(
        ts.L, ts.Linv, ts.X, ts.mask, 20, x, ts.ls, ts.var, ts.noise)
    _close(tL2.numpy(), _np(jL2), 1e-4)
    _close(tLi2.numpy(), _np(jLi2), 1e-4)
    # the legacy K^-1 path and the diagonal condition bound
    Kinv = t_gp.kinv_from_chol(ts.L)
    _close(Kinv.numpy(), _np(j_gp.kinv_from_chol(js.L)), 1e-4)
    from repro.core import scoring as j_scoring
    _close(t_scoring.cond_proxy_from_chol(ts.L, ts.mask).numpy(),
           _np(j_scoring.cond_proxy_from_chol(js.L, js.mask)), 1e-4)


def test_gp_reference_behaviour():
    """The JAX package's own GP cases on the port: the posterior
    interpolates and grows away from the data; a fit recovers a signal's
    scale."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(24, 2)).astype(np.float32)
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1]
    gp = t_gp.GaussianProcess(dim=2, device="cpu")
    gp.fit(X, y)
    mu, sd = gp.predict(X)
    assert np.abs(mu - y).max() < 0.25
    _, sd_far = gp.predict(np.full((4, 2), 5.0, np.float32))
    assert sd_far.mean() > sd.mean()
    X1 = rng.uniform(size=(48, 1)).astype(np.float32)
    g1 = t_gp.GaussianProcess(dim=1, device="cpu")
    g1.fit(X1, 3.0 * np.sin(8 * X1[:, 0]))
    grid = np.linspace(0, 1, 50, dtype=np.float32)[:, None]
    m1, _ = g1.predict(grid)
    assert np.abs(m1 - 3.0 * np.sin(8 * grid[:, 0])).mean() < 0.5
