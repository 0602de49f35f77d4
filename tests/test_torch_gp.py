"""PyTorch port, GP stages of the bank pipeline against the JAX package's
stages on the same numpy inputs (CPU, float32 on both sides, x64 off).

Tolerances are stated per test.  Both sides round the same float32 formulas
but sum matrix products in different orders (XLA vs PyTorch/LAPACK), so the
factors agree to about 100 ulps of their largest entries; the fit carries
those differences through 40 Adam steps.  Picks are compared under the
near-tie rule of ``chip_smoke.picks_agree``.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as j_gp
from repro.core import scoring as j_scoring
from repro_torch import convert
from repro_torch.core import gp as t_gp
from repro_torch.core import scoring as t_scoring

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, NA, D = 3, 32, 3
N_OBS = np.array([20, 25, 12])


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor)
                      else a)


def _obs(seed=0):
    """Masked observation buckets and frozen hypers for B studies."""
    rng = np.random.default_rng(seed)
    X = np.zeros((B, NA, D), np.float32)
    y = np.zeros((B, NA), np.float32)
    mask = np.zeros((B, NA), np.float32)
    for b, k in enumerate(N_OBS):
        X[b, :k] = rng.uniform(size=(k, D))
        y[b, :k] = np.sin(6 * X[b, :k, 0]) + X[b, :k, 1] \
            + 0.05 * rng.normal(size=k)
        mask[b, :k] = 1.0
    ls = rng.uniform(0.2, 0.6, (B, D)).astype(np.float32)
    var = rng.uniform(0.6, 1.5, B).astype(np.float32)
    noise = rng.uniform(5e-3, 5e-2, B).astype(np.float32)
    return dict(X=X, y=y, mask=mask, ls=ls, var=var, noise=noise)


def _factors(o):
    j = jax.device_get(j_gp.bank_factors(o["X"], o["mask"], o["ls"],
                                         o["var"], o["noise"]))
    t = t_gp.bank_factors(*(_t(o[k]) for k in ("X", "mask", "ls", "var",
                                               "noise")))
    return j, t


def _factors64(o):
    """L and L^-1 in float64 from the same float32 inputs."""
    d = {k: _t(o[k]).double() for k in ("X", "mask", "ls", "var", "noise")}
    L = t_gp.cholesky_masked(d["X"], d["mask"], d["ls"], d["var"],
                             d["noise"])
    return _np(L), _np(t_scoring.linv_from_chol(L))


def test_bank_factors_match_jax():
    """L and L^-1 to 1e-5 of their largest entries (float32 Cholesky and
    triangular solve in two libraries, about 100 ulps); the power-iteration
    condition estimate to 1e-3 relative (16 steps carry the factor's
    rounding).  The port sums K's squared distances from the differences,
    the JAX package expands |x|^2 + |y|^2 - 2 x.y, so where the two K differ
    by more than the factors' rounding (L^-1 here: the JAX package's is 2e-5
    of its largest entry from the float64 one) L^-1 is held to the float64
    factor at the same 1e-5, and to no larger a gap than the JAX package's."""
    o = _obs()
    (jL, jLi, jc), (tL, tLi, tc) = _factors(o)
    L64, Li64 = _factors64(o)
    np.testing.assert_allclose(_np(tL), jL, atol=1e-5 * np.abs(jL).max())
    for j, t, r in ((jL, tL, L64), (jLi, tLi, Li64)):
        gap = np.abs(_np(t) - r).max()
        assert gap <= 1e-5 * np.abs(r).max()
        assert gap <= np.abs(j - r).max()
    np.testing.assert_allclose(_np(tc), jc, rtol=1e-3)
    # padded slots stay identity, the upper triangles exactly zero
    for b, k in enumerate(N_OBS):
        np.testing.assert_array_equal(_np(tL)[b, k:, k:], np.eye(NA - k))
        np.testing.assert_array_equal(np.triu(_np(tLi)[b], 1), 0.0)


def test_prescale_is_bitwise():
    """Division by the lengthscales and zero padding are exact, so the
    prescaled blocks are bit-identical."""
    o = _obs()
    C = np.random.default_rng(3).uniform(size=(B, 50, D)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(t_gp.bank_prescale_X(_t(o["X"]), _t(o["ls"]))),
        np.asarray(j_gp.bank_prescale_X(o["X"], o["ls"])))
    np.testing.assert_array_equal(
        _np(t_gp.bank_prescale_C(_t(C), _t(o["ls"]))),
        np.asarray(j_gp.bank_prescale_C(C, o["ls"])))


def test_factor_append_matches_jax():
    """One hardened append per study from the same (L, L^-1) and column:
    the new rows, u and the Schur complement to 1e-4 relative (float32
    matvecs with one refinement step on both sides)."""
    o = _obs()
    (jL, jLi, _), _ = _factors(o)
    Xs = np.asarray(j_gp.bank_prescale_X(o["X"], o["ls"]))
    x_new = np.zeros((B, Xs.shape[2]), np.float32)
    x_new[:, :D] = np.random.default_rng(4).uniform(size=(B, D)) / o["ls"]
    k_vec = np.stack([np.asarray(j_scoring.matern52(
        Xs[b], x_new[b][None], 1.0, o["var"][b]))[:, 0] * o["mask"][b]
        for b in range(B)]).astype(np.float32)
    tL, tLi, tu, ts = t_scoring.factor_append(
        _t(jL).clone(), _t(jLi).clone(), _t(N_OBS), _t(k_vec), _t(o["var"]),
        _t(o["noise"]))
    for b in range(B):
        L2, Li2, u, schur = j_scoring.factor_append(
            jnp.asarray(jL[b]), jnp.asarray(jLi[b]), jnp.int32(N_OBS[b]),
            jnp.asarray(k_vec[b]), o["var"][b], o["noise"][b])
        k = N_OBS[b]
        for got, want in ((_np(tL)[b, k], L2[k]), (_np(tLi)[b, k], Li2[k]),
                          (_np(tu)[b], u)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want,
                                       atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(_np(ts)[b], float(schur), rtol=1e-4)
        # every other row untouched
        keep = np.arange(NA) != k
        np.testing.assert_array_equal(_np(tL)[b, keep], jL[b, keep])


def test_bank_absorb_matches_jax():
    """Pending absorption (posterior mean, append, phantom y) for 2, 0 and
    3 in-flight rows: tolerances as for ``factor_append``, the phantom y
    (a posterior mean) to 1e-4 of the largest |y|."""
    o = _obs()
    (jL, jLi, _), _ = _factors(o)
    Xs = np.asarray(j_gp.bank_prescale_X(o["X"], o["ls"]))
    z = o["y"] * o["mask"]
    P = np.random.default_rng(5).uniform(size=(B, 4, D)).astype(np.float32)
    kp = np.array([2, 0, 3], np.float32)
    ko = N_OBS.astype(np.float32)
    want = jax.device_get(j_gp.bank_absorb(
        Xs, z, o["mask"], jL, jLi, P, kp, ko, o["ls"], o["var"], o["noise"],
        pend_cap=4))
    got = t_gp.bank_absorb(_t(Xs), _t(z), _t(o["mask"]), _t(jL), _t(jLi),
                           _t(P), _t(kp), _t(ko), _t(o["ls"]), _t(o["var"]),
                           _t(o["noise"]))
    names = ("Xs", "y", "mask", "L", "Linv")
    for name, g, w in zip(names, got, want):
        if name in ("Xs", "mask"):
            np.testing.assert_array_equal(_np(g), w, err_msg=name)
        else:
            np.testing.assert_allclose(_np(g), w, err_msg=name,
                                       atol=1e-4 * np.abs(w).max())
    # the inputs were not modified (absorb works on copies)
    np.testing.assert_array_equal(z, o["y"] * o["mask"])


def test_fit_hypers_bank_matches_jax():
    """40 Adam steps from the cold init: the log-hypers to 5e-4 (absolute,
    in log space).  Each step's gradient differs in its last bits between
    the two autodiff systems, and Adam's normalized steps carry that
    forward."""
    o = _obs()
    ym = np.array([o["y"][b, :k].mean() for b, k in enumerate(N_OBS)],
                  np.float32)
    ys = np.array([o["y"][b, :k].std() + 1e-6 for b, k in enumerate(N_OBS)],
                  np.float32)
    init = (np.full((B, D), np.log(0.5), np.float32), np.zeros(B, np.float32),
            np.full(B, np.log(1e-2), np.float32))
    want = jax.device_get(j_gp.fit_hypers_bank(
        o["X"], o["y"], o["mask"], *init, ym, ys, steps=40))
    got = t_gp.fit_hypers_bank(_t(o["X"]), _t(o["y"]), _t(o["mask"]),
                               *map(_t, init), _t(ym), _t(ys), steps=40)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, atol=5e-4)
    # the fit moved away from the init
    assert np.abs(np.asarray(want[0]) - init[0]).max() > 0.05


def test_bank_pick_on_jax_fitted_state():
    """The port's pick stage fed the JAX bank's own fitted hypers and
    factors (through ``convert.bank_state_from_numpy``) picks what the JAX
    pick stage picks, up to near-ties judged by the float64 oracle."""
    from scipy import stats

    from repro.core import StudyBank as JBank

    space = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}
    bank = JBank(space, 4, seed=3, mc_samples=200)
    rng = np.random.default_rng(6)
    for b in range(4):
        for _ in range(10 + 5 * b):
            p = {"x": float(rng.uniform()), "y": float(rng.uniform(-1, 1))}
            bank.study(b).observe_params(
                p, np.sin(5 * p["x"]) * p["y"] + 0.1 * rng.normal())
    bank.ask_all(1)                       # fits, fills the obs-stage cache
    cache = bank._gp_cache
    arrays = {k: np.asarray(jax.device_get(cache[k]))
              for k in convert.BANK_STATE_KEYS}
    st = convert.bank_state_from_numpy(arrays, "cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in st.values())
    C = np.random.default_rng(7).uniform(size=(4, 200, 2)).astype(np.float32)
    C[..., 1] = C[..., 1] * 2 - 1
    C = ((C - np.array([0, -1], np.float32)) / np.array([1, 2], np.float32))
    C = C.astype(np.float32)             # encoded unit-cube candidates
    led = bank.ledger
    n_obs = led.n_observed().astype(np.float32)
    dom = np.float32(bank.study(0).domain_size)
    n = 3
    Cs_j = j_gp.bank_prescale_C(C, arrays["ls"])
    d2, s = j_gp.bank_dist(Cs_j, arrays["Xs"])
    want = np.asarray(j_gp.bank_pick(
        d2, s, j_gp.bank_exp(s), Cs_j, arrays["z"], arrays["mask"],
        arrays["L"], arrays["Linv"], arrays["var"], arrays["noise"], n_obs,
        dom, batch_size=n, S=C.shape[1]))
    Cs_t = t_gp.bank_prescale_C(_t(C), st["ls"])
    got = _np(t_gp.bank_pick(Cs_t, st["Xs"], st["z"], st["mask"], st["L"],
                             st["Linv"], st["var"], st["noise"], _t(n_obs),
                             _t(dom), batch_size=n))
    for b in range(4):
        ids = led.obs_ids(b)
        hyp = (arrays["ls"][b], arrays["var"][b], arrays["noise"][b])
        z = arrays["z"][b, :len(ids)]

        def oracle(prev, b=b, ids=ids, hyp=hyp, z=z):
            return chip_smoke.bucb_acquisition(led.X[b, ids], z, C[b], *hyp,
                                               prev, float(dom))

        ok, slot = chip_smoke.picks_agree(list(got[b]), list(want[b]),
                                          oracle)
        assert ok, (b, slot, got[b], want[b])


@pytest.mark.parametrize("t", [1, 7, 50])
def test_adaptive_beta_matches_host_schedule(t):
    """The device schedule equals the host ``acquisition.adaptive_beta``
    to float32 rounding."""
    from repro_torch.core.acquisition import adaptive_beta
    dom = 3200.0
    dev = t_scoring.adaptive_beta_dev(torch.tensor([float(t)]),
                                      torch.tensor(dom))
    np.testing.assert_allclose(float(dev[0]), adaptive_beta(t, dom),
                               rtol=1e-6)
