"""PyTorch port, GP-BUCB kernels: the plain versions against the JAX package's
Pallas kernels (interpret mode) and jnp oracles on the same numpy inputs, the
CPU dispatch of ``ops``, and (on a card) each CUDA kernel against its plain
version.

Tolerances: both sides compute in float32 and sum their products in XLA's
and PyTorch's orders.  sig2 agrees to 1e-4 (absolute, on unit-scale
signals), the JAX package's own kernel-vs-oracle tolerance; mu = K alpha
cancels large terms when the noise is small, so it agrees to 1e-5 of the
largest sum of absolute terms sum_j |K_ij alpha_j| (``_mu_tol``).  K and k(C, x*):
the JAX package's squared distance |c|^2 + |x|^2 - 2 c.x rounds to a few
ulps of |c|^2 + |x|^2 (the port sums the differences), which moves K by at
most (5/6) var per unit, so they agree to ``_k_tol``: 8 eps32
(|c|^2 + |x|^2)_max var_max.  Against float64, on rows a short lengthscale
makes long, the port's K is held far tighter (``_long_rows``).

JAX is imported inside the tests that compare with it, so the card test
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels.py
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.gp_acquisition import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _jax():
    """The JAX reference: jax.numpy, the Pallas kernels, the jnp oracles."""
    import jax.numpy as jnp

    from repro.kernels.gp_acquisition import gp_acquisition, ref as jref
    return jnp, gp_acquisition, jref

CASES = [  # (n, n_act, d, S): ragged S, masked tails, dp from 8 to 24
    (16, 11, 2, 100),
    (32, 32, 5, 300),
    (64, 40, 6, 512),
    (32, 20, 19, 77),
]


def _matern(A, B, var):
    d2 = (A * A).sum(-1)[:, None] + (B * B).sum(-1)[None, :] - 2.0 * A @ B.T
    s = math.sqrt(5.0) * np.sqrt(np.maximum(d2, 1e-12))
    return var * (1.0 + s + (5.0 / 3.0) * d2) * np.exp(-s)


def _system(B, n, n_act, d, S, seed=0):
    """Prescaled, padded GP systems for B studies, factors built in float64
    numpy (independent of both packages)."""
    rng = np.random.default_rng(seed)
    dp = max(8, -(-d // 8) * 8)
    Xs = np.zeros((B, n, dp), np.float32)
    Cs = np.zeros((B, S, dp), np.float32)
    mask = np.zeros((B, n), np.float32)
    mask[:, :n_act] = 1.0
    Linv = np.zeros((B, n, n), np.float32)
    K = np.zeros((B, n, n))
    alpha = np.zeros((B, n), np.float32)
    var = rng.uniform(0.5, 2.0, B).astype(np.float32)
    noise = rng.uniform(1e-3, 1e-1, B).astype(np.float32)
    for b in range(B):
        ls = rng.uniform(0.2, 0.8, d)
        Xs[b, :n_act, :d] = rng.uniform(size=(n_act, d)) / ls
        Cs[b, :, :d] = rng.uniform(size=(S, d)) / ls
        Kb = _matern(Xs[b].astype(float), Xs[b].astype(float), var[b])
        Kb *= mask[b][:, None] * mask[b][None, :]
        np.fill_diagonal(Kb, np.where(mask[b] > 0, var[b] + noise[b] + 1e-6
                                      * max(var[b], 1.0), 1.0))
        K[b] = Kb
        Li = np.tril(np.linalg.inv(np.linalg.cholesky(Kb)))
        Linv[b] = Li
        y = rng.normal(size=n) * mask[b]
        alpha[b] = Li.T @ (Li @ y)
    return dict(Cs=Cs, Xs=Xs, mask=mask, Linv=Linv, alpha=alpha, var=var,
                noise=noise, K=K)


def _k_tol(s):
    c2x2 = ((s["Cs"] ** 2).sum(-1).max() + (s["Xs"] ** 2).sum(-1).max())
    return 8 * np.finfo(np.float32).eps * c2x2 * s["var"].max()


def _mu_tol(K, alpha):
    return 1e-5 * float((np.abs(K) @ np.abs(alpha)).max())


def _pad_rows(a, m):
    a = np.asarray(a)
    return np.pad(a, [(0, m - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _port_scores(s):
    return ref.score_cov_ref(_t(s["Cs"]), _t(s["Xs"]), _t(s["mask"]),
                             _t(s["Linv"]), _t(s["alpha"]), _t(s["var"]),
                             _t(s["noise"]))


@pytest.mark.parametrize("n,n_act,d,S", CASES)
def test_score_cov_plain_matches_pallas_and_oracle(n, n_act, d, S):
    jnp, pallas, jref = _jax()
    s = _system(3, n, n_act, d, S)
    mu, sig2, K = (x.numpy() for x in _port_scores(s))
    blk = 64
    Sp = -(-S // blk) * blk
    for b in range(3):
        args = (s["Xs"][b], s["mask"][b], s["Linv"][b], s["alpha"][b])
        mu_p, sig2_p, K_p = pallas.score_cov_pallas(
            jnp.asarray(_pad_rows(s["Cs"][b], Sp)), *map(jnp.asarray, args),
            jnp.float32(s["var"][b]), jnp.float32(s["noise"][b]),
            block_s=blk, interpret=True)
        mu_o, sig2_o, K_o = jref.score_cov_ref(
            jnp.asarray(s["Cs"][b]), *map(jnp.asarray, args), 1.0,
            s["var"][b], s["noise"][b])
        tols = (_mu_tol(K[b], s["alpha"][b]), 1e-4)
        for got, pal, orc, tol in ((mu[b], mu_p, mu_o, tols[0]),
                                   (sig2[b], sig2_p, sig2_o, tols[1])):
            np.testing.assert_allclose(got, np.asarray(pal)[:S], atol=tol)
            np.testing.assert_allclose(got, np.asarray(orc), atol=tol)
        np.testing.assert_allclose(K[b], np.asarray(K_p)[:S], atol=_k_tol(s))
        np.testing.assert_allclose(K[b], np.asarray(K_o), atol=_k_tol(s))
        assert np.all(K[b][:, n_act:] == 0.0)      # masked tail


@pytest.mark.parametrize("n,n_act,d,S", CASES)
def test_var_downdate_plain_matches_pallas_and_oracle(n, n_act, d, S):
    jnp, pallas, jref = _jax()
    s = _system(2, n, n_act, d, S, seed=1)
    mu, sig2, K = _port_scores(s)
    star = np.array([5, S - 1])
    u = np.zeros((2, n), np.float32)
    schur = np.zeros(2, np.float32)
    Kn = K.numpy()
    for b in range(2):
        k_star = Kn[b, star[b]].astype(float)
        act = s["mask"][b] > 0
        ub = np.zeros(n)
        ub[act] = np.linalg.solve(s["K"][b][np.ix_(act, act)], k_star[act])
        u[b] = ub
        schur[b] = s["var"][b] + s["noise"][b] + 1e-6 - k_star @ ub
    x_star = s["Cs"][np.arange(2), star]
    slot = torch.full((2,), n_act if n_act < n else n - 1,
                      dtype=torch.int32)
    Kc = K.clone()
    n0 = ops.launches["var_downdate"]
    sig2_d, knew = ops.var_downdate(
        _t(s["Cs"]), _t(x_star), Kc, _t(u), _t(schur), sig2, _t(s["var"]),
        slot=slot)
    assert ops.launches["var_downdate"] == n0       # CPU: plain version
    for b in range(2):
        args = (jnp.asarray(s["Cs"][b]), jnp.asarray(x_star[b]),
                jnp.asarray(Kn[b]), jnp.asarray(u[b]),
                jnp.float32(schur[b]), jnp.asarray(sig2[b].numpy()))
        Sp = -(-S // 64) * 64
        sd_p, kn_p = pallas.var_downdate_pallas(
            jnp.asarray(_pad_rows(args[0], Sp)), args[1],
            jnp.asarray(_pad_rows(args[2], Sp)), args[3], args[4],
            jnp.asarray(_pad_rows(args[5], Sp)),
            jnp.float32(s["var"][b]), block_s=64, interpret=True)
        sd_o, kn_o = jref.var_downdate_ref(*args, 1.0, s["var"][b])
        np.testing.assert_allclose(sig2_d[b], np.asarray(sd_p)[:S],
                                   atol=1e-4)
        np.testing.assert_allclose(sig2_d[b], np.asarray(sd_o), atol=1e-4)
        np.testing.assert_allclose(knew[b], np.asarray(kn_p)[:S],
                                   atol=_k_tol(s))
        np.testing.assert_allclose(knew[b], np.asarray(kn_o), atol=_k_tol(s))
        # the slot column now holds k(C, x*); every other column is intact
        col = int(slot[b])
        np.testing.assert_array_equal(Kc[b, :, col], knew[b])
        keep = np.arange(n) != col
        np.testing.assert_array_equal(Kc[b][:, keep], K[b][:, keep])


def test_cpu_dispatch_runs_plain_version_and_counts_nothing():
    s = _system(2, 16, 9, 3, 40)
    before = dict(ops.launches)
    args = [_t(s[k]) for k in ("Cs", "Xs", "mask", "Linv", "alpha", "var",
                               "noise")]
    got = ops.score_cov(*args)
    want = ref.score_cov_ref(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.launches == before


@pytest.mark.parametrize("bad", ["dtype", "contig", "dp", "shape"])
def test_ops_reject_malformed_inputs(bad):
    s = _system(2, 16, 9, 3, 40)
    args = {k: _t(s[k]) for k in ("Cs", "Xs", "mask", "Linv", "alpha", "var",
                                  "noise")}
    if bad == "dtype":
        args["alpha"] = args["alpha"].double()
    elif bad == "contig":
        args["Linv"] = args["Linv"].transpose(1, 2)
    elif bad == "dp":
        args["Cs"] = args["Cs"][..., :5].contiguous()
        args["Xs"] = args["Xs"][..., :5].contiguous()
    else:
        args["mask"] = args["mask"][:, :8].contiguous()
    with pytest.raises((TypeError, ValueError)):
        ops.score_cov(*args.values())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,na,n_act,d", [
    (3, 100, 16, 11, 2),        # ragged S, one partial block, one k-slab
    (2, 300, 32, 31, 5),        # one masked slot, one k-slab
    (3, 512, 64, 40, 19),       # dp = 24
    (2, 517, 256, 212, 6),      # the fleet bucket: K resident, ragged S
    (2, 300, 256, 200, 60),     # dp = 64: K streamed at the fleet bucket
    (2, 700, 512, 400, 6),      # K streamed back from global memory
    (2, 2000, 1024, 900, 6),    # the same at phase 2's largest bucket
])
def test_cuda_kernels_match_plain_versions(B, S, na, n_act, d):
    """Each CUDA kernel against its plain version on the card, with the
    tolerances ``chip_smoke.kernel_errors`` states; launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n0 = dict(ops.launches)
    errs, _ = chip_smoke.kernel_errors(B, S, na, n_act, d,
                                       torch.device("cuda"))
    torch.cuda.synchronize()
    # the pick kernels once each, and K once for the system's factors
    once = ("score_cov", "var_downdate", "masked_kernel")
    assert ops.launches == {k: v + (k in once) for k, v in n0.items()}
    for name, (err, tol) in errs.items():
        assert err <= tol, (name, err, tol)


def _long_rows(dev):
    """Prescaled candidates near prescaled observations (B 1, na 64, S 128,
    dp 8) under lengthscales down to 0.0147, which make |x|^2 ~ 5e3: the
    expanded squared distance loses ~1e-3 of K to cancellation there."""
    rng = np.random.default_rng(11)
    ls = np.array([0.0478, 10, 4.12, 10, 0.0147, 10, 1, 1], np.float32)
    X = rng.uniform(size=(1, 64, 8)) / ls
    C = X[:, rng.integers(0, 64, 128)] + rng.normal(scale=0.3,
                                                     size=(1, 128, 8))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    return t(C), t(X), t([0.78])


def test_squared_distance_keeps_long_rows():
    """The plain Matern in float32 on long prescaled rows within 2e-6 var
    of the same function in float64: d2 is summed from the differences."""
    Cs, Xs, var = _long_rows("cpu")
    want = ref.matern52(Cs.double(), Xs.double(), var.double())
    assert float((ref.matern52(Cs, Xs, var) - want).abs().max()) <= 2e-6 * 0.78


@pytest.mark.cuda
def test_cuda_squared_distance_keeps_long_rows():
    """``score_cov``'s K and ``var_downdate``'s k(C, x*) on long prescaled
    rows within 2e-6 var of the float64 Matern, as the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    Cs, Xs, var = _long_rows(dev)
    na = Xs.shape[1]
    mask = torch.ones((1, na), device=dev)
    Linv = torch.eye(na, device=dev)[None].contiguous()
    zero = torch.zeros((1, na), device=dev)
    _, _, K = ops.score_cov(Cs, Xs, mask, Linv, zero, var, var * 0 + 1e-3)
    x_star = Xs[:, 5].contiguous()
    sig2 = torch.ones((1, Cs.shape[1]), device=dev)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    _, knew = ops.var_downdate(Cs, x_star, K.clone(), zero, var, sig2, var,
                               slot=slot)
    want = ref.matern52(Cs.double(), Xs.double(), var.double())
    want_new = ref.matern52(Cs.double(), x_star[:, None].double(),
                            var.double())[..., 0]
    assert float((K.double() - want).abs().max()) <= 2e-6 * 0.78
    assert float((knew.double() - want_new).abs().max()) <= 2e-6 * 0.78


@pytest.mark.cuda
def test_cuda_score_cov_is_deterministic_and_its_sqrt_exact():
    """score_cov's kernel gives bitwise-equal outputs on two runs (no
    atomics), and its branch-free square root equals sqrtf on every float
    from 1e-12 (the floor of max(d2, 1e-12)) to the largest finite one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ops.sqrt_mismatches() == 0
    g = chip_smoke.gp_system(2, 517, 256, 212, 6, seed=3,
                             dev=torch.device("cuda"))
    args = [g[k] for k in ("Cs", "Xs", "mask", "Linv", "alpha", "var",
                           "noise")]
    first, second = ops.score_cov(*args), ops.score_cov(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
