"""PyTorch port, GP scoring: the numerics of the split-TF32 tensor-core kernel
``score_cov``, written out in plain PyTorch (``ref.score_cov_split``), against
the JAX package's Pallas kernel ``score_cov_pallas`` in interpret mode and the
float64 direct posterior ``var + noise - k K^-1 k^T`` (as
``tests/test_kernels.py`` holds the Pallas kernel to it), on the same inputs
made with numpy from a seed.

The kernel computes K and mu = K alpha in fp32 on the CUDA cores and the
triangular product t = K L^-T on the tensor cores: each fp32 operand x split
into hi = x with its 13 low bits cleared and lo = x - hi, lo.hi + hi.lo + hi.hi
per 8-deep k-step, summed by the tensor cores, which align their addends to
the largest and cut them toward zero (``tc_numerics.mma_step``); then
q = sum_j t_j^2 in fp32 and sig2 = max(var + noise - q, 1e-10).

Chain.  The kernel keeps one accumulator for each 64-column tile of t over
the whole contraction (``chain=None``), the longest chain there is: it lets
the tensor cores run a tile's products back to back, and this emulation
finds it inside both tolerances below at na 256 (noise 1e-3 and 1e-6) and at
na 1024, where its error is several times that of a fresh accumulator each
k-step and still well inside.  One TF32 pass (hi.hi alone) misses the sig2
tolerance at every case, which is why the kernel splits.

Tolerances: those of ``chip_smoke.kernel_errors`` against the Pallas kernel
(sig2 1e-4 of var + noise, mu 1e-5 of sum_j |K_ij alpha_j|, K 8 eps32
(|c|^2 + |x|^2) var), and 2e-5 against the float64 direct posterior,
``tests/test_kernels.py``'s bound for the Pallas kernel.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from repro.kernels.gp_acquisition.gp_acquisition import score_cov_pallas
from repro_torch.kernels.gp_acquisition import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
DIRECT_TOL = 2e-5


def _matern(A, B, var):
    d2 = (A * A).sum(-1)[:, None] + (B * B).sum(-1)[None, :] - 2.0 * A @ B.T
    s = np.sqrt(5.0) * np.sqrt(np.maximum(d2, 1e-12))
    return var * (1.0 + s + (5.0 / 3.0) * d2) * np.exp(-s)


def _jax_test_system(n=64, d=5, S=512, seed=0):
    """``tests/test_kernels.py``'s GP system (n 64, d 5, S 512, var 1.3,
    noise 0.01, the last quarter of the rows masked) as one study, in numpy;
    with the float64 training covariance for the direct posterior."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[n - n // 4:] = 0.0
    ls = np.full(d, 0.5, np.float32)
    var, noise = 1.3, 0.01
    K = _matern((X / ls).astype(float), (X / ls).astype(float), var)
    K = K * mask[:, None] * mask[None, :]
    K[np.diag_indices(n)] = np.where(mask > 0, var + noise + 1e-6, 1.0)
    L = np.linalg.cholesky(K).astype(np.float32)
    Linv = sla.solve_triangular(L, np.eye(n, dtype=np.float32),
                                lower=True).astype(np.float32)
    y = (rng.normal(size=n) * mask).astype(np.float32)
    C = rng.uniform(size=(S, d)).astype(np.float32)
    Cs = np.zeros((S, 8), np.float32)
    Cs[:, :d] = C / ls
    Xs = np.zeros((n, 8), np.float32)
    Xs[:, :d] = X / ls
    alpha = (Linv.T @ (Linv @ y)).astype(np.float32)
    t = [torch.as_tensor(a[None]) for a in (Cs, Xs, mask, Linv, alpha)]
    t += [torch.tensor([var], dtype=torch.float32),
          torch.tensor([noise], dtype=torch.float32)]
    return t, torch.as_tensor(K[None])


def _bank_system(S, na, n_act, noise):
    """``chip_smoke.gp_system`` (the port's own factors) for two studies;
    the training covariance is L L^T in float64."""
    g = chip_smoke.gp_system(2, S, na, n_act, 6, seed=7, dev="cpu",
                             noise=noise)
    L = g["L"].double()
    return ([g[k] for k in ("Cs", "Xs", "mask", "Linv", "alpha", "var",
                            "noise")], L @ L.transpose(-1, -2))


# (id, maker): the JAX test system; the fleet bucket na 256 at the fleet's
# noise and at a collapsed noise; phase 2's streamed bucket na 1024
CASES = [
    ("jax-test-n64", lambda: _jax_test_system()),
    ("na256-noise1e-3", lambda: _bank_system(256, 256, 212, (1e-3, 1e-2))),
    ("na256-noise1e-6", lambda: _bank_system(256, 256, 212, (1e-6, 1e-5))),
    ("na1024", lambda: _bank_system(128, 1024, 1000, (1e-3, 1e-2))),
]


def _direct_sig2(K, Ktrain, var, noise):
    """var + noise - k K^-1 k^T in float64 from the cross-covariance block K
    (B, S, na) and the training covariance (B, na, na)."""
    K64 = K.double()
    q = (K64 @ torch.linalg.inv(Ktrain) * K64).sum(-1)
    return torch.clamp((var + noise).double()[:, None] - q, min=1e-10)


def _sig2_tol(var, noise):
    return 1e-4 * float((var + noise).max())


@pytest.mark.parametrize("make", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_split_design_fits_pallas_and_the_direct_posterior(make):
    args, Ktrain = make()
    Cs, Xs, mask, Linv, alpha, var, noise = args
    mu, sig2, K = ref.score_cov_split(*args)
    assert torch.isfinite(sig2).all() and (sig2 > 0).all()
    direct = _direct_sig2(K, Ktrain, var, noise)
    assert float((sig2.double() - direct).abs().max()) <= DIRECT_TOL
    S = Cs.shape[1]
    c2x2 = float((Cs * Cs).sum(-1).max() + (Xs * Xs).sum(-1).max())
    k_tol = 8 * EPS32 * c2x2 * float(var.max())
    for b in range(Cs.shape[0]):
        mu_p, sig2_p, K_p = score_cov_pallas(
            *(jnp.asarray(t[b].numpy()) for t in (Cs, Xs, mask, Linv,
                                                   alpha)),
            jnp.float32(var[b]), jnp.float32(noise[b]), block_s=S,
            interpret=True)
        mu_tol = 1e-5 * float((K[b].abs() @ alpha[b].abs()).max())
        np.testing.assert_allclose(sig2[b], np.asarray(sig2_p),
                                   atol=_sig2_tol(var, noise))
        np.testing.assert_allclose(mu[b], np.asarray(mu_p), atol=mu_tol)
        np.testing.assert_allclose(K[b], np.asarray(K_p), atol=k_tol)


@pytest.mark.parametrize("make", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_one_tf32_pass_misses_the_sig2_tolerance(make):
    """On the same inputs, the kernel's split meets the card's sig2
    tolerance against the direct posterior and one TF32 pass does not."""
    args, Ktrain = make()
    var, noise = args[5], args[6]
    _, split, K = ref.score_cov_split(*args)
    _, one_pass, _ = ref.score_cov_split(*args, passes=1)
    direct = _direct_sig2(K, Ktrain, var, noise)
    tol = _sig2_tol(var, noise)
    assert float((split.double() - direct).abs().max()) <= tol
    assert float((one_pass.double() - direct).abs().max()) > tol
