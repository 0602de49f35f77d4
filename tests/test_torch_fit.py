"""PyTorch port, the hyperparameter fit's closed-form gradient: each Adam
step of ``gp.fit_hypers_bank`` takes 0.5 sum_ij W_ij dK_ij / n_eff, W =
K^-1 - alpha alpha^T, through ``ops.fit_grad``.  Held against autograd of
the loss (``gp._nll``) in float64, the wrapper against the formula, a
study whose kernel matrix fails its factorization against the rest of
its bank, and (on a card) the CUDA kernel against its plain version.

This file imports nothing of JAX, so the card cases also run where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_fit.py
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.core import gp, scoring, telemetry
from repro_torch.core.studybank import StudyBank
from repro_torch.kernels import build
from repro_torch.kernels.gp_acquisition import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, D = 3, 3


def _system(n, log_var, log_noise=math.log(1e-2), dup=False, seed=0,
            dtype=torch.float64):
    """B studies at bucket n with ragged masks (n, n - 4, n // 2 + 1
    observed rows), a smooth signal, and log-hypers (B, D), (B,), (B,);
    ``dup`` repeats rows inside each study (r = 0 off the diagonal)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(B, n, D))
    if dup:
        X[:, 1] = X[:, 0]
        X[:, 5] = X[:, 3]
        X[:, 6] = X[:, 3]
    mask = np.zeros((B, n))
    for b, k in enumerate((n, n - 4, n // 2 + 1)):
        mask[b, :k] = 1.0
    X *= mask[..., None]
    y = (np.sin(5 * X[..., 0]) + X[..., 1] ** 2
         + 0.1 * rng.normal(size=(B, n))) * mask
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    log_ls = np.log(rng.uniform(0.2, 0.8, (B, D)))
    return (t(X), t(y), t(mask), t(log_ls), t(np.full(B, log_var)),
            t(np.full(B, log_noise)))


def _autograd(X, z, mask, n_eff, log_ls, log_var, log_noise):
    ps = [p.clone().requires_grad_(True) for p in (log_ls, log_var,
                                                    log_noise)]
    g = torch.autograd.grad(gp._nll(X, z, mask, n_eff, *ps).sum(), ps)
    return torch.cat([g[0], g[1][:, None], g[2][:, None]], -1)


# (n, log_var, log_noise, dup): na 16 / 128 / 512; cold (log var 0: var is
# exactly 1, where the jitter's clamp bends) and warm hypers with var on
# both sides of 1; a noise at the 1e-5 floor; duplicate rows
CASES = {
    "na16-cold": (16, 0.0, math.log(1e-2), False),
    "na128-var-above-1": (128, 0.6, math.log(3e-3), False),
    "na512-var-below-1": (512, -0.7, math.log(2e-2), False),
    "na128-var-1-tiny-noise": (128, 0.0, math.log(1e-7), False),
    "na64-duplicate-rows": (64, 0.3, math.log(1e-2), True),
    "na64-duplicate-rows-var-below-1": (64, -0.2, math.log(5e-2), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_closed_form_gradient_matches_autograd(case):
    """The closed-form step's gradient (``gp._nll_grad``: the factor, K^-1
    from its inverse, the contraction) against ``torch.autograd.grad`` of
    ``gp._nll``, both in float64.  Tolerance 1e-7 of each study's largest
    component: both sides compute the same function in float64, and they
    differ only through the conditioning of K (K^-1 from the factor against
    the Cholesky backward), ~1e-14 of it here."""
    n, log_var, log_noise, dup = CASES[case]
    X, y, mask, lls, lv, ln = _system(n, log_var, log_noise, dup)
    z = y * mask
    n_eff = torch.clamp(mask.sum(-1), min=1.0)
    want = _autograd(X, z, mask, n_eff, lls, lv, ln)
    got = gp._nll_grad(X, z, mask, n_eff, lls, lv, ln)
    assert got.shape == (B, D + 2) and got.dtype == torch.float64
    scale = want.abs().max(-1, keepdim=True).values
    assert torch.all((got - want).abs() <= 1e-7 * scale), (got - want) / scale
    assert torch.all(scale > 0)


def _formula(X, mask, Kinv, alpha, ls, var, noise_exp, n_eff):
    """The gradient pair by pair in float64 numpy, from the derivative of
    ``ref.matern52`` written out: the independent statement of what
    ``fit_grad`` computes."""
    X, mask, Kinv, alpha, ls, var, en, n_eff = (
        np.asarray(a, np.float64) for a in (X, mask, Kinv, alpha, ls, var,
                                            noise_exp, n_eff))
    Bn, n, d = X.shape
    out = np.zeros((Bn, d + 2))
    for b in range(Bn):
        v = var[b]
        for i in range(n):
            for j in range(n):
                w = Kinv[b, i, j] - alpha[b, i] * alpha[b, j]
                if i == j:
                    if mask[b, i] > 0:
                        out[b, d] += w * (v + (1e-6 * v if v >= 1 else 0))
                        out[b, d + 1] += w * en[b]
                    continue
                m = mask[b, i] * mask[b, j]
                u2 = ((X[b, i] - X[b, j]) / ls[b]) ** 2
                d2 = u2.sum()
                s = math.sqrt(5 * max(d2, 1e-12))
                e = math.exp(-s)
                out[b, d] += w * m * v * (1 + s + 5 / 3 * d2) * e
                g = (5 / 3 * v * (1 + s) * e if d2 >= 1e-12
                     else -10 / 3 * v * e)
                out[b, :d] += w * m * g * u2
    return 0.5 * out / n_eff[:, None]


def _grad_inputs(n, dtype, log_var=0.3, dup=True, seed=1):
    X, y, mask, lls, lv, ln = _system(n, log_var, dup=dup, seed=seed,
                                      dtype=dtype)
    ls, var, en = torch.exp(lls), torch.exp(lv), torch.exp(ln)
    L = gp.cholesky_masked(X, mask, ls, var, en + 1e-5)
    Linv = scoring.linv_from_chol(L)
    Kinv = Linv.mT @ Linv
    alpha = scoring.kinv_matvec(Linv, y * mask)
    n_eff = torch.clamp(mask.sum(-1), min=1.0)
    return X, mask, Kinv, alpha, ls, var, en, n_eff


@pytest.mark.parametrize("log_var", [-0.4, 0.0, 0.5])
def test_fit_grad_on_cpu_is_the_formula(log_var):
    """On CPU tensors the wrapper runs the plain version (bitwise, no
    launch counted), and the plain version is the formula pair by pair:
    1e-12 of each study's largest component in float64 (two summation
    orders of the same terms)."""
    args = _grad_inputs(12, torch.float64, log_var=log_var)
    before = dict(ops.launches)
    got = ops.fit_grad(*args)
    assert ops.launches == before
    assert torch.equal(got, ref.fit_grad_ref(*args))
    want = _formula(*args)
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.numpy() - want) <= 1e-12 * scale).all()
    args32 = [a.float() for a in _grad_inputs(12, torch.float32,
                                              log_var=log_var)]
    assert ops.fit_grad(*args32).dtype == torch.float32


@pytest.mark.parametrize("bad", ["dtype", "contig", "shape", "device"])
def test_fit_grad_rejects_malformed_inputs(bad):
    args = list(_grad_inputs(8, torch.float32))
    if bad == "dtype":
        args[3] = args[3].double()
    elif bad == "contig":
        args[2] = args[2].transpose(1, 2)
    elif bad == "shape":
        args[4] = args[4][:, :2].contiguous()
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        ops.fit_grad(*args)


def test_fit_grad_on_a_cuda_tensor_raises_without_the_card(monkeypatch,
                                                            tmp_path):
    """A CUDA tensor goes to the kernel or raises: with no card and no
    compiler the wrapper raises, and never returns the plain version's
    result.  The tensors are fake CUDA tensors (no storage)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.delitem(build._LOADED, "gp_acquisition", raising=False)
    monkeypatch.setattr(build, "library_path",
                        lambda name, sources: tmp_path / f"{name}.so")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    called = []
    monkeypatch.setattr(ref, "fit_grad_ref",
                        lambda *a: called.append(1) or a[0])
    before = dict(ops.launches)
    with FakeTensorMode():
        n, d = 8, D
        mk = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
        with pytest.raises(RuntimeError, match="nvcc"):
            ops.fit_grad(mk(B, n, d), mk(B, n), mk(B, n, n), mk(B, n),
                         mk(B, d), mk(B), mk(B), mk(B))
    assert called == [] and ops.launches == before


def _failing_study(n=128):
    """One study whose float32 K is not positive definite at its start:
    n near-duplicate rows (distinct in one coordinate by < 1e-3) under
    lengthscales of 10, var e^4 and the noise at its floor, so the jitter
    (1e-6 var) and the noise are below the factorization's rounding."""
    rng = np.random.default_rng(0)
    X = np.repeat(rng.uniform(size=(1, 1, D)), n, 1)
    X[0, :, 0] += rng.uniform(size=n) * 1e-3
    y = rng.normal(size=(1, n))
    return (X, y, np.log(np.full((1, D), 10.0)), np.array([4.0]),
            np.array([math.log(1e-7)]))


def _bank_inputs(with_failing: bool):
    """Two sound studies at n 128 and, between them, the failing one."""
    X, y, mask, lls, lv, ln = (a.numpy() for a in _system(
        128, 0.2, math.log(1e-2), seed=4, dtype=torch.float32))
    Xf, yf, llf, lvf, lnf = _failing_study()
    keep = [0, 2]
    X, y, mask, lls, lv, ln = (a[keep] for a in (X, y, mask, lls, lv, ln))
    if with_failing:
        ins = lambda a, f: np.concatenate([a[:1], f, a[1:]])  # noqa: E731
        X, y, lls, lv = ins(X, Xf), ins(y, yf), ins(lls, llf), ins(lv, lvf)
        mask = ins(mask, np.ones((1, 128)))
        ln = ins(ln, lnf)
    nb = X.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return (t(X), t(y), t(mask), t(lls), t(lv), t(ln), t(np.zeros(nb)),
            t(np.ones(nb)))


def test_failed_factor_stays_in_its_row():
    """A study whose K is not positive definite gets non-finite hypers in
    its own row only; the other rows equal their fit in a bank without
    that study, bit for bit."""
    args = _bank_inputs(True)
    X, y, mask, lls, lv, ln = args[:6]
    L = gp.cholesky_masked(X, mask, torch.exp(lls), torch.exp(lv),
                           torch.exp(ln) + 1e-5)
    assert [bool(torch.isnan(L[b]).any()) for b in range(3)] == [
        False, True, False]
    got = gp.fit_hypers_bank(*args, steps=40)
    alone = gp.fit_hypers_bank(*_bank_inputs(False), steps=40)
    finite = [torch.isfinite(p.reshape(3, -1)).all(-1) for p in got]
    assert [bool(f[1]) for f in finite] == [False, False, False]
    for p, q in zip(got, alone):
        assert torch.isfinite(q).all()
        assert torch.equal(p[[0, 2]], q)


SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(0, 1),
         "w": stats.uniform(0, 1)}


def test_ask_counts_fit_steps_and_nonfinite_fits():
    """A bank ask whose fit meets the failing study records ``fit_steps``
    40 and ``fit_nonfinite`` 1 in its telemetry; every record carries both
    counters (0 where the ask fit nothing)."""
    prev = telemetry.set_enabled(True)
    try:
        bank = StudyBank(SPACE, 2, seed=0, mc_samples=64, device="cpu")
        rng = np.random.default_rng(1)
        for _ in range(12):
            x = rng.uniform(size=3)
            bank.study(0).observe_params(
                dict(zip(SPACE, map(float, x))), float(-(x ** 2).sum()))
        Xf, yf, llf, lvf, lnf = _failing_study()
        for x, v in zip(Xf[0], yf[0]):
            bank.study(1).observe_params(
                dict(zip(SPACE, map(float, x))), float(v))
        bank.ledger.log_ls[1] = llf[0]
        bank.ledger.log_var[1] = lvf[0]
        bank.ledger.log_noise[1] = lnf[0]
        bank.ask_all(1)
        rec = telemetry.records(bank.telemetry_id)[-1]
        assert rec.counters["fit_steps"] == 40
        assert rec.counters["fit_nonfinite"] == 1
        assert rec.counters["fit_rows"] == 2
        assert not np.isfinite(bank.ledger.log_var[1])
        assert np.isfinite(bank.ledger.log_var[0])
        bank.ask_all(1)                     # nothing told: no fit
        rec = telemetry.records(bank.telemetry_id)[-1]
        assert rec.counters["fit_steps"] == rec.counters["fit_nonfinite"] == 0
        counters = telemetry.summary(bank.telemetry_id)["counters"]
        assert counters["fit_steps"] == 20.0
        assert counters["fit_nonfinite"] == 0.5
    finally:
        telemetry.set_enabled(prev)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("tag,B,na,n_act,d", chip_smoke.FIT_KERNEL_SHAPES)
def test_cuda_fit_kernels_match_plain_versions(tag, B, na, n_act, d):
    """``masked_kernel`` and ``fit_grad`` against their plain versions on
    the card with the tolerances ``chip_smoke.fit_kernel_errors`` states
    (the gradient against float64 within 1e-5 of each component's sum of
    absolute terms), including the cells' shape (B 16, na 1024, d 6); the
    launches are counted: ``fit_grad`` once, ``masked_kernel`` twice (once
    more for the system's factor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n0 = dict(ops.launches)
    errs, _ = chip_smoke.fit_kernel_errors(B, na, n_act, d,
                                           torch.device("cuda"))
    torch.cuda.synchronize()
    want = {"masked_kernel": 2, "fit_grad": 1}
    assert ops.launches == {k: v + want.get(k, 0) for k, v in n0.items()}
    for name, (err, tol) in errs.items():
        assert err <= tol, (name, err, tol)


@pytest.mark.cuda
def test_cuda_fit_kernels_repeat_their_bits():
    """Two calls of each fit kernel at the cells' shape give identical
    bits: fixed-order sums, no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = chip_smoke.fit_system(16, 1024, 1000, 6, torch.device("cuda"))
    kargs = (g["X"], g["mask"], g["ls"], g["var"], g["noise_exp"] + 1e-5,
             scoring.jitter(g["var"]))
    gargs = [g[k] for k in chip_smoke.FIT_GRAD_ARGS]
    for fn, args in ((ops.masked_kernel, kargs), (ops.fit_grad, gargs)):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_fit_launches_the_kernels_once_a_step():
    """``fit_hypers_bank`` on the card: one ``masked_kernel`` and one
    ``fit_grad`` launch per Adam step, finite hypers, the same bits on a
    second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = chip_smoke.fit_system(4, 256, 240, 6, torch.device("cuda"))
    X, mask = g["X"], g["mask"]
    dev = X.device
    y = torch.sin(6 * X[..., 0]) * mask
    d = X.shape[-1]
    start = (torch.full((4, d), math.log(0.5), device=dev),
             torch.zeros(4, device=dev),
             torch.full((4,), math.log(1e-2), device=dev))
    ym, ys = torch.zeros(4, device=dev), torch.ones(4, device=dev)
    n0 = dict(ops.launches)
    a = gp.fit_hypers_bank(X, y, mask, *start, ym, ys, steps=7)
    b = gp.fit_hypers_bank(X, y, mask, *start, ym, ys, steps=7)
    torch.cuda.synchronize()
    assert ops.launches["fit_grad"] == n0["fit_grad"] + 14
    assert ops.launches["masked_kernel"] == n0["masked_kernel"] + 14
    for p, q in zip(a, b):
        assert torch.isfinite(p).all() and torch.equal(p, q)
