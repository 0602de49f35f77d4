"""PyTorch port, the Mamba slice: the selective scan's plain versions (forward
and the backward kernel's decomposition), its dispatch, and the Mamba mixer
(training forward, prefill with state, decode, gradients) against the JAX
package on the same numpy-made inputs and parameters.

Tolerances (fp32 unless stated).  The scan: 1e-4 absolute against the
Pallas kernel in interpret mode, the JAX package's own kernel tolerance
(both walk the same recurrence; the sum over N is taken in another order).
The backward decomposition against autograd in float64: 1e-12 of the
largest magnitude (the same products in another order); against
``jax.grad`` in fp32: 1e-5 of the largest magnitude.  The mixer's outputs
and states: 1e-5 of the largest magnitude (measured: below 1e-6); its
gradients 1e-4 of each leaf's largest (a sum over B x S tokens of terms of
both signs).

The card test at the end holds the CUDA kernels against the plain versions
and skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_mamba.py
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.models import Runtime
from repro_torch.models import mamba as mamba_mod

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

T = torch.as_tensor
RT32 = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _scan_inputs(B, S, di, N, seed=0, dtype=np.float32):
    """Abar in [0.5, 0.999] (as ``tests/test_kernels.py`` draws it), Bx and C
    normal (Bx scaled by 0.1), and an upstream gradient for y."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.5, 0.999, (B, S, di, N)).astype(dtype)
    X = (rng.standard_normal((B, S, di, N)) * 0.1).astype(dtype)
    C = rng.standard_normal((B, S, N)).astype(dtype)
    dy = rng.standard_normal((B, S, di)).astype(dtype)
    dhS = rng.standard_normal((B, di, N)).astype(dtype)
    return A, X, C, dy, dhS


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------- #
# the scan's plain versions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,di,N,bd,ck", [
    (2, 128, 64, 8, 32, 32),
    (1, 64, 128, 16, 64, 16),
    (1, 96, 32, 4, 32, 32),
])
def test_ssm_scan_ref_matches_pallas_interpret(B, S, di, N, bd, ck):
    """y against the Pallas kernel in interpret mode at the JAX package's
    own kernel-test shapes, and the final state h_S against a jnp scan of
    the same recurrence."""
    jax, jnp = _jax()
    from repro.kernels.ssm_scan.ssm_scan import ssm_scan
    A, X, C, _, _ = _scan_inputs(B, S, di, N)
    want = ssm_scan(jnp.asarray(A), jnp.asarray(X), jnp.asarray(C),
                    block_d=bd, chunk=ck, interpret=True)
    y, hS = ssm_ref.ssm_scan_ref(T(A), T(X), T(C), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4)
    h_last, _ = jax.lax.scan(lambda h, ab: (ab[0] * h + ab[1], None),
                             jnp.zeros((B, di, N)),
                             (jnp.asarray(A).swapaxes(0, 1),
                              jnp.asarray(X).swapaxes(0, 1)))
    np.testing.assert_allclose(hS.numpy(), np.asarray(h_last), atol=1e-5)
    assert torch.equal(ssm_ref.ssm_scan_ref(T(A), T(X), T(C)), y)


@pytest.mark.parametrize("with_dhS", [False, True], ids=["y", "y+hS"])
def test_ssm_scan_bwd_ref_matches_autograd_float64(with_dhS):
    """The backward kernel's decomposition against autograd of the plain
    forward in float64, at a ragged length (two chunks of the kernel, the
    second partial), with and without a gradient on the final state."""
    A, X, C, dy, dhS = _scan_inputs(2, 70, 6, 4, seed=1, dtype=np.float64)
    xs = [T(a).requires_grad_() for a in (A, X, C)]
    y, hS = ssm_ref.ssm_scan_ref(*xs, return_state=True)
    outs, grads = [y], [T(dy)]
    if with_dhS:
        outs.append(hS)
        grads.append(T(dhS))
    want = torch.autograd.grad(outs, xs, grads)
    got = ssm_ref.ssm_scan_bwd_ref(T(A), T(X), T(C), T(dy),
                                   T(dhS) if with_dhS else None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g.numpy(), w.numpy(), 1e-12)


def test_ssm_scan_bwd_ref_matches_jax_grad():
    """The decomposition in fp32 against ``jax.grad`` of the JAX package's
    ``ssm_scan_ref`` with the same upstream gradient."""
    jax, jnp = _jax()
    from repro.kernels.ssm_scan.ref import ssm_scan_ref as jref
    A, X, C, dy, _ = _scan_inputs(1, 40, 16, 8, seed=2)
    want = jax.grad(lambda a, x, c: jnp.sum(jref(a, x, c) * dy),
                    argnums=(0, 1, 2))(jnp.asarray(A), jnp.asarray(X),
                                       jnp.asarray(C))
    got = ssm_ref.ssm_scan_bwd_ref(T(A), T(X), T(C), T(dy))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-5)


def test_selective_scan_on_the_cpu_is_the_plain_version():
    """A CPU tensor runs the plain version (both outputs), differentiable,
    and counts no launch."""
    A, X, C, dy, _ = _scan_inputs(1, 20, 8, 4, seed=3)
    n0 = dict(ssm_ops.launches)
    xs = [T(a).requires_grad_() for a in (A, X, C)]
    y, hS = ssm_ops.selective_scan(*xs, return_state=True)
    want_y, want_h = ssm_ref.ssm_scan_ref(T(A), T(X), T(C),
                                          return_state=True)
    assert torch.equal(y, want_y) and torch.equal(hS, want_h)
    grads = torch.autograd.grad(y, xs, T(dy))
    for g, w in zip(grads, ssm_ref.ssm_scan_bwd_ref(T(A), T(X), T(C),
                                                    T(dy))):
        _close(g.numpy(), w.numpy(), 1e-6)
    assert torch.equal(ssm_ops.selective_scan(T(A), T(X), T(C)), want_y)
    assert ssm_ops.launches == n0


def _bad(kind):
    A, X, C, _, _ = (T(a) for a in _scan_inputs(1, 8, 4, 4))
    if kind == "state-size":
        return A[..., :3].contiguous(), X[..., :3].contiguous(), \
            C[..., :3].contiguous()
    if kind == "dtype":
        return A.double(), X.double(), C.double()
    if kind == "strided":
        return A.transpose(1, 2).contiguous().transpose(1, 2), X, C
    if kind == "shape":
        return A, X[:, :4], C
    return A[:, :0], X[:, :0], C[:, :0]   # empty


@pytest.mark.parametrize("kind", ["state-size", "dtype", "strided", "shape",
                                  "empty"])
def test_selective_scan_rejects_what_the_kernels_do_not_take(kind):
    with pytest.raises((TypeError, ValueError)):
        ssm_ops.selective_scan(*_bad(kind))


# --------------------------------------------------------------------------- #
# the mixer against the JAX package
# --------------------------------------------------------------------------- #
def _mixer(seed=0):
    """Reduced jamba's Mamba parameters from the JAX package, and the
    port's copy of them."""
    jax, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.models import Runtime as JRuntime
    from repro.models.mamba import mamba_init
    jcfg = jget("jamba-v0.1-52b", reduced=True)
    jrt = JRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                   ssm_chunk=8)
    jp = mamba_init(jax.random.PRNGKey(seed), jcfg, jrt)
    tp = {k: T(np.array(v, np.float32)) for k, v in jp.items()}
    return jcfg, jrt, jp, get_config("jamba-v0.1-52b", reduced=True), tp


@pytest.mark.parametrize("S,pallas", [(16, True), (37, False)],
                         ids=["kernel-path", "chunked-ragged"])
def test_mamba_matches_reference(S, pallas):
    """``mamba`` (training forward) against the JAX package's: its Pallas
    kernel path (interpret mode) at S 16 and its chunked jnp path at a
    ragged S 37 (no multiple of its chunk)."""
    jax, jnp = _jax()
    from repro.models.mamba import mamba as jmamba
    jcfg, jrt, jp, cfg, tp = _mixer()
    jrt = dataclasses.replace(jrt, use_pallas=pallas)
    x = np.random.default_rng(5).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want = jmamba(jp, jnp.asarray(x), jcfg, jrt, batch=2)
    got = mamba_mod.mamba(tp, T(x), cfg, RT32)
    _close(got.numpy(), np.asarray(want), OUT_RTOL)


def test_mamba_with_state_and_decode_match_reference():
    """Prefill with state, then four decode steps, against the JAX
    package's ``mamba_with_state`` and ``mamba_decode``: outputs, the conv
    window and the SSM state after every step."""
    jax, jnp = _jax()
    from repro.models.mamba import mamba_decode as jdecode
    from repro.models.mamba import mamba_with_state as jprefill
    jcfg, jrt, jp, cfg, tp = _mixer(1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    jout, jst = jprefill(jp, jnp.asarray(x), jcfg, jrt, batch=2)
    out, st = mamba_mod.mamba_with_state(tp, T(x), cfg, RT32)
    _close(out.numpy(), np.asarray(jout), OUT_RTOL)
    for _ in range(4):
        for k in ("conv", "h"):
            assert st[k].shape == tuple(jst[k].shape)
            _close(st[k].numpy(), np.asarray(jst[k]), OUT_RTOL)
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jdecode(jp, jnp.asarray(xt), jst, jcfg, jrt)
        out, st = mamba_mod.mamba_decode(tp, T(xt), st, cfg, RT32)
        _close(out.numpy(), np.asarray(jout), OUT_RTOL)


def test_mamba_cache_init_and_short_prompt():
    """A zeroed cache has the decode state's shapes and dtypes; a prompt
    shorter than the conv window leaves zeros before it."""
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    c = mamba_mod.mamba_cache_init(cfg, Runtime(), 3, "cpu")
    assert c["conv"].shape == (3, cfg.ssm_conv_dim - 1, cfg.ssm_d_inner)
    assert c["conv"].dtype == torch.bfloat16 and c["h"].dtype == \
        torch.float32
    assert c["h"].shape == (3, cfg.ssm_d_inner, cfg.ssm_state_dim)
    p = mamba_mod.mamba_init(torch.Generator().manual_seed(0), cfg, RT32)
    x = torch.randn(1, 2, cfg.d_model, generator=torch.Generator())
    _, st = mamba_mod.mamba_with_state(p, x, cfg, RT32)
    assert st["conv"].shape == (1,) + c["conv"].shape[1:]
    assert not st["conv"][:, 0].any() and st["conv"][:, 1:].all()


def test_mamba_gradients_match_jax_grad():
    """Gradients of a weighted sum of ``mamba``'s output with respect to
    every parameter and the input, against ``jax.grad`` of the JAX
    package's chunked path (the one its training takes)."""
    jax, jnp = _jax()
    from repro.models.mamba import mamba as jmamba
    jcfg, jrt, jp, cfg, tp = _mixer(2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jmamba(p, xx, jcfg, jrt, batch=2) * cot)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = T(x).requires_grad_()
    loss = (mamba_mod.mamba(leaves, tx, cfg, RT32) * T(cot)).sum()
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [tx])
    for name, g in zip(names + ["x"], grads):
        want = jgx if name == "x" else jg[name]
        _close(g.numpy(), np.asarray(want), GRAD_RTOL)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.SSM_CARD_TEST_SHAPES,
                         ids=lambda s: s[0])
def test_cuda_ssm_scan_kernels_match_plain_version(shape):
    """Both CUDA kernels against the plain versions on the card, with the
    tolerances ``chip_smoke.ssm_error`` states; one launch of each per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n0 = dict(ssm_ops.launches)
    errs, *_ = chip_smoke.ssm_error(shape, torch.device("cuda"))
    assert ssm_ops.launches["ssm_scan"] == n0["ssm_scan"] + 2
    assert ssm_ops.launches["ssm_scan_bwd"] == n0["ssm_scan_bwd"] + 1
    for name, (err, tol) in errs.items():
        assert err <= tol, (shape, name, err, tol)


@pytest.mark.cuda
def test_cuda_selective_scan_differentiates_through_the_kernels():
    """On the card ``selective_scan`` under grad runs the forward kernel
    and, in the backward, the backward kernel; its gradients equal the
    plain version's within the phase-2 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    A, X, C, dy, dhS = (T(a, device=dev)
                        for a in _scan_inputs(2, 130, 24, 16, seed=4))
    xs = [t.clone().requires_grad_() for t in (A, X, C)]
    n0 = dict(ssm_ops.launches)
    y, hS = ssm_ops.selective_scan(*xs, return_state=True)
    got = torch.autograd.grad([y, hS], xs, [dy, dhS])
    assert ssm_ops.launches == {"ssm_scan": n0["ssm_scan"] + 1,
                                "ssm_scan_bwd": n0["ssm_scan_bwd"] + 1}
    want = ssm_ref.ssm_scan_bwd_ref(A, X, C, dy, dhS)
    for g, w in zip(got, want):
        tol = chip_smoke.SSM_RTOL * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol
