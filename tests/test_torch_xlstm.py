"""PyTorch port, xLSTM: the mLSTM kernels' plain versions and their
gradients, the mLSTM and sLSTM mixers with state and decode, and xLSTM
prefill + decode, against the JAX package on the same numpy-made inputs
and parameters.

Tolerances (fp32 throughout).  The chunkwise and recurrent forms compute
the same function in float32 with sums in other orders (per chunk, per
step; XLA's and PyTorch's): outputs agree to 1e-5 of their largest
magnitude (measured: below 1e-6), gradients to 2e-5 of theirs (measured:
below 3e-6; the gate gradients sum L^2 terms of mixed sign).  The model
functions agree to 1e-5 absolute on unit-scale outputs (measured: below
1e-6).  Logits after eight xLSTM layers agree to 3e-4 absolute on logits of
scale ~3, the JAX package's own tolerance for this function (its Pallas
kernel against its oracle): an mLSTM denominator sums terms of mixed sign,
and where they nearly cancel the rounding of sums taken in other orders is
amplified layer by layer (measured: 1.1e-4 at 17 tokens, 1.2e-5 at 64;
2e-6 after one layer).

The JAX side runs the Pallas kernel in interpret mode where it can (S a
multiple of the chunk), as the JAX package's own tests run it on the CPU,
and its differentiable paths (``mlstm_ref`` under ``jax.grad``, the jnp
chunked form of ``repro.models.xlstm.mlstm``) for gradients, since
``jax.grad`` of the Pallas kernel raises.  The card tests at the end hold
the CUDA kernels against the plain version and skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_xlstm.py
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.mlstm_chunk import ref as mlstm_ref
from repro_torch.models import (Runtime, forward_decode, forward_prefill,
                                init_params)
from repro_torch.models import xlstm as X
from repro_torch.models.mamba import _causal_conv

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RT32 = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
               ssm_chunk=8)
OUT_RTOL = 1e-5
GRAD_RTOL = 2e-5
TOL_FN = 1e-5
TOL_LOGITS = 3e-4


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _jrt(jnp, **kw):
    from repro.models import Runtime as JRuntime
    return JRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                    ssm_chunk=8, **kw)


def _inputs(B, NH, S, dh, seed=0, clamp=False):
    """q, k, v, logi, logf and an upstream gradient as numpy, the reference
    kernel test's distributions (keys scaled by dh^-1/2, logf = log
    sigmoid(N(-1, 1))); ``clamp`` makes the clamp e^{-m} decide the
    denominators (small keys, logi ~ N(-3, 1))."""
    rng = np.random.default_rng(seed)

    def normal(*size):
        return rng.standard_normal(size, dtype=np.float32)

    q, v, g = normal(B, NH, S, dh), normal(B, NH, S, dh), normal(B, NH, S, dh)
    k = normal(B, NH, S, dh) * np.float32(dh ** -0.5 * (0.1 if clamp else 1))
    li = normal(B, NH, S) - np.float32(3.0 if clamp else 0.0)
    lf = -np.log1p(np.exp(-(normal(B, NH, S) - np.float32(1.0))))
    return q, k, v, li, lf, g


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


T = torch.as_tensor


# --------------------------------------------------------------------------- #
# the plain versions against the Pallas kernel and the recurrent oracle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,NH,S,dh,L,clamp", [
    (2, 2, 128, 64, 32, False),
    (1, 4, 64, 128, 16, False),
    (1, 1, 64, 32, 64, False),   # single chunk == whole sequence
    (2, 2, 128, 64, 64, True),   # the clamp decides every denominator
])
def test_chunkwise_matches_pallas_kernel_and_oracle(B, NH, S, dh, L, clamp):
    """``ref.mlstm_chunkwise`` at the Pallas kernel's chunk against the
    kernel in interpret mode and against the JAX recurrent oracle, on the
    JAX package's own kernel-test shapes; the port's recurrent oracle
    against the JAX one."""
    jax, jnp = _jax()
    from repro.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
    from repro.kernels.mlstm_chunk.ref import mlstm_ref as jref
    x = _inputs(B, NH, S, dh, clamp=clamp)[:5]
    want_k = np.asarray(mlstm_chunk(*map(jnp.asarray, x), chunk=L))
    want_r = np.asarray(jref(*map(jnp.asarray, x)))
    got = mlstm_ref.mlstm_chunkwise(*map(T, x), chunk=L).numpy()
    for want in (want_k, want_r):
        _close(got, want, OUT_RTOL)
    _close(mlstm_ref.mlstm_ref(*map(T, x)).numpy(), want_r, OUT_RTOL)
    if clamp:
        assert mlstm_ref.clamp_share(*map(T, (x[0], x[1], x[3], x[4]))) > 0.9


@pytest.mark.parametrize("S", [1, 63, 100, 130])
def test_mixer_ragged_lengths_match_oracle(S):
    """``ops.mlstm_mixer`` on CPU tensors (64-token chunks, the last one
    short) at lengths the Pallas kernel does not take, against the JAX
    recurrent oracle."""
    jax, jnp = _jax()
    from repro.kernels.mlstm_chunk.ref import mlstm_ref as jref
    x = _inputs(2, 2, S, 64, seed=S)[:5]
    got = mlstm_ops.mlstm_mixer(*map(T, x)).numpy()
    _close(got, np.asarray(jref(*map(jnp.asarray, x))), OUT_RTOL)


@pytest.mark.parametrize("S,clamp", [(100, False), (130, True), (64, False)],
                         ids=["ragged", "clamp-ragged", "one-chunk"])
def test_mixer_gradients_match_jax_grad(S, clamp):
    """Gradients of ``ops.mlstm_mixer`` (autograd of the plain version) and
    of the backward kernel's decomposition (``ref.mlstm_chunkwise_bwd``)
    against ``jax.grad`` of the JAX package's recurrent oracle, both
    regimes of the clamp included."""
    jax, jnp = _jax()
    from repro.kernels.mlstm_chunk.ref import mlstm_ref as jref
    q, k, v, li, lf, g = _inputs(2, 2, S, 64, seed=3, clamp=clamp)
    want = jax.grad(lambda *a: jnp.sum(jref(*a) * g), argnums=range(5))(
        *map(jnp.asarray, (q, k, v, li, lf)))
    xs = [T(a).requires_grad_() for a in (q, k, v, li, lf)]
    h = mlstm_ops.mlstm_mixer(*xs)
    got = torch.autograd.grad(h, xs, T(g))
    mirror = mlstm_ref.mlstm_chunkwise_bwd(*map(T, (q, k, v, li, lf)),
                                           h.detach(), T(g))
    for a, b, w in zip(got, mirror, want):
        _close(a.numpy(), np.asarray(w), GRAD_RTOL)
        _close(b.numpy(), np.asarray(w), GRAD_RTOL)


def test_mixer_rejects_what_the_kernels_do_not_take():
    q, k, v, li, lf, _ = map(T, _inputs(1, 2, 16, 64))
    for bad in ((q[..., :32].contiguous(), k[..., :32].contiguous(),
                 v[..., :32].contiguous(), li, lf),        # dh % 64
                (q.double(), k, v, li, lf),                 # dtype
                (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, li,
                 lf),                                       # layout
                (q, k, v, li[:, :, :8].contiguous(), lf)):  # shape
        with pytest.raises((TypeError, ValueError)):
            mlstm_ops.mlstm_mixer(*bad)


def test_kernel_wrappers_reject_unaligned_views():
    """A contiguous view that starts 4 bytes into its storage passes the
    shape and layout checks but not the kernels' 16-byte copies: both
    wrappers raise before they reach the device."""
    q, k, v, li, lf, g = map(T, _inputs(1, 2, 16, 64))
    shifted = torch.empty(q.numel() + 1)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    mlstm_ops.check_aligned(q=q, k=k, v=v, h=q, dh=g)
    with pytest.raises(ValueError, match="k must start on a 16-byte"):
        mlstm_ops.forward(q, shifted, v, li, lf)
    with pytest.raises(ValueError, match="dh must start on a 16-byte"):
        mlstm_ops.backward(q, k, v, li, q, None, shifted)


def test_cpu_calls_do_not_count_as_launches():
    n0 = dict(mlstm_ops.launches)
    xs = [T(a).requires_grad_() for a in _inputs(1, 1, 20, 64)[:5]]
    mlstm_ops.mlstm_mixer(*xs).sum().backward()
    assert mlstm_ops.launches == n0


# --------------------------------------------------------------------------- #
# the mixers against repro.models.xlstm
# --------------------------------------------------------------------------- #
def _cfgs():
    from repro.configs import get_config as jget
    return get_config("xlstm-1.3b", True), jget("xlstm-1.3b", True)


def _mixer_params(kind, seed=0):
    """JAX-initialised mixer parameters as numpy (gate biases moved off
    their constant init) and the port's copy."""
    jax, jnp = _jax()
    from repro.models import xlstm as JX
    cfg, jcfg = _cfgs()
    init = JX.mlstm_init if kind == "mlstm" else JX.slstm_init
    jp = init(jax.random.PRNGKey(seed), jcfg, _jrt(jnp))
    rng = np.random.default_rng(seed)
    pn = {k: np.array(v, np.float32) for k, v in jp.items()}
    for name in ("gate_bias", "bias"):
        if name in pn:
            pn[name] = pn[name] + rng.standard_normal(
                pn[name].shape).astype(np.float32)
    return pn, {k: T(v) for k, v in pn.items()}


def test_causal_conv_matches_reference():
    jax, jnp = _jax()
    from repro.models.mamba import _causal_conv as jconv
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 16), dtype=np.float32)
    w = rng.standard_normal((4, 16), dtype=np.float32)
    sh = rng.standard_normal((2, 3, 16), dtype=np.float32)
    for shift in (None, sh):
        got = _causal_conv(T(x), T(w), None if shift is None else T(shift))
        want = jconv(jnp.asarray(x), jnp.asarray(w),
                     None if shift is None else jnp.asarray(shift))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_FN)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_with_state_and_decode_match_reference(kind):
    """Prefill with state (output and every state leaf), then two decode
    steps, against ``repro.models.xlstm``."""
    jax, jnp = _jax()
    from repro.models import xlstm as JX
    cfg, jcfg = _cfgs()
    pn, tp = _mixer_params(kind)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    xd = rng.standard_normal((2, 2, 1, cfg.d_model), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    jfull = getattr(JX, kind)
    jdec = getattr(JX, f"{kind}_decode")
    want, jst = jfull(jp, jnp.asarray(x), jcfg, _jrt(jnp), batch=2,
                      return_state=True)
    got, st = getattr(X, kind)(tp, T(x), cfg, RT32, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FN)
    for name in jst:
        _close(st[name].numpy(), np.asarray(jst[name]), OUT_RTOL)
    for i in range(2):
        want, jst = jdec(jp, jnp.asarray(xd[i]), jst, jcfg, _jrt(jnp))
        got, st = getattr(X, f"{kind}_decode")(tp, T(xd[i]), st, cfg, RT32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_FN)
    zero = getattr(X, f"{kind}_cache_init")(cfg, RT32, 2, "cpu")
    jzero = getattr(JX, f"{kind}_cache_init")(jcfg, _jrt(jnp), 2)
    assert set(zero) == set(jzero)
    for name in zero:
        np.testing.assert_array_equal(zero[name].numpy(),
                                      np.asarray(jzero[name]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_block_gradients_match_reference(kind):
    """Gradients of the whole mixer (the mLSTM through ``ops.mlstm_mixer``)
    with respect to its input and every parameter, against ``jax.grad`` of
    ``repro.models.xlstm`` on its differentiable jnp path
    (``use_pallas=False``), at a length that is no multiple of 64."""
    jax, jnp = _jax()
    from repro.models import xlstm as JX
    cfg, jcfg = _cfgs()
    pn, _ = _mixer_params(kind, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 70, cfg.d_model), dtype=np.float32)
    G = rng.standard_normal((2, 70, cfg.d_model), dtype=np.float32)
    jfn = getattr(JX, kind)

    def jloss(p, xx):
        return jnp.sum(jfn(p, xx, jcfg, _jrt(jnp), batch=2) * G)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(x))
    tp = {k: T(v).requires_grad_() for k, v in pn.items()}
    tx = T(x).requires_grad_()
    out = getattr(X, kind)(tp, tx, cfg, RT32)
    grads = torch.autograd.grad((out * T(G)).sum(), [tx, *tp.values()])
    _close(grads[0].numpy(), np.asarray(jgx), GRAD_RTOL)
    for name, g in zip(tp, grads[1:]):
        _close(g.numpy(), np.asarray(jgp[name]), GRAD_RTOL)


# --------------------------------------------------------------------------- #
# xLSTM prefill + decode against the JAX package
# --------------------------------------------------------------------------- #
def test_xlstm_prefill_and_decode_match_reference():
    """The reduced xlstm (8 layers, period 7 mLSTM : 1 sLSTM) from the JAX
    package's parameters: prefill logits and two decode steps."""
    jax, jnp = _jax()
    from repro.models import forward_decode as jdecode
    from repro.models import forward_prefill as jprefill
    from repro.models import init_params as jinit
    cfg, jcfg = _cfgs()
    jrt = _jrt(jnp)
    jp = jinit(jax.random.PRNGKey(0), jcfg, jrt)
    tp = model_params_from_numpy(
        jax.tree.map(lambda a: np.array(a, np.float32), jp), cfg, RT32,
        device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 19),
                                             dtype=np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :17])}, jcfg, jrt)
    tl, tc = forward_prefill(tp, {"tokens": T(toks[:, :17])}, cfg, RT32)
    V = cfg.vocab_size
    np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V],
                               atol=TOL_LOGITS)
    for i in (17, 18):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                         jnp.int32(i), jcfg, jrt)
        tl, tc2 = forward_decode(tp, T(toks[:, i:i + 1]), tc, i, cfg, RT32)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V],
                                   atol=TOL_LOGITS)


def test_xlstm_init_layout():
    cfg = get_config("xlstm-1.3b", reduced=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, Runtime())
    kinds = [("r" in b["mixer"]) for b in p["blocks"]]
    assert kinds == [False, False, False, True, False, False, False, False]
    assert p["blocks"][0]["mixer"]["w_gate"].dtype == torch.float32
    assert p["blocks"][3]["mixer"]["r"].dtype == torch.float32
    assert p["blocks"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert "ffn" not in p["blocks"][0]


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.MLSTM_CARD_TEST_SHAPES,
                         ids=lambda s: s[0])
def test_cuda_mlstm_kernels_match_plain_version(shape):
    """Both CUDA kernels against the plain version on the card, with the
    tolerance ``chip_smoke.mlstm_error`` states; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n0 = dict(mlstm_ops.launches)
    errs, *_ = chip_smoke.mlstm_error(shape, torch.device("cuda"))
    assert mlstm_ops.launches["mlstm_chunk"] == n0["mlstm_chunk"] + 1
    assert mlstm_ops.launches["mlstm_chunk_bwd"] == \
        n0["mlstm_chunk_bwd"] + 1
    for name, (err, tol) in errs.items():
        assert err <= tol, (shape, name, err, tol)


@pytest.mark.cuda
def test_cuda_mixer_autograd_runs_both_kernels():
    """``ops.mlstm_mixer`` on CUDA tensors under autograd: the forward and
    backward kernels, gradients equal to the CPU plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _inputs(2, 2, 150, 64, seed=9)
    n0 = dict(mlstm_ops.launches)
    grads = []
    for dev in ("cuda", "cpu"):
        xs = [T(a).to(dev).requires_grad_() for a in x[:5]]
        h = mlstm_ops.mlstm_mixer(*xs)
        grads.append([g.cpu() for g in torch.autograd.grad(
            h, xs, T(x[5]).to(dev))] + [h.detach().cpu()])
    assert mlstm_ops.launches == {k: v + 1 for k, v in n0.items()}
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy(), chip_smoke.MLSTM_RTOL)


@pytest.mark.cuda
def test_cuda_remat_policies_give_the_same_gradients():
    """On the card the mLSTM autograd function under ``torch.utils.
    checkpoint`` (``full``) and selective checkpointing (``dots``): the
    loss and gradients of the reduced xLSTM equal those with every
    activation kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import forward_train
    from repro_torch.tree import tree_items
    cfg = get_config("xlstm-1.3b", reduced=True)
    rng = np.random.default_rng(0)
    toks = T(rng.integers(0, cfg.vocab_size, (2, 71), dtype=np.int32))
    batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    out = {}
    for pol in ("none", "full", "dots"):
        rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
                     remat_policy=pol)
        p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        rt)
        leaves = [leaf.requires_grad_() for _, leaf in tree_items(p)]
        loss, _ = forward_train(p, batch, cfg, rt)
        out[pol] = [loss] + list(torch.autograd.grad(loss, leaves))
    for pol in ("full", "dots"):
        for a, b in zip(out["none"], out[pol]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
