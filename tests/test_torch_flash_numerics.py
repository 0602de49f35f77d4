"""PyTorch port, flash attention: the numerics of the bf16 tensor-core
kernels, written out in plain PyTorch (``ref.attention_tc_ref`` and
``ref.attention_bwd_tc_ref``: P rounded to bf16 before P.V and dV, dS
before dK and dQ), against the JAX package's oracle
``repro.kernels.flash_attention.ref.attention_ref`` and ``jax.grad`` of it
on the same bf16 inputs, made with numpy from a seed.

Tolerances are those the card checks state and this file does not change:
the output within ``chip_smoke.flash_error``'s 2^-7 of the largest output
plus 2e-5, and the log-sum-exp and the gradients within
``chip_smoke.flash_bwd_error``'s (1e-4, plus 2^-7 for the bf16 gradients)
of their largest magnitude.  The oracle computes in fp32 on the same bf16
values, so what the check measures is what the kernels' rounding of P and
dS costs, at every shape kind the card checks hold the kernels at.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ref as flash_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BWD_RTOL = chip_smoke.FLASH_BWD_RTOL + chip_smoke.FLASH_BWD_RTOL_BF16


def _inputs(B, H, KV, Sq, Sk, hd, seed=0):
    """q, k, v, dout as bf16-exact float32 numpy arrays in the model layout
    (B, S, heads, hd)."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
        return x.to(torch.bfloat16).float().numpy()

    return (bf16(B, Sq, H, hd), bf16(B, Sk, KV, hd), bf16(B, Sk, KV, hd),
            bf16(B, Sq, H, hd))


@jax.jit(static_argnames="causal")
def _oracle_j(qj, kj, vj, doj, causal):
    out = attention_ref(*(a.astype(jnp.bfloat16) for a in (qj, kj, vj)),
                        causal=causal).swapaxes(1, 2)
    _, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, causal=causal),
                     qj, kj, vj)
    grads = [g.swapaxes(1, 2) for g in vjp(doj)]
    hd, (Sq, Sk) = qj.shape[-1], (qj.shape[2], kj.shape[2])
    G = qj.shape[1] // kj.shape[1]
    s = jnp.einsum("bhqd,bhkd->bhqk", qj, jnp.repeat(kj, G, axis=1)) \
        * hd ** -0.5
    if causal:
        mask = jnp.arange(Sk)[None, :] <= jnp.arange(Sq)[:, None] + Sk - Sq
        s = jnp.where(mask, s, -jnp.inf)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    return out.astype(jnp.float32), lse, grads


def _oracle(q, k, v, dout, causal):
    """The JAX oracle's output (bf16), log-sum-exp and fp32 gradients, in
    the model layout."""
    out, lse, grads = _oracle_j(*(jnp.asarray(a).swapaxes(1, 2)
                                  for a in (q, k, v, dout)), causal=causal)
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


# (B, H, KV, Sq, Sk, hd, causal)
CASES = {
    "causal-gqa-hd64": (2, 6, 2, 256, 256, 64, True),
    "rect-causal-hd24": (2, 4, 2, 77, 300, 24, True),
    "cross-non-causal-hd32": (2, 4, 2, 77, 300, 32, False),
    "mqa-hd128": (1, 8, 1, 300, 300, 128, True),
    "ragged-hd96": (1, 4, 4, 1000, 1000, 96, True),
    "long-gqa-hd128": (1, 8, 2, 1024, 1024, 128, True),
    "whisper-encoder-hd64": (1, 2, 2, 1500, 1500, 64, False),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_tc_numerics_fit_the_card_tolerances(case):
    B, H, KV, Sq, Sk, hd, causal = CASES[case]
    q, k, v, dout = _inputs(B, H, KV, Sq, Sk, hd)
    want_out, want_lse, want_grads = _oracle(q, k, v, dout, causal)
    qt, kt, vt, dot = (torch.as_tensor(a).to(torch.bfloat16)
                       for a in (q, k, v, dout))
    out, lse = flash_ref.attention_tc_ref(qt, kt, vt, causal=causal)
    assert out.dtype == torch.bfloat16 and lse.shape == (B, H, Sq)
    err = float(np.abs(out.float().numpy() - want_out).max())
    tol = 2e-5 + 2.0 ** -7 * float(np.abs(want_out).max())
    assert err <= tol, ("out", err, tol)
    err = float(np.abs(lse.numpy() - want_lse).max())
    assert err <= chip_smoke.FLASH_BWD_RTOL * float(np.abs(want_lse).max())
    grads = flash_ref.attention_bwd_tc_ref(qt, kt, vt, out, lse, dot,
                                           causal=causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = float(np.abs(got.float().numpy() - want).max())
        tol = BWD_RTOL * float(np.abs(want).max())
        assert err <= tol, (name, err, tol)


def test_tc_forward_rounds_only_p():
    """With P exact in bf16 (one key: P = 1) the emulated forward is the
    plain version: what it adds is the rounding of P, nothing else."""
    q, k, v, _ = _inputs(1, 2, 1, 1, 1, 32)
    qt, kt, vt = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = flash_ref.attention_tc_ref(qt, kt, vt, causal=True)
    want, want_lse = flash_ref.attention_lse_ref(qt, kt, vt, causal=True)
    assert torch.equal(out, want)
    torch.testing.assert_close(lse, want_lse)
