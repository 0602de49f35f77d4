"""PyTorch port, mLSTM: the numerics of the split-TF32 tensor-core kernels,
written out in plain PyTorch (``ref.mlstm_chunkwise_split`` and the
autograd Function ``ref.MlstmChunkSplit``: every product of two tiles from
fp32 operands split into TF32 hi and lo parts, lo.hi + hi.lo + hi.hi summed
with the tensor cores' truncation (``ref.mma_step``) in a fresh accumulator
each 8-deep k-step, the k-steps added in fp32), against the JAX package's
recurrent oracle ``repro.kernels.mlstm_chunk.ref.mlstm_ref``, its Pallas
kernel in interpret mode and ``jax.grad`` of the oracle, on the same inputs
made with numpy from a seed (``chip_smoke.mlstm_inputs``).

Tolerance: ``chip_smoke.MLSTM_RTOL``, 5e-5 of each output's largest
magnitude, which the card checks hold the kernels to and this file does
not change.  The oracle computes in fp32 one token at a time, so what the
check measures is what the kernels' split products cost, at xlstm-1.3b's
head size (dh 1024) and where the clamp e^{-m} decides the denominators.
Two designs the kernels avoid miss the same tolerance at dh 1024: one TF32
pass (hi.hi alone, 10 mantissa bits an operand), and the split products
summed through one accumulator over the whole contraction, whose truncating
sums drift toward zero (at xlstm-1.3b's training length, as the card
showed).  That is why the kernels split and start a fresh accumulator each
k-step.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.mlstm_chunk import mlstm_chunk
from repro.kernels.mlstm_chunk.ref import mlstm_ref
from repro_torch.kernels.mlstm_chunk import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RTOL = chip_smoke.MLSTM_RTOL

# (tag, B, NH, S, dh, clamp), as chip_smoke.MLSTM_SHAPES lists shapes
CASES = [
    ("xlstm-head-dh1024", 1, 1, 128, 1024, False),
    ("ragged-dh256", 1, 2, 100, 256, False),
    ("clamp-dh128", 1, 2, 128, 128, True),
]


def _inputs(case):
    """q, k, v, logi, logf and an upstream gradient as fp32 numpy arrays."""
    return [t.numpy() for t in chip_smoke.mlstm_inputs(case, "cpu", seed=5)]


def _err(got, want):
    """Largest absolute error over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_products_fit_the_card_tolerance(case):
    q, k, v, li, lf, g = _inputs(case)
    x = [torch.as_tensor(a).requires_grad_() for a in (q, k, v, li, lf)]
    h = ref.MlstmChunkSplit.apply(*x)
    grads = torch.autograd.grad(h, x, torch.as_tensor(g))
    xj = [jnp.asarray(a) for a in (q, k, v, li, lf)]
    want = [np.asarray(mlstm_ref(*xj))]
    if case[3] % ref.CHUNK == 0:   # the Pallas kernel takes whole chunks
        want.append(np.asarray(mlstm_chunk(*xj, chunk=ref.CHUNK)))
    for w in want:
        assert _err(h.detach().numpy(), w) <= RTOL
    want_g = jax.grad(lambda *a: jnp.sum(mlstm_ref(*a) * g),
                      argnums=range(5))(*xj)
    for name, got, w in zip(chip_smoke.MLSTM_GRADS, grads, want_g):
        assert _err(got.numpy(), w) <= RTOL, name
    if case[5]:
        share = ref.clamp_share(*map(torch.as_tensor, (q, k, li, lf)))
        assert share >= 0.5


# (id, case, forward options of the design that misses)
MISSES = [
    ("one-tf32-pass", ("xlstm-head-dh1024", 1, 1, 128, 1024, False),
     dict(passes=1)),
    ("one-accumulator-s1024", ("xlstm-head-s1024", 1, 1, 1024, 1024, False),
     dict(chain=None)),
]


@pytest.mark.parametrize("case,design", [m[1:] for m in MISSES],
                         ids=[m[0] for m in MISSES])
def test_designs_the_kernels_avoid_miss_the_tolerance_at_dh1024(case,
                                                               design):
    """The kernels' forward (three products, a fresh accumulator each
    k-step) meets the tolerance against the oracle at dh 1024; the design
    beside it, on the same inputs, does not."""
    q, k, v, li, lf, _ = _inputs(case)
    want = np.asarray(mlstm_ref(*map(jnp.asarray, (q, k, v, li, lf))))
    x = [torch.as_tensor(a) for a in (q, k, v, li, lf)]
    kernels = _err(ref.mlstm_chunkwise_split(*x).numpy(), want)
    other = _err(ref.mlstm_chunkwise_split(*x, **design).numpy(), want)
    assert kernels <= RTOL < other
