"""PyTorch port, TPE scoring: the arithmetic of the CUDA kernels
``tpe_scores`` and ``parzen_logdens``, written out row by row in float32
(``ref.tpe_scores_rowseq``, ``ref.parzen_logdens_rowseq``), in the two
layouts the kernel has had, against each other and against the JAX
package's Pallas kernels in interpret mode and its jnp oracles, on the same
inputs made with numpy from a seed.

Layouts.  *Dense*: every live row goes into both densities' sums, one
exponential feeding both, as the first CUDA design did.  *Compacted*: each
density sums only the rows of its own list (weight != 0), in ascending row
order, as the kernel does now; a row in both splits is in both lists.  Each
sum is one fmaf(w, e, sum) a row, so a skipped row is one whose
fmaf(0, e, sum) returned the sum unchanged: the two layouts must agree bit
for bit, for 0/1 weights as the ask path passes and for any other
non-negative weights.  Rows at or past a study's live count are in no list.

Tolerance: ``chip_smoke.TPE_TOL`` (1e-4 absolute per score), the JAX
package's own kernel-vs-oracle tolerance, against the Pallas kernel, the
jnp oracle and the port's plain version: they add the same positive terms
in other orders and floor every density at 1e-12.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tpe_kde import ref as jref
from repro.kernels.tpe_kde import tpe_kde as jkern
from repro_torch.core.tpe import fused_tpe_propose_bank
from repro_torch.kernels.tpe_kde import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = chip_smoke.TPE_TOL
CPU = torch.device("cpu")


def _both_layouts(g):
    """{kernel: (dense, compacted)} scores of system ``g``."""
    d = g["d"]
    return {
        "tpe_scores": tuple(
            ref.tpe_scores_rowseq(*g["tpe"], d_true=d, compacted=c)
            for c in (False, True)),
        "parzen_logdens": tuple(
            ref.parzen_logdens_rowseq(*g["parzen"], d_true=d, compacted=c)
            for c in (False, True))}


def _ask_path_system(seed=5):
    """The inputs the ask path hands ``ops.tpe_scores``, captured from
    ``fused_tpe_propose_bank`` on the CPU: four studies with 1 (the
    empty-bad case: its one row in both splits), 7, 40 and 200 observed
    rows, 0-4 pending rows after them, and nonzero rows past the live
    count; the parzen call scores the same rows with w = max(wg, wb)."""
    rng = np.random.default_rng(seed)
    B, na, S, d, dp = 4, 256, 3000, 6, 8
    n_obs = np.array([1, 7, 40, 200])
    n_pend = np.array([0, 2, 4, 3])
    X = np.zeros((B, na, dp), np.float32)
    X[..., :d] = rng.uniform(size=(B, na, d))        # garbage past n_live
    y = rng.normal(size=(B, na)).astype(np.float32)
    C = np.zeros((B, S, dp), np.float32)
    C[..., :d] = rng.uniform(size=(B, S, d))
    meta = np.stack([n_obs, n_pend, np.full(B, S), np.full(B, 0.25)],
                    1).astype(np.float32)
    seen = []

    def spy(*args, d_true):
        seen.append(args)
        return ref.tpe_scores_ref(*args, d_true=d_true)

    real = ops.tpe_scores
    ops.tpe_scores = spy
    try:
        fused_tpe_propose_bank(*map(torch.as_tensor, (X, y, C, meta)),
                               batch_size=2, d_true=d)
    finally:
        ops.tpe_scores = real
    (args,) = seen
    cands, pts, _, wg, wb, scal, live = args
    w = torch.maximum(wg, wb)
    n = w.sum(1)
    bw = ref.scott_bandwidth(n, d)
    scal_p = torch.stack([0.5 / (bw * bw), 1.0 / n, 0 * n, 0 * n], 1)
    return dict(tpe=args, parzen=(cands, pts, w, scal_p, live), d=d,
                live=live.numpy(), n_obs=n_obs, n_pend=n_pend)


SYSTEMS = {
    # the fleet's per-study shape, every live row weighted
    "fleet-study": lambda: chip_smoke.tpe_system(2, 16800, 256, 200, 6, CPU),
    # chip_smoke's ragged shape: S 257, d 11 (dp 16), masked rows
    "ragged-holes": lambda: chip_smoke.tpe_system(3, 257, 24, 17, 11, CPU,
                                                  kind="holes"),
    # fractional weights and a row in both splits (live 3, 2, 1)
    "both-splits-fractional": lambda: chip_smoke.tpe_system(
        3, 300, 16, 3, 3, CPU, kind="shared"),
    # the ask path: empty-bad, pending rows, rows past the live count
    "ask-path": _ask_path_system,
}


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_dense_and_compacted_layouts_are_bitwise_equal(system):
    g = SYSTEMS[system]()
    for name, (dense, compact) in _both_layouts(g).items():
        assert torch.isfinite(dense).all(), name
        assert torch.equal(dense, compact), (
            name, int((dense != compact).sum()),
            float((dense - compact).abs().max()))


def test_ask_path_system_has_the_rows_the_layouts_must_skip():
    """The captured ask-path inputs hold what the compacted layout skips or
    repeats: a row in both splits, pending rows only in the bad split, and
    rows past the live count with zero weight but nonzero coordinates."""
    g = _ask_path_system()
    _, pts, _, wg, wb, _, live = g["tpe"]
    assert live.tolist() == (g["n_obs"] + g["n_pend"]).tolist()
    assert wg[0, 0] == 1 and wb[0, 0] == 1            # empty-bad study
    for b in range(1, 4):
        pend = slice(g["n_obs"][b], live[b])
        assert (wb[b, pend] == 1).all() and (wg[b, pend] == 0).all()
        assert (wg[b, :live[b]] + wb[b, :live[b]] == 1).all()
    for b in range(4):
        assert (wg[b, live[b]:] == 0).all() and (wb[b, live[b]:] == 0).all()
        assert (pts[b, live[b]:, :6] != 0).any()


def test_rows_past_the_live_count_are_in_no_list():
    """Weights and coordinates past ``n_live`` change no bit of either
    layout: the kernel's lists end at the live count."""
    g = chip_smoke.tpe_system(3, 400, 64, 40, 5, CPU)
    want = _both_layouts(g)
    C, X, a, wg, wb, scal, live = (t.clone() for t in g["tpe"])
    rng = np.random.default_rng(1)
    for b, n in enumerate(live):
        X[b, n:, :5] = torch.as_tensor(rng.uniform(size=(64 - n, 5)))
        wg[b, n:] = 1.0
        wb[b, n:] = 1.0
        a[b, n:, :5] = 7.0
    w = torch.maximum(wg, wb)
    g2 = dict(g, tpe=(C, X, a, wg, wb, scal, live),
              parzen=(C, X, w, g["parzen"][3], live))
    for name, pair in _both_layouts(g2).items():
        for got, ref_ in zip(pair, want[name]):
            assert torch.equal(got, ref_), name


def _pallas(g, b, name):
    """Study b of system ``g`` through the Pallas kernel in interpret mode,
    candidates padded to the 256-row block as the JAX package pads them."""
    C = g["tpe"][0][b].numpy()
    S = C.shape[0]
    Cp = np.zeros((-(-S // 256) * 256, C.shape[1]), np.float32)
    Cp[:S] = C
    if name == "tpe_scores":
        _, X, a, wg, wb, scal, _ = (t[b].numpy() for t in g["tpe"])
        out = jkern.tpe_scores_pallas(
            jnp.asarray(Cp), jnp.asarray(X), jnp.asarray(a), jnp.asarray(wg),
            jnp.asarray(wb), jnp.asarray(scal[None]), d_true=g["d"],
            block_s=256, interpret=True)
    else:
        _, X, w, scal, _ = (t[b].numpy() for t in g["parzen"])
        out = jkern.parzen_logdens_pallas(
            jnp.asarray(Cp), jnp.asarray(X), jnp.asarray(w),
            jnp.asarray(scal[None]), d_true=g["d"], block_s=256,
            interpret=True)
    return np.asarray(out)[:S]


@pytest.mark.parametrize("B,S,n,n_live,d_true", [
    (1, 512, 64, 60, 4), (2, 256, 24, 20, 8), (3, 300, 40, 33, 11),
    (2, 77, 16, 16, 6)])      # tests/test_torch_tpe.py's SCORE_CASES
def test_both_layouts_match_pallas_interpret(B, S, n, n_live, d_true):
    g = chip_smoke.tpe_system(B, S, n, n_live, d_true, CPU, seed=3,
                              kind="holes")
    for name, pair in _both_layouts(g).items():
        for b in range(B):
            want = _pallas(g, b, name)
            for got in pair:
                np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                           atol=TOL, err_msg=name)


def test_both_layouts_match_plain_and_oracle_at_the_fleet_study_shape():
    """S 16,800, 200 live rows, d 6: the port's plain versions and the JAX
    package's jnp oracles (interpret mode is too slow at this S)."""
    g = chip_smoke.tpe_system(2, 16800, 256, 200, 6, CPU)
    plain = {"tpe_scores": ref.tpe_scores_ref(*g["tpe"], d_true=6),
             "parzen_logdens": ref.parzen_logdens_ref(*g["parzen"],
                                                      d_true=6)}
    for name, pair in _both_layouts(g).items():
        for b in range(2):
            if name == "tpe_scores":
                C, X, a, wg, wb, scal, _ = (t[b].numpy() for t in g["tpe"])
                orc = jref.tpe_scores_ref(
                    *map(jnp.asarray, (C, X, a, wg, wb, scal[None])),
                    d_true=6)
            else:
                C, X, w, scal, _ = (t[b].numpy() for t in g["parzen"])
                orc = jref.parzen_logdens_ref(
                    *map(jnp.asarray, (C, X, w)), scal[0], scal[1], 6)
            for got in pair:
                np.testing.assert_allclose(got[b].numpy(), np.asarray(orc),
                                           rtol=0, atol=TOL, err_msg=name)
                np.testing.assert_allclose(got[b].numpy(),
                                           plain[name][b].numpy(), rtol=0,
                                           atol=TOL, err_msg=name)


def test_fractional_weights_within_tolerance():
    """Non-0/1 weights and a row in both splits: both layouts within the
    tolerance of the plain version and the Pallas kernel (fmaf32 may round
    a product of two non-trivial floats twice, so no bitwise claim against
    another implementation is made here)."""
    g = chip_smoke.tpe_system(3, 300, 16, 3, 3, CPU, kind="shared")
    wg, wb = g["tpe"][3], g["tpe"][4]
    assert ((wg > 0) & (wb > 0)).any() and ((wg > 0) & (wg < 1)).any()
    plain = {"tpe_scores": ref.tpe_scores_ref(*g["tpe"], d_true=3),
             "parzen_logdens": ref.parzen_logdens_ref(*g["parzen"],
                                                      d_true=3)}
    for name, pair in _both_layouts(g).items():
        for b in range(3):
            want = _pallas(g, b, name)
            for got in pair:
                np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                           atol=TOL, err_msg=name)
                np.testing.assert_allclose(got[b].numpy(),
                                           plain[name][b].numpy(), rtol=0,
                                           atol=TOL, err_msg=name)
