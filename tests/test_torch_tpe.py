"""PyTorch port, TPE: the plain versions of the two TPE kernels against the
JAX package's Pallas kernels (interpret mode) and jnp oracles; the fused
proposal against the JAX program and the port's own numpy host oracle; TPE
and mixed GP + TPE banks against ``repro`` (picks, checkpoints both ways);
and, on a card, each CUDA kernel against its plain version.

Tolerances: scores agree to 1e-4 absolute, the JAX package's own
kernel-vs-oracle tolerance (``tests/test_kernels.py``): both sides sum fp32
Parzen terms in their own orders and floor each density at 1e-12 before the
log.  Picks must be equal: TPE picks the top of one score vector, and these
seeds keep it clear of near-ties (the JAX package's own parity tests use
them for that reason).

JAX is imported inside the tests that compare with it, so the card test
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_tpe.py
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.core as T
from repro_torch.core.tpe import TPEStrategy, fused_tpe_propose_bank
from repro_torch.kernels.tpe_kde import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}


def _jax():
    """The JAX reference: jax.numpy, the Pallas kernels, the jnp oracles,
    the TPE module and the core package."""
    import jax.numpy as jnp

    import repro.core as J
    from repro.core import tpe as jtpe
    from repro.kernels.tpe_kde import ops as jops, ref as jref, \
        tpe_kde as jkern
    return jnp, jkern, jref, jops, jtpe, J


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _objective(p):
    return -(p["x"] - 0.3) ** 2 - (p["y"] - 0.5) ** 2


# ------------------------------------------------------------------ kernels
def _score_inputs(B, S, n, n_live, d_true, seed=3):
    """Padded TPE scoring inputs for B studies: rows past ``n_live`` are
    zeros, every seventh live row is masked out of both splits, and the
    per-row scale differs along the dims."""
    rng = np.random.default_rng(seed)
    dp = 8 if d_true <= 8 else 16
    C = np.zeros((B, S, dp), np.float32)
    C[..., :d_true] = rng.uniform(size=(B, S, d_true))
    X = np.zeros((B, n, dp), np.float32)
    X[:, :n_live, :d_true] = rng.uniform(size=(B, n_live, d_true))
    row = np.arange(n)
    on = (row < n_live) & (row % 7 != 3)
    wg = np.zeros((B, n), np.float32)
    wb = np.zeros((B, n), np.float32)
    wg[:, on & (row < n_live // 4)] = 1.0
    wb[:, on & (row >= n_live // 4)] = 1.0
    base = np.where(wg[..., None] > 0, np.float32(3.1), np.float32(5.7))
    a = (base * np.linspace(0.5, 1.5, dp, dtype=np.float32)
         * rng.uniform(0.8, 1.2, size=(B, 1, 1)).astype(np.float32))
    scal = np.zeros((B, 4), np.float32)
    scal[:, 0] = 1.0 / wg.sum(1)
    scal[:, 1] = 1.0 / wb.sum(1)
    live = np.full(B, n_live, np.int32)
    return C, X, a.astype(np.float32), wg, wb, scal, live


SCORE_CASES = [  # (B, S, n, n_live, d_true): ragged S, masked rows, dp 8/16
    (1, 512, 64, 60, 4),
    (2, 256, 24, 20, 8),
    (3, 300, 40, 33, 11),
    (2, 77, 16, 16, 6),
]


@pytest.mark.parametrize("B,S,n,n_live,d_true", SCORE_CASES)
def test_tpe_scores_plain_matches_pallas_and_oracle(B, S, n, n_live,
                                                    d_true):
    jnp, jkern, jref, _, _, _ = _jax()
    C, X, a, wg, wb, scal, live = _score_inputs(B, S, n, n_live, d_true)
    got = ops.tpe_scores(*map(_t, (C, X, a, wg, wb, scal, live)),
                         d_true=d_true).numpy()
    Sp = -(-S // 256) * 256
    for b in range(B):
        args = [jnp.asarray(v) for v in (X[b], a[b], wg[b], wb[b],
                                         scal[b:b + 1])]
        Cp = np.zeros((Sp, C.shape[2]), np.float32)
        Cp[:S] = C[b]
        pal = jkern.tpe_scores_pallas(jnp.asarray(Cp), *args,
                                      d_true=d_true, block_s=256,
                                      interpret=True)
        orc = jref.tpe_scores_ref(jnp.asarray(C[b]), *args, d_true=d_true)
        np.testing.assert_allclose(got[b], np.asarray(pal)[:S], atol=1e-4)
        np.testing.assert_allclose(got[b], np.asarray(orc), atol=1e-4)


def test_tpe_scores_rows_past_live_count_are_ignored():
    """Rows at or past a study's live count contribute nothing, whatever
    they hold: the plain version masks them as the kernel skips them."""
    C, X, a, wg, wb, scal, live = _score_inputs(2, 100, 32, 20, 5)
    want = ref.tpe_scores_ref(*map(_t, (C, X, a, wg, wb, scal, live)),
                              d_true=5)
    X[:, 20:] = 0.5
    wg[:, 20:] = 1.0
    wb[:, 20:] = 1.0
    got = ref.tpe_scores_ref(*map(_t, (C, X, a, wg, wb, scal, live)),
                             d_true=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("m,n,d", [(500, 20, 2), (300, 64, 5),
                                   (257, 33, 11)])
def test_parzen_logdens_matches_pallas_and_host_oracle(m, n, d):
    _, _, _, jops, jtpe, _ = _jax()
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(n, d)).astype(np.float32)
    cands = rng.uniform(size=(m, d)).astype(np.float32)
    before = dict(ops.launches)
    got = ops.parzen_logdens(cands, pts, device="cpu")
    assert ops.launches == before                # CPU: plain version
    np.testing.assert_allclose(got, jops.parzen_logdens(cands, pts),
                               atol=1e-4)
    np.testing.assert_allclose(got, jtpe.TPEStrategy._log_kde(pts, cands),
                               atol=1e-4)
    np.testing.assert_allclose(got, TPEStrategy._log_kde(pts, cands),
                               atol=1e-4)


def test_plain_versions_stream_candidates_under_the_cap(monkeypatch):
    """A candidate count far past the temporary cap is scored chunk by
    chunk with the same result as one block."""
    C, X, a, wg, wb, scal, live = _score_inputs(2, 300, 24, 20, 6)
    args = list(map(_t, (C, X, a, wg, wb, scal, live)))
    whole = ref.tpe_scores_ref(*args, d_true=6)
    monkeypatch.setattr(ref, "_MAX_ELEMS", 2 * 20 * 6 * 7)   # 7 per chunk
    torch.testing.assert_close(ref.tpe_scores_ref(*args, d_true=6), whole,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "contig", "dp", "live", "d_true"])
def test_ops_reject_malformed_inputs(bad):
    args = dict(zip(("C", "X", "a", "wg", "wb", "scal", "live"),
                    map(_t, _score_inputs(2, 40, 16, 10, 3))))
    d_true = 3
    if bad == "dtype":
        args["wg"] = args["wg"].double()
    elif bad == "contig":
        args["a"] = args["a"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dp":
        args["C"] = args["C"][..., :5].contiguous()
        args["X"] = args["X"][..., :5].contiguous()
        args["a"] = args["a"][..., :5].contiguous()
    elif bad == "live":
        args["live"] = args["live"].long()
    else:
        d_true = 9
    with pytest.raises((TypeError, ValueError)):
        ops.tpe_scores(*args.values(), d_true=d_true)


# ------------------------------------------------------- fused proposal
def _data(seed=0, n=20, n_cand=300, d=2, n_pend=3):
    """The JAX package's parity-suite data (test_device_proposal_parity)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (-np.sum((X - 0.6) ** 2, -1)
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    C = rng.uniform(size=(n_cand, d)).astype(np.float32)
    P = rng.uniform(size=(n_pend, d)).astype(np.float32)
    return X, y, C, P


def _anisotropic(seed):
    rng = np.random.default_rng(seed)
    n, S = 24, 300
    X = np.stack([rng.uniform(size=n),
                  (rng.uniform(size=n) < 0.3).astype(float),
                  0.5 + 0.02 * rng.normal(size=n)], 1).astype(np.float32)
    y = (-(X[:, 0] - 0.6) ** 2 - 0.3 * X[:, 1]
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    C = np.stack([rng.uniform(size=S),
                  (rng.uniform(size=S) < 0.5).astype(float),
                  0.5 + 0.02 * rng.normal(size=S)], 1).astype(np.float32)
    return X, y, C


def _bank_inputs(problems, gamma, penalty):
    """Stack single-study problems (X, y, C, P) into the bank layout of
    ``StudyBank._dispatch_tpe``: observed rows, pending rows, zeros."""
    d = problems[0][0].shape[1]
    dp = ops.pad_dims(d)
    na = ops.pad_rows(max(len(X) + (len(P) if P is not None else 0)
                          for X, _, _, P in problems), 16)
    S = max(len(C) for _, _, C, _ in problems)
    B = len(problems)
    Xb = np.zeros((B, na, dp), np.float32)
    yb = np.zeros((B, na), np.float32)
    Cb = np.zeros((B, S, dp), np.float32)
    meta = np.zeros((B, 4), np.float32)
    for b, (X, y, C, P) in enumerate(problems):
        n = len(X)
        kp = len(P) if (P is not None and penalty) else 0
        Xb[b, :n, :d] = X
        yb[b, :n] = y
        if kp:
            Xb[b, n:n + kp, :d] = P
        Cb[b, :len(C), :d] = C
        meta[b] = (n, kp, len(C), gamma)
    return Xb, yb, Cb, meta


def _three_way(problems, batch, gamma=0.25, penalty=False):
    """Picks of the port's bank program, the JAX bank program (its jnp
    path), and the port's numpy host oracle, per study."""
    jnp, _, _, _, jtpe, _ = _jax()
    Xb, yb, Cb, meta = _bank_inputs(problems, gamma, penalty)
    d = problems[0][0].shape[1]
    port = fused_tpe_propose_bank(*map(_t, (Xb, yb, Cb, meta)),
                                  batch_size=batch, d_true=d).numpy()
    jax_ = np.asarray(jtpe.fused_tpe_propose_bank(
        *map(jnp.asarray, (Xb, yb, Cb, meta)), batch_size=batch, d_true=d,
        use_pallas=False))
    host = [TPEStrategy(d, 1e4, gamma=gamma, pending_penalty=penalty)
            .propose_host(X, y, C, batch, pending=P)
            for X, y, C, P in problems]
    return port.tolist(), jax_.tolist(), host


def _propose(s, X, y, C, batch, pending=None):
    """One study's picks by the bank program at B = 1, with strategy
    ``s``'s gamma and pending penalty."""
    Xb, yb, Cb, meta = _bank_inputs([(X, y, C, pending)], s.gamma,
                                    s.pending_penalty)
    return fused_tpe_propose_bank(*map(_t, (Xb, yb, Cb, meta)),
                                  batch_size=batch,
                                  d_true=X.shape[1])[0].tolist()


@pytest.mark.parametrize("n_cand", [300, 600])
def test_fused_bank_matches_jax_and_host(n_cand):
    problems = [_data(seed=s, n_cand=n_cand)[:3] + (None,)
                for s in range(4)]
    port, jax_, host = _three_way(problems, 4)
    assert port == jax_ == host


def test_fused_bank_pending_penalty_matches_jax_and_host():
    problems = [_data(seed=s, n_cand=300) for s in range(3)]
    port, jax_, host = _three_way(problems, 4, penalty=True)
    assert port == jax_ == host


def test_fused_bank_anisotropic_bandwidths_match_jax_and_host():
    problems = [_anisotropic(s) + (None,) for s in range(3)]
    port, jax_, host = _three_way(problems, 4)
    assert port == jax_ == host
    scale = TPEStrategy._dim_scale(problems[2][0])
    assert scale[2] == np.float32(0.1)                  # clip floor binds


def test_strategy_propose_matches_host_and_jax_single_study():
    """The bank program at B = 1 on the CPU against the port's host oracle
    and the JAX strategy's single-study proposal, with the pending
    penalty."""
    _, _, _, _, jtpe, _ = _jax()
    for seed in range(3):
        X, y, C, P = _data(seed=seed)
        kw = dict(pending_penalty=True)
        port = TPEStrategy(2, 1e4, **kw)
        want = port.propose_host(X, y, C, 4, pending=P)
        assert _propose(port, X, y, C, 4, pending=P) == want
        assert jtpe.TPEStrategy(2, 1e4, **kw).propose(X, y, C, 4,
                                                      pending=P) == want


def test_naive_parallelism_ignores_pending():
    X, y, C, P = _data(seed=1, n_cand=400)
    s = TPEStrategy(2, 1e4)
    assert _propose(s, X, y, C, 4) == _propose(s, X, y, C, 4, pending=P)


def test_pending_penalty_breaks_topb_duplication():
    X, y, C, _ = _data(seed=1, n_cand=400)
    naive = TPEStrategy(2, 1e4)
    first = _propose(naive, X, y, C, 1)
    assert _propose(naive, X, y, C, 1, pending=C[first]) == first
    pen = TPEStrategy(2, 1e4, pending_penalty=True)
    assert _propose(pen, X, y, C, 1, pending=C[first]) != first


def test_batch_valid_unique_and_clamped():
    X, y, C, _ = _data(seed=5, n_cand=300)
    s = TPEStrategy(2, 1e4)
    picks = _propose(s, X, y, C, 6)
    assert len(set(picks)) == 6 and all(0 <= p < len(C) for p in picks)
    tiny = C[:3]
    assert sorted(_propose(s, X, y, tiny, 8)) == [0, 1, 2] == \
        sorted(s.propose_host(X, y, tiny, 8))


def test_equal_scores_keep_the_lower_index_first():
    """Candidates far from every observation sit on the 1e-12 floor in
    every dim of both splits: their scores are exactly equal, and the
    stable descending sort takes them in index order, as lax.top_k does."""
    X, y, _, _ = _data(seed=0)
    C = np.full((6, 2), 50.0, np.float32)
    C[4] = X[int(np.argmax(y))]               # one real candidate
    Xb, yb, Cb, meta = _bank_inputs([(X, y, C, None)], 0.25, False)
    picks = fused_tpe_propose_bank(*map(_t, (Xb, yb, Cb, meta)),
                                   batch_size=6, d_true=2)[0].tolist()
    assert sorted(picks) == list(range(6))
    assert [i for i in picks if i != 4] == [0, 1, 2, 3, 5]


def test_tpe_validation():
    with pytest.raises(ValueError):
        TPEStrategy(2, 1e4, gamma=0.0)
    with pytest.raises(ValueError):
        TPEStrategy(2, 1e4, gamma=0.6)
    with pytest.raises(ValueError):
        TPEStrategy(0, 1e4)
    with pytest.raises(ValueError):
        TPEStrategy(2, 0.0)
    TPEStrategy(2, 1e4, gamma=0.5)


# -------------------------------------------------------------- the bank
def _seeded_tpe_bank(pkg, n_obs, seed=31, **kw):
    """One TPE study with ``n_obs`` noisy observations."""
    rng = np.random.default_rng(seed)
    bank = pkg.StudyBank(SPACE, 1, seed=seed, mc_samples=64,
                         optimizer="tpe", **kw)
    v = bank.study(0)
    for _ in range(n_obs):
        p = {"x": float(rng.uniform(0, 1)), "y": float(rng.uniform(-1, 1))}
        v.observe_params(p, float(rng.normal()))
    return bank


@pytest.mark.parametrize("n_obs", [15, 16, 17, 31, 32, 33])
def test_tpe_bank_picks_match_repro_at_bucket_edges(n_obs):
    J = _jax()[5]
    jb = _seeded_tpe_bank(J, n_obs)
    tb = _seeded_tpe_bank(T, n_obs, device="cpu")
    jt, tt = jb.ask_all(2)[0], tb.ask_all(2)[0]
    assert [t.params for t in tt] == [t.params for t in jt]
    # a second ask with those two in flight, penalty on
    jb.strategy_kwargs["pending_penalty"] = True
    tb.strategy_kwargs["pending_penalty"] = True
    jt, tt = jb.ask_all(3)[0], tb.ask_all(3)[0]
    assert [t.params for t in tt] == [t.params for t in jt]


def _gp_near_tie(jb, b, state, jt, tt, n_mc=64):
    """Judge differing GP picks of study ``b`` by the float64 GP-BUCB
    oracle of ``chip_smoke`` on the JAX bank's state right after the ask
    (before its tells)."""
    replay = np.random.default_rng(0)
    replay.bit_generator.state = state
    cols = jb.space.sample_columns(jb.n_studies * n_mc, replay)
    C = jb.space.encode_columns(cols, jb.n_studies * n_mc).reshape(
        jb.n_studies, n_mc, -1)[b]

    def index(trials):
        return [int(np.flatnonzero((C == r).all(1))[0])
                for r in jb.space.encode([t.params for t in trials])]

    led = jb.ledger
    ids = led.obs_ids(b)
    X = led.X[b, ids]
    z = (led.y[b, ids].astype(np.float32) - led.y_mean[b]) / led.y_std[b]

    def oracle(prev):
        return chip_smoke.bucb_acquisition(
            X, z, C, np.exp(led.log_ls[b]), np.exp(led.log_var[b]),
            np.exp(led.log_noise[b]) + 1e-5, prev, jb.study(b).domain_size)

    return chip_smoke.picks_agree(index(tt), index(jt), oracle)[0]


def test_mixed_bank_matches_repro_over_three_rounds():
    """A bank of bayesian and tpe studies against the same JAX bank: one
    candidate draw, TPE picks equal, GP picks equal except on near-ties of
    the float64 GP-BUCB oracle (after which that study is left alone)."""
    J = _jax()[5]
    names = ["bayesian", "tpe", "bayesian", "tpe"]
    kw = dict(optimizer=names, seed=2, mc_samples=64, fit_steps=10)
    jb = J.StudyBank(SPACE, 4, **kw)
    tb = T.StudyBank(SPACE, 4, device="cpu", **kw)
    for b in range(4):
        for i in range(3):
            p = {"x": 0.2 * i + 0.1 * b, "y": 0.3 * i - 0.4}
            jb.study(b).observe_params(p, _objective(p))
            tb.study(b).observe_params(p, _objective(p))
    diverged = set()
    for _ in range(3):
        state = jb._rng.bit_generator.state
        jt, tt = jb.ask_all(2), tb.ask_all(2)
        for b, name in enumerate(names):
            if b in diverged:
                continue
            same = [t.params for t in tt[b]] == [t.params for t in jt[b]]
            if name == "tpe":
                assert same, b
            elif not same:
                assert _gp_near_tie(jb, b, state, jt[b], tt[b]), b
                diverged.add(b)
        for bank, trials in ((jb, jt), (tb, tt)):
            for b, ts in enumerate(trials):
                for t in ts:
                    bank.tell(b, t.id, _objective(t.params))
    assert tb.optimizer == jb.optimizer == "mixed"


def test_mixed_bank_npz_moves_both_ways(tmp_path):
    """A JAX-written mixed-bank checkpoint loads in the port and gives the
    same next picks; the port's save of it loads back into ``repro``."""
    J = _jax()[5]
    names = ["bayesian", "tpe", "random", "tpe"]
    kw = dict(seed=5, mc_samples=48, fit_steps=10)
    jb = J.StudyBank(SPACE, 4, optimizer=names, **kw)
    for _ in range(3):
        for b, ts in enumerate(jb.ask_all(2)):
            for t in ts:
                jb.tell(b, t.id, _objective(t.params))
    jb.ask_all(1)                              # one trial left in flight
    p1, p2 = tmp_path / "jax.npz", tmp_path / "port.npz"
    jb.save(p1, iteration=3)
    tb = T.StudyBank(SPACE, 4, optimizer="bayesian", device="cpu", **kw)
    assert tb.load(p1) == 3
    assert tb.strategy_names == names and tb.optimizer == "mixed"
    assert tb.state_dict() == jb.state_dict()
    tb.save(p2, iteration=4)
    back = J.StudyBank(SPACE, 4, **kw)
    assert back.load(p2) == 4
    assert back.state_dict() == jb.state_dict()
    jt, tt = jb.ask_all(2), tb.ask_all(2)
    for b in (1, 2, 3):                        # tpe and random: exact
        assert [t.params for t in tt[b]] == [t.params for t in jt[b]]


def test_all_tpe_bank_skips_the_gp_stage(monkeypatch):
    """An all-TPE bank never builds the GP observation stage, and each ask
    is one ``tpe_scores`` call for the whole bank."""
    calls = {"scores": 0}
    orig = ops.tpe_scores

    def counting(*a, **k):
        calls["scores"] += 1
        return orig(*a, **k)

    def boom(*a, **k):
        raise AssertionError("GP observation stage built for a TPE bank")

    monkeypatch.setattr(ops, "tpe_scores", counting)
    bank = T.StudyBank(SPACE, 3, optimizer="tpe", seed=1, mc_samples=50,
                       device="cpu")
    monkeypatch.setattr(bank, "_obs_stage", boom)
    for _ in range(4):
        for b, ts in enumerate(bank.ask_all(2)):
            for t in ts:
                bank.tell(b, t.id, _objective(t.params))
    assert calls["scores"] == 3            # the first ask is random phase


# ------------------------------------------------ optimizer and tuner
def test_optimizer_forwards_and_validates_strategy_kwargs():
    FAST = dict(mc_samples=200, fit_steps=10)
    opt = T.AskTellOptimizer(SPACE, optimizer="tpe", seed=0, device="cpu",
                             strategy_kwargs={"gamma": 0.5}, **FAST)
    for t in opt.ask(2):
        opt.tell(t.id, _objective(t.params))
    opt.ask(1)
    assert opt._strat.gamma == 0.5
    assert opt._strat.domain_size == opt.domain_size
    bad = T.AskTellOptimizer(SPACE, optimizer="tpe", seed=0, device="cpu",
                             strategy_kwargs={"gamme": 0.5}, **FAST)
    with pytest.raises(TypeError):      # strategy built on the first ask
        bad.ask(1)


@pytest.mark.parametrize("batch", [1, 3])
def test_tpe_tuner_matches_repro(batch):
    """The whole Tuner run (random phase, then TPE asks through the
    bank-of-one) tries exactly the JAX package's configs."""
    J = _jax()[5]
    conf = dict(optimizer="tpe", batch_size=batch, num_iteration=6, seed=5,
                mc_samples=300, initial_random=3)

    def objective(ps):
        return [_objective(p) for p in ps], list(ps)

    want = J.Tuner(SPACE, objective, dict(conf)).maximize()
    got = T.Tuner(SPACE, objective, dict(conf, device="cpu")).maximize()
    assert got.params_tried == want.params_tried
    assert got.best_trace == want.best_trace


def test_tpe_sync_kill_resume_replays_proposals(tmp_path):
    conf = dict(optimizer="tpe", num_iteration=6, batch_size=2, seed=5,
                mc_samples=300, device="cpu")

    def objective(ps):
        return [_objective(p) for p in ps], list(ps)

    full = T.Tuner(SPACE, objective, conf).maximize()
    ckpt = tmp_path / "tpe_sync.json"
    conf_i = {**conf, "checkpoint_path": str(ckpt), "num_iteration": 3}
    T.Tuner(SPACE, objective, conf_i).maximize()
    resumed = T.Tuner(SPACE, objective,
                      {**conf_i, "num_iteration": 6}).maximize()
    assert resumed.params_tried == full.params_tried


def test_tpe_ask_without_a_card_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.StudyBank(SPACE, 1, optimizer="tpe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.parzen_logdens(np.zeros((3, 2)), np.ones((2, 2)))


# ------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,na,n_live,d,kind", [
    (3, 257, 24, 17, 11, "holes"),    # ragged S, masked rows, dp 16
    (8, 16800, 256, 200, 6, "ask"),   # the fleet's per-study shape
    (16, 16800, 256, 200, 6, "ask"),  # R 2 candidates a thread (132 SMs)
    (24, 16800, 256, 200, 6, "ask"),  # R 4 (the fleet runs 8, one study 1)
    (2, 3000, 4096, 4000, 6, "ask"),  # sixteen row tiles per dimension
    (3, 300, 16, 3, 3, "shared"),     # fractional weights, a row in both
])
def test_cuda_tpe_kernels_match_plain_versions(B, S, na, n_live, d, kind):
    """Both CUDA kernels against their plain versions on the card, with
    the tolerance ``chip_smoke.tpe_kernel_errors`` states; each launch is
    counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n0 = dict(ops.launches)
    errs, _ = chip_smoke.tpe_kernel_errors(B, S, na, n_live, d,
                                           torch.device("cuda"), kind=kind)
    torch.cuda.synchronize()
    assert ops.launches == {k: v + 1 for k, v in n0.items()}
    for name, (err, tol) in errs.items():
        assert err <= tol, (name, err, tol)


@pytest.mark.cuda
def test_cuda_tpe_bank_picks_match_cpu():
    """A TPE bank asks the same picks on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    picks = {}
    for dev in ("cuda", "cpu"):
        bank = T.StudyBank(SPACE, 4, optimizer="tpe", seed=3, mc_samples=500,
                           device=dev,
                           strategy_kwargs={"pending_penalty": True})
        hist = []
        for r in range(5):
            for b, ts in enumerate(bank.ask_all(2)):
                for t in ts:
                    hist.append(json.dumps(t.params, sort_keys=True))
                    if r % 2 == 0:
                        bank.tell(b, t.id, _objective(t.params))
        picks[dev] = hist
    assert picks["cuda"] == picks["cpu"]
