"""PyTorch port, host side of the bank and optimizer against the JAX package:
search spaces and random-phase asks bit-identical, GP-phase picks equal at
bucket edges (up to near-ties judged by the float64 oracle of
``chip_smoke``), npz checkpoints readable both ways, and kill -> resume
replaying the port's own proposals bitwise.  Everything runs on the CPU."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import stats

import repro.core as J
import repro_torch.core as T
from repro_torch.core.studybank import pack_rng_state, unpack_rng_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}


def _objective(p):
    return -(p["x"] - 0.3) ** 2 - (p["y"] - 0.5) ** 2


def _space(pkg, kind):
    """The same search space built from one package's classes."""
    if kind == "flat":
        return {"x": stats.uniform(-2, 4), "n": range(1, 9),
                "act": ["relu", "tanh", "gelu"], "w": [0.1, 0.5, 0.9],
                "lr": pkg.loguniform(-4, 3), "c": 7}
    if kind == "conditional":
        return {"algo": pkg.Choice({
                    "sgd": {"momentum": stats.uniform(0, 1)},
                    "adam": {"beta2": [0.99, 0.999],
                             "eps_exp": pkg.Int(-9, -6)}}),
                "lr_exp": stats.uniform(-4, 3),
                "tile": pkg.LogInt(16, 512)}
    return {"a": stats.uniform(0, 1), "b": stats.uniform(0, 1)}


def _param_space(pkg, kind):
    cons = ([lambda c: c["a"] + c["b"] < 1.0] if kind == "constrained"
            else None)
    return pkg.ParamSpace(_space(pkg, kind), constraints=cons)


@pytest.mark.parametrize("kind", ["flat", "conditional", "constrained"])
def test_spaces_bit_identical(kind):
    js, ts = _param_space(J, kind), _param_space(T, kind)
    assert ts.dim == js.dim
    assert ts.domain_size == js.domain_size
    assert ts.mc_samples(4) == js.mc_samples(4)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    jc, tc = js.sample_columns(300, jr), ts.sample_columns(300, tr)
    assert jr.bit_generator.state == tr.bit_generator.state
    je, te = js.encode_columns(jc, 300), ts.encode_columns(tc, 300)
    np.testing.assert_array_equal(te, je)
    idx = [0, 7, 299, 150]
    assert ts.configs_at(tc, idx) == js.configs_at(jc, idx)
    assert ts.decode(te[:20]) == js.decode(je[:20])
    rows_j, rows_t = js.sample(50, jr), ts.sample(50, tr)
    assert rows_t == rows_j
    assert jr.bit_generator.state == tr.bit_generator.state
    np.testing.assert_array_equal(ts.encode(rows_t), js.encode(rows_j))
    assert [ts.feasible(r) for r in rows_t] == [js.feasible(r)
                                                for r in rows_j]


@pytest.mark.parametrize("opt", ["bayesian", "random"])
def test_random_phase_asks_bit_identical(opt):
    """Asks before the GP phase (and every random-strategy ask) are host
    draws: the same trials and the same RNG stream as the JAX package."""
    kw = dict(optimizer=opt, seed=9, mc_samples=40)
    jo = J.AskTellOptimizer(SPACE, **kw)
    to = T.AskTellOptimizer(SPACE, device="cpu", **kw)
    rounds = 4 if opt == "random" else 1
    for _ in range(rounds):
        jt, tt = jo.ask(3), to.ask(3)
        assert [t.params for t in tt] == [t.params for t in jt]
        assert [t.id for t in tt] == [t.id for t in jt]
        for a, b in zip(jt, tt):
            jo.tell(a.id, _objective(a.params))
            to.tell(b.id, _objective(b.params))
    assert to.state_dict() == jo.state_dict()


def _seeded_bank(pkg, n_obs, seed=31, **kw):
    """One study with ``n_obs`` noisy observations and frozen hypers (no
    fit runs during the ask under test)."""
    rng = np.random.default_rng(seed)
    bank = pkg.StudyBank(SPACE, 1, seed=seed, mc_samples=64, **kw)
    v = bank.study(0)
    for _ in range(n_obs):
        p = {"x": float(rng.uniform(0, 1)), "y": float(rng.uniform(-1, 1))}
        v.observe_params(p, float(rng.normal()))
    led = bank.ledger
    led.have_fit[0] = 1
    led.n_fit[0] = n_obs
    led.log_ls[0] = np.log(0.5)
    led.log_var[0] = 0.1
    led.log_noise[0] = np.log(1e-2)
    led.y_mean[0] = 0.0
    led.y_std[0] = 1.0
    return bank


@pytest.mark.parametrize("n_obs", [15, 16, 17, 31, 32, 33])
def test_gp_phase_picks_match_repro_at_bucket_edges(n_obs):
    n = 2
    jb = _seeded_bank(J, n_obs)
    tb = _seeded_bank(T, n_obs, device="cpu")
    state = jb._rng.bit_generator.state
    jt, tt = jb.ask_all(n)[0], tb.ask_all(n)[0]
    replay = np.random.default_rng(0)
    replay.bit_generator.state = state
    cols = jb.space.sample_columns(64, replay)
    C = jb.space.encode_columns(cols, 64)

    def index(trials):
        enc = jb.space.encode([t.params for t in trials])
        return [int(np.flatnonzero((C == r).all(1))[0]) for r in enc]

    led = jb.ledger
    ids = led.obs_ids(0)
    X = led.X[0, ids]
    z = led.y[0, ids].astype(np.float32)

    def oracle(prev):
        return chip_smoke.bucb_acquisition(
            X, z, C, np.full(2, 0.5), np.exp(0.1), 1e-2 + 1e-5, prev,
            jb.study(0).domain_size)

    ok, slot = chip_smoke.picks_agree(index(tt), index(jt), oracle)
    assert ok, (slot, index(tt), index(jt))
    assert tb.ledger.gp_capacity == jb.ledger.gp_capacity


def test_pick_fills_the_last_bucket_row_and_refuses_past_it():
    """With 15 observations in a 16-row bucket, two picks append the first
    at row 15 (the downdate writes the block's last column); a third would
    need row 16 and is refused on the host before any kernel runs."""
    tb = _seeded_bank(T, 15, device="cpu")
    ko = tb.ledger.n_observed().astype(np.int32)
    cache = tb._obs_stage(ko, 16)
    C = np.random.default_rng(3).uniform(size=(1, 64, 2)).astype(np.float32)
    rows, kp = np.array([0]), np.zeros(1, np.int32)
    idx = tb._pick_gp(cache, rows, C, ko, kp, 2, 4)
    assert idx.shape == (1, 2) and idx[0, 0] != idx[0, 1]
    with pytest.raises(ValueError, match="no room for 3 picks"):
        tb._pick_gp(cache, rows, C, ko, kp, 3, 4)


def _run(bank, steps, leave_pending=False):
    """Drive every study; returns the proposal history.  With
    ``leave_pending`` every third ask stays in flight."""
    hist = []
    for s in range(steps):
        for b, ts in enumerate(bank.ask_all(1)):
            for t in ts:
                hist.append((b, t.id, dict(t.params)))
                if not (leave_pending and s % 3 == 2):
                    bank.tell(b, t.id, _objective(t.params))
    return hist


def test_npz_round_trip_repro_port_repro(tmp_path):
    """A JAX-written checkpoint loads in the port with identical state; the
    port's save of it loads back into the JAX package identically."""
    kw = dict(seed=2, mc_samples=32)
    jb = J.StudyBank(SPACE, 4, **kw)
    _run(jb, 4, leave_pending=True)
    jb.extra = {"names": ["a", "b"]}
    p1, p2 = tmp_path / "jax.npz", tmp_path / "port.npz"
    jb.save(p1, iteration=4)
    tb = T.StudyBank(SPACE, 4, seed=77, mc_samples=32, device="cpu")
    assert tb.load(p1) == 4
    assert tb.state_dict() == jb.state_dict()
    assert tb.extra == jb.extra
    tb.save(p2, iteration=5)
    back = J.StudyBank(SPACE, 4, seed=1, mc_samples=32)
    assert back.load(p2) == 5
    assert back.state_dict() == jb.state_dict()
    for name in J.StudyLedger.ARRAY_FIELDS:
        a, b = getattr(back.ledger, name), getattr(jb.ledger, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with np.load(p1) as z1, np.load(p2) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        m1 = json.loads(bytes(z1["meta"]).decode())
        m2 = json.loads(bytes(z2["meta"]).decode())
    assert {**m1, "iteration": 5} == m2


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_port_kill_resume_replays_bitwise(mode, tmp_path):
    """A bank killed mid-flight resumes to the exact proposals of an
    uninterrupted run, through the npz checkpoint and the JSON state dict
    (async: a third of the asks still in flight at the kill)."""
    pending = mode == "async"
    kw = dict(seed=11, mc_samples=32, device="cpu")
    ref = T.StudyBank(SPACE, 6, **kw)
    h_ref = _run(ref, 5, pending) + _run(ref, 3, pending)
    a = T.StudyBank(SPACE, 6, **kw)
    _run(a, 5, pending)
    path = tmp_path / f"{mode}.npz"
    a.save(path)
    b = T.StudyBank(SPACE, 6, **kw)
    b.load(path)
    h_npz = _run(b, 3, pending)
    assert h_npz == h_ref[len(h_ref) - len(h_npz):]
    c = T.StudyBank(SPACE, 6, **kw)
    c.load_state_dict(json.loads(json.dumps(a.state_dict())))
    h_json = _run(c, 3, pending)
    assert h_json == h_ref[len(h_ref) - len(h_json):]


def test_journal_replay_matches_live_bank():
    """Applying the journaled ops to a snapshot reproduces the live bank:
    the same trials and the same state."""
    kw = dict(seed=4, mc_samples=32, device="cpu")
    live = T.StudyBank(SPACE, 2, **kw)
    snap = json.loads(json.dumps(live.state_dict()))
    ops, seq = [], 0

    def do(op):
        nonlocal seq
        seq += 1
        op = {"seq": seq, **op}
        live.validate_op(op)
        ops.append(op)
        return live.apply_op(op)

    do({"op": "create", "study": 1, "sign": -1.0})
    for i in range(4):
        do({"op": "observe", "study": i % 2,
            "params": {"x": 0.1 * i, "y": 0.2 - 0.1 * i}, "value": 0.3 * i})
    for _ in range(2):
        for b in range(2):
            for t in do({"op": "ask", "study": b, "n": 2}):
                do({"op": "tell", "study": b, "trial_id": t.id,
                    "value": _objective(t.params)})
    do({"op": "trace", "study": 0})
    replay = T.StudyBank(SPACE, 2, **kw)
    replay.load_state_dict(snap)
    for op in ops:
        replay.apply_op(op)
    assert replay.state_dict() == live.state_dict()
    assert replay.apply_op(ops[-1]) is None          # already applied
    with pytest.raises(ValueError):
        replay.apply_op({**ops[0], "seq": seq + 2})  # gap in the journal
    with pytest.raises(KeyError):
        live.validate_op({"seq": seq + 1, "op": "tell", "study": 0,
                          "trial_id": 999, "value": 1.0})


def test_rng_state_pack_roundtrip():
    rng = np.random.default_rng(1234)
    rng.uniform(size=7)
    rng.integers(0, 10)  # leaves a cached uint32 in the bit generator
    clone = unpack_rng_state(pack_rng_state(rng))
    assert list(clone.uniform(size=5)) == list(rng.uniform(size=5))
    assert clone.bit_generator.state == rng.bit_generator.state


REF = dict(optimizer="hallucination_ref", mc_samples=300, fit_steps=10)


def _ref_rounds(opt, rounds, n=3):
    """Ask/tell rounds of one optimizer; returns the asked params."""
    out = []
    for _ in range(rounds):
        ts = opt.ask(n)
        out.append([t.params for t in ts])
        for t in ts:
            opt.tell(t.id, _objective(t.params))
    return out


@pytest.mark.parametrize("where", ["optimizer", "tuner", "bank"])
def test_hallucination_ref_asks_match_repro(where):
    """``optimizer="hallucination_ref"`` asks through its strategy's own
    ``propose`` (the reference loop) in ``AskTellOptimizer``, in ``Tuner``
    (with the factor-core scorer through ``strategy_kwargs``) and as one
    study of a mixed ``StudyBank``: the same trials as the JAX package."""
    if where == "optimizer":
        jo = J.AskTellOptimizer(SPACE, seed=4, **REF)
        to = T.AskTellOptimizer(SPACE, seed=4, device="cpu", **REF)
        assert _ref_rounds(to, 4) == _ref_rounds(jo, 4)
        assert type(to._strat).__name__ == "HallucinationStrategy"
        assert to._bank is None          # never reached the bank pipeline
    elif where == "tuner":
        conf = dict(REF, batch_size=3, num_iteration=4, seed=2,
                    strategy_kwargs={"scorer": "kinv_jnp"})

        def objective(batch):
            return [_objective(p) for p in batch], list(batch)
        jr = J.Tuner(SPACE, objective, conf).maximize()
        tr = T.Tuner(SPACE, objective, dict(conf, device="cpu")).maximize()
        assert tr.params_tried == jr.params_tried
        assert tr.objective_values == jr.objective_values
    else:
        names = ["bayesian", "hallucination_ref", "tpe"]
        kw = dict(seed=6, mc_samples=300, fit_steps=10, optimizer=names)
        jb, tb = J.StudyBank(SPACE, 3, **kw), T.StudyBank(SPACE, 3,
                                                          device="cpu", **kw)
        for _ in range(3):
            jt, tt = jb.ask_all(2), tb.ask_all(2)
            assert [t.params for t in tt[1]] == [t.params for t in jt[1]]
            assert [len(ts) for ts in tt] == [2, 2, 2]
            for bank, trials in ((jb, jt), (tb, tt)):
                for b, ts in enumerate(trials):
                    for t in ts:
                        bank.tell(b, t.id, _objective(t.params))


def test_hallucination_ref_checkpoints_resume_both_ways():
    """A JAX package state dict of a ``hallucination_ref`` optimizer (its
    ``"gp"`` entry the strategy GP's fit schedule) resumes in the port with
    the remaining proposals of the uninterrupted JAX run, and the
    reverse."""
    pk = {"jax": (J, {}), "port": (T, {"device": "cpu"})}
    for src, dst in (("jax", "port"), ("port", "jax")):
        (sm, skw), (dm, dkw) = pk[src], pk[dst]
        full = _ref_rounds(sm.AskTellOptimizer(SPACE, seed=8, **REF, **skw),
                           5)
        part = sm.AskTellOptimizer(SPACE, seed=8, **REF, **skw)
        assert _ref_rounds(part, 3) == full[:3]
        sd = json.loads(json.dumps(part.state_dict()))
        assert sd["gp"]["n_fit"] == 6   # the third ask fit the six told
        resumed = dm.AskTellOptimizer(SPACE, seed=0, **REF, **dkw)
        resumed.load_state_dict(sd)
        assert _ref_rounds(resumed, 2) == full[3:], (src, dst)


@pytest.mark.parametrize("where", ["optimizer", "bank"])
def test_clustering_asks(where):
    """``optimizer="clustering"`` asks past the random phase, alone and in
    a bank: distinct, valid candidates, the studies' ask counts advance."""
    if where == "optimizer":
        opt = T.AskTellOptimizer(SPACE, optimizer="clustering", seed=3,
                                 mc_samples=64, fit_steps=5, device="cpu")
        ask = lambda: [opt.ask(3)]                       # noqa: E731
        tell = lambda b, t, v: opt.tell(t.id, v)         # noqa: E731
        views = [opt]
    else:
        bank = T.StudyBank(SPACE, 2, optimizer="clustering", seed=3,
                           mc_samples=64, fit_steps=5, device="cpu")
        ask = lambda: bank.ask_all(3)                    # noqa: E731
        tell = lambda b, t, v: bank.tell(b, t.id, v)     # noqa: E731
        views = bank.studies
    for _ in range(3):
        for b, ts in enumerate(ask()):
            assert len({(t.params["x"], t.params["y"]) for t in ts}) == 3
            for t in ts:
                assert 0 <= t.params["x"] <= 1 and -1 <= t.params["y"] <= 1
                tell(b, t, _objective(t.params))
    assert all(v.n_observed == 9 and v._ask_count == 3 for v in views)
