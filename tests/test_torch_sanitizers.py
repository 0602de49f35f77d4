"""PyTorch port, runtime sanitizers (``repro_torch.analysis.sanitizers``):
the cases of ``tests/test_sanitizers.py`` on the port, the bank's
signature audit held against the JAX package's jit-cache audit on the same
drive, the absorb repair (host counts, unchanged picks), and card cases
that skip without one.  The JAX package is imported only inside the tests
that hold the port against it, so the card cases run where JAX is absent."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

import repro_torch.core as T
from repro_torch.analysis import sanitizers
from repro_torch.analysis.sanitizers import (EntryPoint, RetraceError,
                                             assert_holds,
                                             debug_locks_enabled, no_retrace,
                                             no_transfer, set_debug_locks,
                                             to_device, to_host)
from repro_torch.core import gp as t_gp
from repro_torch.core import scoring as t_scoring
from repro_torch.kernels import build
from repro_torch.kernels.gp_acquisition import ops as gp_ops

ROOT = Path(__file__).resolve().parents[1]
SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}


def _objective(p):
    return -(p["x"] - 0.3) ** 2 - (p["y"] - 0.5) ** 2


def _drive(bank, rounds):
    for _ in range(rounds):
        for b, ts in enumerate(bank.ask_all(1)):
            for t in ts:
                bank.tell(b, t.id, _objective(t.params))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# --------------------------------------------------------------------------- #
# no_retrace
# --------------------------------------------------------------------------- #
def test_no_retrace_clean_on_cache_hits():
    f = EntryPoint(lambda x: x + 1)
    f(torch.ones(4))  # warm
    with no_retrace({"f": f}) as rep:
        f(torch.ones(4))
        f(torch.ones(4))
    assert rep.violations == 0
    assert rep.deltas == {"f": 0}
    assert rep.detail() == ""


def test_no_retrace_raises_on_new_shape():
    f = EntryPoint(lambda x: x * 2)
    f(torch.ones(4))
    with pytest.raises(RetraceError, match="bad_entry=1/0"):
        with no_retrace({"bad_entry": f}):
            f(torch.ones(8))  # new shape -> new signature


def test_no_retrace_expected_budget_allows_known_compiles():
    f = EntryPoint(lambda x: x - 1)
    f(torch.ones(4))
    with no_retrace({"f": f}, expected={"f": 1}) as rep:
        f(torch.ones(8))
        f(torch.ones(8))  # second call is a hit
    assert rep.violations == 0
    assert rep.deltas == {"f": 1}


def test_no_retrace_report_mode_fills_expected_late():
    """The benchmark idiom: audit with raise_on_violation=False, assign
    rep.expected once the sweep knows its bucket count."""
    f = EntryPoint(lambda x: x / 2)
    f(torch.ones(4))
    with no_retrace({"f": f}, raise_on_violation=False) as rep:
        f(torch.ones(16))
        rep.expected = {"f": 1}
    assert rep.violations == 0
    with no_retrace({"f": f}, raise_on_violation=False) as rep:
        f(torch.ones(32))
    assert rep.violations == 1
    assert rep.detail() == "f=1/0"


def test_signature_keys_like_a_jit_cache():
    """A tensor by shape, dtype and device; a host array by shape and dtype
    (not its values); anything else by value, as a static argument."""
    f = EntryPoint(lambda *a, **k: None)
    f(torch.ones(3), np.zeros(2, np.float32), steps=4)
    f(torch.zeros(3), np.ones(2, np.float32), steps=4)      # a hit
    assert f._cache_size() == 1
    f(torch.ones(3, dtype=torch.float64), np.zeros(2, np.float32), steps=4)
    f(torch.ones(3), np.zeros(2, np.int32), steps=4)
    f(torch.ones(3), np.zeros(2, np.float32), steps=5)
    assert f._cache_size() == 4


def test_a_build_inside_the_block_counts_as_a_compile(monkeypatch, tmp_path):
    """A kernel suite built or loaded in an audited block is a miss of
    ``build.load``, audited as ``build:<suite>`` with a budget of 0."""
    monkeypatch.delitem(build._LOADED, "gp_acquisition", raising=False)
    monkeypatch.setattr(build, "library_path",
                        lambda name, sources: tmp_path / f"{name}.so")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    with no_retrace(raise_on_violation=False) as rep:
        with pytest.raises(RuntimeError, match="nvcc"):
            gp_ops.library()
    assert rep.deltas["build:gp_acquisition"] == 1
    assert "build:gp_acquisition=1/0" in rep.detail()
    assert set(sanitizers.build_entries()) == {
        f"build:{s}" for s in ("flash_attention", "gp_acquisition",
                               "mlstm_chunk", "ssm_scan", "tpe_kde")}


# --------------------------------------------------------------------------- #
# no_transfer, to_host, to_device
# --------------------------------------------------------------------------- #
def test_no_transfer_leaves_torch_cuda_alone_on_the_cpu(monkeypatch):
    """On ``device="cpu"`` there is no CUDA sync to guard: the block never
    touches ``torch.cuda``, and the sanctioned crossings work inside it."""
    def boom(*a, **k):
        raise AssertionError("torch.cuda touched on the CPU")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", boom)
    with no_transfer(device="cpu"):
        t = to_device(np.arange(3, dtype=np.float32), "cpu")
        out = to_host(t + 1)
        a, b = to_host(t, np.zeros(2))
    np.testing.assert_array_equal(out, [1.0, 2.0, 3.0])
    assert isinstance(a, np.ndarray) and b.shape == (2,)


def test_to_device_casts_and_keeps_scalars_zero_dimensional():
    t = to_device(np.float64(2.5), "cpu", np.float32)
    assert t.shape == () and t.dtype == torch.float32
    t = to_device(np.arange(12, dtype=np.float64).reshape(3, 4)[:, ::2],
                  "cpu", np.float32)
    assert t.is_contiguous() and t.shape == (3, 2)


def test_no_transfer_without_a_card_raises():
    """``device=None`` means the card; without one the guard raises rather
    than guarding nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with no_transfer():
            pass


def test_no_transfer_rejects_an_unknown_level():
    with pytest.raises(ValueError, match="unknown transfer-guard level"):
        with no_transfer("forbid", device="cpu"):
            pass


@pytest.mark.cuda
def test_cuda_injected_item_raises_under_no_transfer():
    _needs_card()
    x = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError, match="synchroniz"):
        with no_transfer():
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0   # restored on the raise


@pytest.mark.cuda
def test_cuda_to_host_and_to_device_pass_under_no_transfer():
    _needs_card()
    with no_transfer():
        t = to_device(np.arange(4, dtype=np.float32), "cuda")
        out = to_host(t * 2)
    np.testing.assert_array_equal(out, [0.0, 2.0, 4.0, 6.0])
    with pytest.raises(RuntimeError, match="synchroniz"):
        with no_transfer("disallow_explicit"):
            to_host(t)     # an explicit crossing is guarded too


# --------------------------------------------------------------------------- #
# assert_holds
# --------------------------------------------------------------------------- #
def test_assert_holds_noop_when_disabled():
    prev = set_debug_locks(False)
    try:
        assert_holds(threading.RLock())  # not held: still no raise
    finally:
        set_debug_locks(prev)


def test_assert_holds_checks_ownership_when_enabled():
    prev = set_debug_locks(True)
    try:
        assert debug_locks_enabled()
        rlock = threading.RLock()
        with pytest.raises(AssertionError, match="not held"):
            assert_holds(rlock)
        with rlock:
            assert_holds(rlock)
        cv = threading.Condition()
        with pytest.raises(AssertionError):
            assert_holds(cv)
        with cv:
            assert_holds(cv)
        plain = threading.Lock()
        with pytest.raises(AssertionError):
            assert_holds(plain)
        with plain:
            assert_holds(plain)
    finally:
        set_debug_locks(prev)


def test_scheduler_drain_contracts_pass_under_debug_locks():
    """The adopted assert_holds sites (shutdown drain predicates) hold
    their declared locks on the real paths."""
    from repro_torch.scheduler import SerialScheduler
    from repro_torch.scheduler.base import BatchToAsyncAdapter
    from repro_torch.scheduler.distributed import TaskQueueScheduler

    prev = set_debug_locks(True)
    try:
        adapter = BatchToAsyncAdapter(SerialScheduler())
        h = adapter.submit(lambda p: p["x"], {"x": 1.5})
        adapter.wait_any([h], timeout=10.0)
        assert adapter.shutdown(timeout=10.0)

        q = TaskQueueScheduler(n_workers=2)
        hs = [q.submit(lambda p: p["x"], {"x": i}) for i in range(3)]
        q.wait_any(hs, timeout=10.0)
        assert q.shutdown(timeout=10.0)
    finally:
        set_debug_locks(prev)


def test_scheduler_reexports_the_sanitizers_assert_holds():
    import repro_torch.scheduler as P
    from repro_torch.scheduler import base
    assert P.assert_holds is base.assert_holds is assert_holds


# --------------------------------------------------------------------------- #
# steady-state serving under both sanitizers
# --------------------------------------------------------------------------- #
def test_steady_state_bank_serving_is_sanitizer_clean():
    """Warm StudyBank ask_all/tell rounds inside one shape bucket: not a
    single new signature of any BANK_ENTRY_POINTS entry or build, with real
    tells (growing n_obs) in the loop."""
    bank = T.StudyBank(SPACE, 4, optimizer="bayesian", seed=0,
                       mc_samples=32, device="cpu")
    _drive(bank, 3)  # warmup: GP pipeline + first hyper fit
    with no_transfer(device="cpu"), no_retrace() as rep:
        _drive(bank, 5)
    assert rep.violations == 0, rep.detail()


def test_smoke_module_passes():
    from repro_torch.analysis import smoke
    assert smoke.run(rounds=4, verbose=False, device="cpu") == 0


class _Fresh:
    """Deliberately broken entry point: every call is a new signature, as
    if each dispatch met a fresh shape bucket."""

    def __init__(self, fn):
        self._fn, self._calls = fn, 0

    def __call__(self, *args, **kwargs):
        self._calls += 1
        return self._fn(*args, **kwargs)

    def _cache_size(self):
        return self._calls


def test_injected_retrace_trips_the_gate(monkeypatch):
    """Negative control: break bank_pick's bucketing in the registry and
    the zero-retrace audit must report violations; the bank calls its
    entry points through the registry, so the broken entry is what runs."""
    bank = T.StudyBank(SPACE, 2, optimizer="bayesian", seed=3,
                       mc_samples=32, device="cpu")
    _drive(bank, 3)  # warm with the intact pipeline
    fresh = _Fresh(t_gp.bank_pick)
    monkeypatch.setitem(t_gp.BANK_ENTRY_POINTS, "bank_pick", fresh)
    with no_retrace(raise_on_violation=False) as rep:
        _drive(bank, 2)
    assert rep.violations >= 2  # one fresh signature per audited ask
    assert "bank_pick" in rep.detail()


# --------------------------------------------------------------------------- #
# held against the JAX package
# --------------------------------------------------------------------------- #
SWEEP_SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2),
               "z": stats.uniform(0, 3)}
# one study of each family; 24 candidates and 3 dims, shapes no other test
# dispatches, so neither side has met them before this test
SWEEP_KW = dict(optimizer=["bayesian", "clustering", "tpe"], seed=13,
                mc_samples=24)


def _observe(bank, rng, k):
    for b in range(bank.n_studies):
        for _ in range(k):
            p = {"x": float(rng.uniform(0, 1)),
                 "y": float(rng.uniform(-1, 1)),
                 "z": float(rng.uniform(0, 3))}
            bank.study(b).observe_params(p, _objective(p))


def _rounds(bank):
    """Two ask_all(1) -> tell rounds, then an ask left in flight and one
    that takes it in (the GP rows' ``bank_absorb``); every trial told."""
    for _ in range(2):
        for b, ts in enumerate(bank.ask_all(1)):
            for t in ts:
                bank.tell(b, t.id, _objective(t.params))
    bank.ask_all(1)
    bank.ask_all(1)
    for b, v in enumerate(bank.studies):
        for t in v.pending_trials():
            bank.tell(b, t.id, _objective(t.params))


def _sweep(bank, audit):
    """Warm at na 16 (from 2 observations a study), audit the steady state
    there (6 to 10 observations: na = 16 while observed + 4 pending slots
    + 1 pick <= 16), then a sweep across the na 32 and 64 buckets; returns
    the two blocks' deltas."""
    rng = np.random.default_rng(5)
    _observe(bank, rng, 2)
    _rounds(bank)
    with audit() as steady:
        _rounds(bank)
    with audit() as sweep:
        for k in (8, 20):            # 18 -> na 32, then 42 -> na 64
            _observe(bank, rng, k)
            _rounds(bank)
    return steady.deltas, sweep.deltas


def test_bank_signature_audit_matches_the_reference_jit_audit():
    """The same drive through ``repro.core.StudyBank`` and the port's bank
    (a GP, a clustering and a TPE study): per shared entry name, the port's
    new signatures equal the reference's new jit-cache entries, 0 in the
    steady state and one per bucket crossed.  The reference's
    ``bank_dist`` / ``bank_exp`` (an XLA:CPU staging) have no counterpart."""
    import repro.core as J
    from repro.analysis.sanitizers import no_retrace as j_no_retrace
    from repro.core import gp as j_gp
    from repro.core import tpe as j_tpe

    j_jits = {**j_gp.BANK_JITS,
              "fused_tpe_propose_bank": j_tpe.fused_tpe_propose_bank}
    shared = sorted(set(j_jits) & set(t_gp.BANK_ENTRY_POINTS))
    assert set(j_jits) - set(shared) == {"bank_dist", "bank_exp"}
    assert set(t_gp.BANK_ENTRY_POINTS) == set(shared)
    want = _sweep(J.StudyBank(SWEEP_SPACE, 3, **SWEEP_KW),
                  lambda: j_no_retrace(j_jits, raise_on_violation=False))
    got = _sweep(T.StudyBank(SWEEP_SPACE, 3, device="cpu", **SWEEP_KW),
                 lambda: no_retrace(t_gp.BANK_ENTRY_POINTS,
                                    raise_on_violation=False))
    for block, g, w in zip(("steady", "sweep"), got, want):
        assert {k: g[k] for k in shared} == {k: w[k] for k in shared}, block
    assert not any(got[0].values())
    assert got[1]["bank_pick"] == 2 and got[1]["fit_hypers_bank"] == 2


def _in_flight_bank(pkg, **kw):
    """Three GP studies, 9 observations each, one batch of 2 in flight."""
    bank = pkg.StudyBank(SPACE, 3, seed=21, mc_samples=64, **kw)
    rng = np.random.default_rng(21)
    for b in range(3):
        for _ in range(9):
            p = {"x": float(rng.uniform(0, 1)),
                 "y": float(rng.uniform(-1, 1))}
            bank.study(b).observe_params(p, _objective(p))
    bank.ask_all(2)
    return bank


def _absorb_device_counts(Xs, y, mask, L, Linv, Ps, n_pending, n_obs, var,
                          noise):
    """The absorb loop as it was before the repair: the counts on the
    device, each slot's rows chosen by ``torch.nonzero`` (a sync each)."""
    n_pending = torch.as_tensor(np.asarray(n_pending), device=Ps.device)
    for j in range(Ps.shape[1]):
        sub = torch.nonzero(n_pending > j)[:, 0]
        if not len(sub):
            break
        x_new = Ps[sub, j]
        k_vec = (t_scoring.matern52(Xs[sub], x_new[:, None, :],
                                    var[sub])[..., 0] * mask[sub])
        mu = (k_vec * t_scoring.kinv_matvec(Linv[sub],
                                            y[sub] * mask[sub])).sum(-1)
        slot = (n_obs[sub] + j).long()
        L_s, Linv_s, _, _ = t_scoring.factor_append(
            L[sub], Linv[sub], slot, k_vec, var[sub], noise[sub])
        L[sub], Linv[sub] = L_s, Linv_s
        Xs[sub, slot] = x_new
        y[sub, slot] = mu
        mask[sub, slot] = 1.0
    return Xs, y, mask, L, Linv


def test_absorb_takes_host_counts_and_keeps_the_picks(monkeypatch,
                                                      tmp_path):
    """A GP ask with trials in flight hands ``absorb_pending`` host counts;
    its picks equal those of the loop with device counts (bitwise, on the
    CPU) and the JAX package's (up to near-ties of the float64 oracle)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import repro.core as J

    bank = _in_flight_bank(T, device="cpu")
    path = tmp_path / "in_flight.npz"
    bank.save(path)
    state = bank._rng.bit_generator.state
    seen = []
    orig = t_scoring.absorb_pending

    def spy(*args):
        seen.append(args[6])
        return orig(*args)

    monkeypatch.setattr(t_scoring, "absorb_pending", spy)
    got = bank.ask_all(2)
    assert seen and all(isinstance(c, np.ndarray) for c in seen)
    np.testing.assert_array_equal(seen[0], [2, 2, 2])

    before = T.StudyBank(SPACE, 3, seed=0, mc_samples=64, device="cpu")
    before.load(path)
    monkeypatch.setattr(t_scoring, "absorb_pending", _absorb_device_counts)
    old = before.ask_all(2)
    params = lambda trials: [[t.params for t in ts] for ts in trials]  # noqa
    assert params(got) == params(old)

    ref = J.StudyBank(SPACE, 3, seed=0, mc_samples=64)
    ref.load(path)
    want = ref.ask_all(2)
    replay = np.random.default_rng(0)
    replay.bit_generator.state = state
    cols = ref.space.sample_columns(3 * 64, replay)
    C = ref.space.encode_columns(cols, 3 * 64).reshape(3, 64, -1)
    led = before.ledger
    in_flight = [led.X[b, led.pending_ids(b)][:2] for b in range(3)]
    for b in range(3):
        ig, iw = ([int(np.flatnonzero((C[b] == r).all(1))[0])
                   for r in ref.space.encode([t.params for t in ts[b]])]
                  for ts in (got, want))
        oracle = chip_smoke.gp_oracle(before, led, C, in_flight, b)
        ok, slot = chip_smoke.picks_agree(ig, iw, oracle)
        assert ok, (b, slot, ig, iw)
