"""PyTorch port, the durable tuning service: WAL framing, journal-then-apply
recovery, exactly-once-effect dedup, degradation, the HTTP layer, the
drivers through ``ServiceScheduler``, and the subprocess chaos kill/restart
harness, all on the CPU (``device="cpu"``); then the same workload through
the JAX package's service and the port's (byte-identical WAL, JSON-equal
ledgers), a data dir written by the JAX package served by the port, and
the signatures.  Copies of the JAX package's ``tests/test_service.py``
cases, on the port.  The JAX package is imported inside the tests that
compare with it, so the card test runs where JAX is absent
(``--noconftest``)."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import inspect
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.service.chaos import run as chaos_run
from repro_torch.service.client import (RemoteOptimizer, ServiceClient,
                                        ServiceError)
from repro_torch.service.recovery import CONFIG, WAL_FILE, wal_suffix
from repro_torch.service.server import CrashPoints, TuningService, serve
from repro_torch.service.wal import (WriteAheadLog, encode_frame,
                                     read_records, truncate_to)

CFG = {"space": {"x": {"uniform": [-1.0, 2.0]},
                 "lr": {"loguniform": [1e-4, 1e-1]}},
       "max_studies": 4, "optimizer": "bayesian", "seed": 0,
       "mc_samples": 32, "fit_steps": 4}


def _svc(tmp_path, name="svc", **over):
    cfg = {**CFG, **over}
    return TuningService(tmp_path / name, config=cfg,
                         crash=CrashPoints(""), device="cpu")


# --------------------------------------------------------------------------- #
# WAL unit suite
# --------------------------------------------------------------------------- #
def test_wal_roundtrip(tmp_path):
    p = tmp_path / "w.log"
    wal = WriteAheadLog(p)
    recs = [{"seq": i, "op": "tell", "study": 0, "trial_id": i,
             "value": 0.1 * i} for i in range(5)]
    for r in recs:
        wal.append(r)
    wal.close()
    out, good, total = read_records(p)
    assert out == recs
    assert good == total == os.path.getsize(p)


def test_wal_crc_corruption_stops_scan(tmp_path):
    p = tmp_path / "w.log"
    wal = WriteAheadLog(p)
    for i in range(4):
        wal.append({"seq": i, "op": "trace", "study": 0})
    wal.close()
    # flip one payload byte inside the THIRD frame: frames 0-1 stay valid,
    # everything from the corrupted frame on is discarded
    frame = len(encode_frame({"seq": 0, "op": "trace", "study": 0}))
    raw = bytearray(p.read_bytes())
    raw[2 * frame + 14] ^= 0xFF
    p.write_bytes(bytes(raw))
    out, good, total = read_records(p)
    assert [r["seq"] for r in out] == [0, 1]
    assert good == 2 * frame and total == 4 * frame


def test_wal_torn_tail_truncated_and_appendable(tmp_path):
    p = tmp_path / "w.log"
    wal = WriteAheadLog(p)
    for i in range(3):
        wal.append({"seq": i, "op": "trace", "study": 0})
    wal.close()
    whole = p.read_bytes()
    p.write_bytes(whole[:-7])    # crash mid-write of the last frame
    out, good, total = read_records(p)
    assert [r["seq"] for r in out] == [0, 1]
    assert good < total
    truncate_to(p, good)
    # the truncated log extends cleanly
    wal2 = WriteAheadLog(p)
    wal2.append({"seq": 2, "op": "trace", "study": 0})
    wal2.close()
    out2, good2, total2 = read_records(p)
    assert [r["seq"] for r in out2] == [0, 1, 2]
    assert good2 == total2


def test_wal_mid_hook_leaves_torn_frame(tmp_path):
    """The chaos harness's mid-write kill point: the hook fires after a
    flushed partial frame, so the on-disk state is a genuine torn tail."""
    p = tmp_path / "w.log"
    wal = WriteAheadLog(p)
    wal.append({"seq": 1, "op": "trace", "study": 0})

    class Die(Exception):
        pass

    def hook():
        raise Die()     # stands in for SIGKILL

    with pytest.raises(Die):
        wal.append({"seq": 2, "op": "trace", "study": 0}, mid_hook=hook)
    wal.close()
    out, good, total = read_records(p)
    assert [r["seq"] for r in out] == [1]
    assert good < total     # the partial frame is on disk, and invalid


# --------------------------------------------------------------------------- #
# service core: dedup, replay, compaction boundary
# --------------------------------------------------------------------------- #
def test_tell_dedup_and_ask_req_id_cache(tmp_path):
    svc = _svc(tmp_path)
    svc.create_study("a")
    r = svc.ask("a", 3, req_id="r1")
    ids = [t["id"] for t in r["trials"]]
    # retried ask: same trials, no new journal record
    n_wal = len(wal_suffix(svc.data_dir))
    r2 = svc.ask("a", 3, req_id="r1")
    assert r2["cached"] and r2["trials"] == r["trials"]
    assert len(wal_suffix(svc.data_dir)) == n_wal
    # duplicate tell: applied exactly once, repeat doesn't journal
    assert svc.tell("a", ids[0], 1.5)["applied"]
    n_wal = len(wal_suffix(svc.data_dir))
    dup = svc.tell("a", ids[0], 99.0)
    assert not dup["applied"] and dup["value"] == 1.5
    assert len(wal_suffix(svc.data_dir)) == n_wal
    assert not svc.tell_failed("a", ids[0])["applied"]
    with pytest.raises(ServiceError) as ei:
        svc.tell("a", 999, 0.0)
    assert ei.value.status == 404
    svc.close()


def test_health_reports_the_last_asks(tmp_path):
    """``health`` serves the recorder's summary of the bank's asks: each
    stage's median and p90 ms and each counter's mean, as JSON."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    rng = np.random.default_rng(0)
    for _ in range(4):
        for t in svc.ask("a", 2)["trials"]:
            svc.tell("a", t["id"], float(rng.normal()))
    h = json.loads(json.dumps(svc.health()))
    asks = h["asks"]
    assert h["status"] == "ok" and asks["asks"] >= 2
    for name in ("ask_view", "ask.obs", "ask.obs.gather", "ask.pick",
                 "ask.register"):
        s = asks["spans"][name]
        assert 0.0 <= s["median_ms"] <= s["p90_ms"] and s["n"] >= 1
    c = asks["counters"]
    assert c["na"] == 16.0 and c["exits"] >= 2.0
    assert c["d2h_bytes"] > 0 and c["new_signatures"] >= 0.0
    assert c["builds"] == 0.0
    svc.close()


def test_health_reports_the_fit_counters(tmp_path):
    """``health`` carries the fit's counters: its Adam steps (every record
    carries both, 0 where the ask fit nothing) and its rows whose
    hyperparameters came back not finite."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    rng = np.random.default_rng(1)
    for _ in range(4):
        for t in svc.ask("a", 2)["trials"]:
            svc.tell("a", t["id"], float(rng.normal()))
    c = json.loads(json.dumps(svc.health()))["asks"]["counters"]
    steps = svc.bank.fit_steps
    assert 0.0 < c["fit_steps"] <= steps and c["fit_nonfinite"] == 0.0
    svc.close()


def test_recovery_replays_interrupted_ask_bitwise(tmp_path):
    """Kill after the ask was journaled but before the reply: restart must
    re-serve the SAME trial ids and configurations (the WAL replay re-runs
    view.ask against bit-identical RNG/GP state)."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    r1 = svc.ask("a", 2, req_id="q1")
    svc.tell("a", 0, 0.7)
    svc.tell("a", 1, -0.2)
    r2 = svc.ask("a", 2, req_id="q2")   # response "lost" to the crash
    svc.close()                          # no compaction: pure WAL replay
    svc2 = _svc(tmp_path)                # same dir, config already on disk
    assert svc2.recovery.replayed > 0 and not svc2.recovery.snapshot_loaded
    again = svc2.ask("a", 2, req_id="q2")
    assert again["cached"] and again["trials"] == r2["trials"]
    # q1's trials were told since; the re-served reply carries the same
    # ids/params with their *current* status
    q1 = svc2.ask("a", 2, req_id="q1")["trials"]
    assert [(t["id"], t["params"]) for t in q1] \
        == [(t["id"], t["params"]) for t in r1["trials"]]
    assert [t["status"] for t in q1] == ["observed", "observed"]
    svc2.close()


def test_compaction_boundary_replay(tmp_path):
    """A WAL overlapping the snapshot (crash between snapshot replace and
    log truncate) replays without double-applying anything: records with
    seq <= snapshot op_seq are skipped."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    svc.ask("a", 2, req_id="r")
    svc.tell("a", 0, 1.0)
    wal_path = os.path.join(svc.data_dir, WAL_FILE)
    pre_compact_wal = open(wal_path, "rb").read()
    svc.compact()
    svc.tell("a", 1, 2.0)
    post = svc.ask("a", 1, req_id="r2")
    suffix_wal = open(wal_path, "rb").read()
    svc.close()
    # reconstruct the crash: snapshot written, but the old WAL was never
    # truncated — full history + suffix both on disk
    with open(wal_path, "wb") as fh:
        fh.write(pre_compact_wal + suffix_wal)
    svc2 = _svc(tmp_path)
    assert svc2.recovery.snapshot_loaded
    assert svc2.recovery.skipped > 0          # the overlapped prefix
    view = svc2.bank.studies[0]
    obs = [(t.id, t.value) for t in view.observed_trials()]
    assert obs == [(0, 1.0), (1, 2.0)]        # told once each
    assert svc2.ask("a", 1, req_id="r2")["trials"] == post["trials"]
    svc2.close()


def test_recovery_matches_uninterrupted_oracle(tmp_path):
    """Snapshot + WAL-suffix recovery reproduces the exact optimizer
    state: the next proposals equal an uninterrupted run's, bitwise."""
    def drive(svc):
        svc.create_study("a", sign=-1.0)
        for rnd in range(4):
            ids = [t["id"] for t in
                   svc.ask("a", 2, req_id=f"r{rnd}")["trials"]]
            svc.tell("a", ids[0], float(np.sin(rnd)))
            svc.tell_failed("a", ids[1])
            if rnd == 1:
                svc.compact()

    svc = _svc(tmp_path, name="crashy")
    drive(svc)
    svc.close()
    svc2 = TuningService(tmp_path / "crashy", crash=CrashPoints(""),
                         device="cpu")
    oracle = _svc(tmp_path, name="oracle")
    drive(oracle)
    a = svc2.ask("a", 4, req_id="final")
    b = oracle.ask("a", 4, req_id="final")
    assert a["trials"] == b["trials"]
    assert svc2.bank.op_seq == oracle.bank.op_seq
    svc2.close()
    oracle.close()


def test_invalid_ops_rejected_before_journal(tmp_path):
    """Journal-then-apply requires apply to be infallible once journaled:
    a malformed op (ask n<1, observe params that don't encode) must be
    rejected BEFORE the WAL append, or the fsync'd poison frame would
    re-raise on every restart and wedge the service."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    svc.ask("a", 1, req_id="r")
    n_wal = len(wal_suffix(svc.data_dir))
    seq = svc.bank.op_seq
    with pytest.raises(ValueError, match="n >= 1"):
        svc.ask("a", 0, req_id="bad")
    with pytest.raises(KeyError):
        svc.observe("a", {"bogus": 1.0}, 0.5)
    # nothing journaled, no seq burned: the next valid op extends cleanly
    assert len(wal_suffix(svc.data_dir)) == n_wal
    assert svc.bank.op_seq == seq
    svc.tell("a", 0, 1.0)
    svc.close()
    svc2 = _svc(tmp_path)            # restart replays without error
    assert svc2.recovery.poisoned == 0
    assert svc2.bank.op_seq == seq + 1
    svc2.close()


def test_poison_wal_record_skipped_on_recovery(tmp_path):
    """Defense in depth: should a journaled record still fail to apply
    (version skew, hand-edited log), its seq is consumed, recovery skips
    the poison frame, and the service starts with no seq collision."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    svc.ask("a", 1, req_id="r")
    seq = svc.bank.op_seq
    data_dir = svc.data_dir
    svc.close()
    wal = WriteAheadLog(os.path.join(data_dir, WAL_FILE))
    wal.append({"seq": seq + 1, "op": "frobnicate", "study": 0})
    wal.close()
    svc2 = _svc(tmp_path)
    assert svc2.recovery.poisoned == 1
    assert svc2.bank.op_seq == seq + 1       # the poison seq is consumed
    svc2.tell("a", 0, 1.0)                   # fresh ops get fresh seqs
    assert wal_suffix(data_dir)[-1]["seq"] == seq + 2
    svc2.close()
    # a seq GAP is a structural journal error, not a poison record:
    # recovery must refuse rather than silently drop the suffix
    wal = WriteAheadLog(os.path.join(data_dir, WAL_FILE))
    wal.append({"seq": seq + 10, "op": "trace", "study": 0})
    wal.close()
    with pytest.raises(ValueError, match="does not extend"):
        _svc(tmp_path)


def test_observe_trace_req_id_dedup(tmp_path):
    """observe/trace retries land exactly once: same req_id replies from
    the cache without journaling, and the cache is rebuilt by WAL replay
    so a retry crossing a crash still dedups."""
    svc = _svc(tmp_path)
    svc.create_study("a")
    r1 = svc.observe("a", {"x": 0.5, "lr": 1e-2}, 1.0, req_id="o1")
    n_wal = len(wal_suffix(svc.data_dir))
    r2 = svc.observe("a", {"x": 0.5, "lr": 1e-2}, 1.0, req_id="o1")
    assert r2["cached"] and r2["id"] == r1["id"]
    assert len(wal_suffix(svc.data_dir)) == n_wal
    assert svc.best("a")["n_observed"] == 1
    assert svc.trace("a", req_id="t1") == {"ok": True, "cached": False}
    n_wal = len(wal_suffix(svc.data_dir))
    assert svc.trace("a", req_id="t1")["cached"]
    assert len(wal_suffix(svc.data_dir)) == n_wal
    assert svc.bank.studies[0]._best_trace == [1.0]
    svc.close()
    svc2 = _svc(tmp_path)
    assert svc2.observe("a", {"x": 0.5, "lr": 1e-2}, 1.0,
                        req_id="o1")["cached"]
    assert svc2.trace("a", req_id="t1")["cached"]
    assert svc2.best("a")["n_observed"] == 1
    assert svc2.bank.studies[0]._best_trace == [1.0]
    svc2.close()


def test_wal_failure_degrades_to_read_only(tmp_path):
    svc = _svc(tmp_path)
    svc.create_study("a")
    ids = [t["id"] for t in svc.ask("a", 2, req_id="r")["trials"]]
    svc.tell("a", ids[0], 1.0)

    def broken_append(record, mid_hook=None):
        raise OSError(28, "No space left on device")

    svc.wal.append = broken_append
    with pytest.raises(ServiceError) as ei:
        svc.tell("a", ids[1], 2.0)
    assert ei.value.status == 503
    assert svc.health()["status"] == "degraded"
    # reads keep serving
    assert svc.best("a")["best_objective"] == 1.0
    assert svc.studies()["studies"][0]["name"] == "a"
    # every mutation path refuses
    for call in (lambda: svc.ask("a", 1, req_id="x"),
                 lambda: svc.create_study("b"),
                 lambda: svc.compact()):
        with pytest.raises(ServiceError) as ei:
            call()
        assert ei.value.status == 503
    svc.close()


def test_create_study_idempotent_and_capacity(tmp_path):
    svc = _svc(tmp_path, max_studies=2)
    assert svc.create_study("a", sign=1.0)["created"]
    assert not svc.create_study("a", sign=1.0)["created"]
    svc.ask("a", 1, req_id="r")
    with pytest.raises(ServiceError) as ei:
        svc.create_study("a", sign=-1.0)   # direction flip with trials
    assert ei.value.status == 409
    svc.create_study("b")
    with pytest.raises(ServiceError) as ei:
        svc.create_study("c")
    assert ei.value.status == 507
    svc.close()


def test_create_study_optimizer_idempotent_and_conflict(tmp_path):
    svc = _svc(tmp_path)
    r = svc.create_study("a", optimizer="tpe")
    assert r["created"] and r["optimizer"] == "tpe"
    r = svc.create_study("a", optimizer="tpe")     # exact re-create
    assert not r["created"] and r["optimizer"] == "tpe"
    # optimizer omitted matches whatever the study already runs
    assert not svc.create_study("a")["created"]
    # trial-free strategy switch re-journals the create
    r = svc.create_study("a", optimizer="clustering")
    assert r["created"] and r["optimizer"] == "clustering"
    assert svc.bank.strategy_names[0] == "clustering"
    svc.ask("a", 1, req_id="r")
    with pytest.raises(ServiceError) as ei:
        svc.create_study("a", optimizer="bayesian")   # flip with trials
    assert ei.value.status == 409 and "clustering" in str(ei.value)
    svc.close()


@pytest.mark.parametrize("compact_mid", [False, True])
def test_mixed_strategy_recovery_matches_oracle(tmp_path, compact_mid):
    """Kill->resume with a heterogeneous fleet: per-study strategies are
    journaled on the create ops (and carried by the snapshot's strategy
    column), so recovery rebuilds the family routing and every family's
    next proposals are bit-equal to an uninterrupted oracle — via pure
    WAL replay and via snapshot + WAL suffix."""
    studies = [("g", "bayesian"), ("t", "tpe"), ("c", "clustering")]

    def drive(svc):
        for name, strat in studies:
            assert svc.create_study(name, optimizer=strat)["optimizer"] \
                == strat
        for rnd in range(3):
            for name, _ in studies:
                ids = [t["id"] for t in
                       svc.ask(name, 2, req_id=f"{name}{rnd}")["trials"]]
                svc.tell(name, ids[0], float(np.cos(rnd)))
                svc.tell_failed(name, ids[1])
            if compact_mid and rnd == 1:
                svc.compact()

    svc = _svc(tmp_path, name="crashy")
    drive(svc)
    svc.close()
    svc2 = TuningService(tmp_path / "crashy", crash=CrashPoints(""),
                         device="cpu")
    assert svc2.recovery.snapshot_loaded == compact_mid
    assert [svc2.bank.strategy_names[svc2._names[n]]
            for n, _ in studies] == [s for _, s in studies]
    oracle = _svc(tmp_path, name="oracle")
    drive(oracle)
    for name, _ in studies:
        a = svc2.ask(name, 2, req_id=f"fin{name}")
        b = oracle.ask(name, 2, req_id=f"fin{name}")
        assert a["trials"] == b["trials"], name
    assert svc2.bank.op_seq == oracle.bank.op_seq
    svc2.close()
    oracle.close()


def test_background_compaction_drains_and_shutdown_joins(tmp_path):
    """Past the op threshold the request only wakes the compactor; the
    daemon thread takes the snapshot shortly after, off the request path.
    ``shutdown(timeout=)`` stops and joins it, and a restart recovers
    from the background-written snapshot."""
    # the op threshold wakes the daemon mid-burst; the interval timer
    # drains whatever tail stays below the threshold afterwards
    svc = _svc(tmp_path, compact_every_ops=4, compact_interval_s=0.05)
    assert svc._compact_thread is not None and svc._compact_thread.is_alive()
    svc.create_study("a")
    for i in range(8):
        tid = svc.ask("a", 1, req_id=f"r{i}")["trials"][0]["id"]
        svc.tell("a", tid, float(i))
    deadline = time.time() + 10.0
    while time.time() < deadline and svc._ops_since_snapshot:
        time.sleep(0.01)
    assert svc._ops_since_snapshot == 0      # the daemon drained the WAL
    op_seq = svc.bank.op_seq
    svc.shutdown(timeout=5.0)
    assert svc._compact_thread is None
    svc2 = _svc(tmp_path)
    assert svc2.recovery.snapshot_loaded
    assert svc2.bank.op_seq == op_seq
    svc2.close()


# --------------------------------------------------------------------------- #
# HTTP layer + drivers
# --------------------------------------------------------------------------- #
@pytest.fixture()
def http_service(tmp_path):
    httpd, svc = serve(tmp_path / "http", port=0, config=CFG, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, svc
    httpd.shutdown()
    svc.close()


def test_http_end_to_end(http_service):
    base, _ = http_service
    cl = ServiceClient(base)
    assert cl.health()["status"] == "ok"
    cl.create_study("web", sign=1.0)
    r = cl.ask("web", n=2, req_id="h1")
    ids = [t["id"] for t in r["trials"]]
    assert cl.ask("web", n=2, req_id="h1")["trials"] == r["trials"]
    assert cl.tell("web", ids[0], 0.5)["applied"]
    assert not cl.tell("web", ids[0], 0.5)["applied"]
    cl.tell_failed("web", ids[1])
    cl.trace("web")
    best = cl.best("web")
    assert best["best_objective"] == 0.5 and best["n_failed"] == 1
    res = cl.results("web")
    assert res["objective_values"] == [0.5]
    assert cl.compact()["op_seq"] == cl.health()["op_seq"]
    with pytest.raises(ServiceError) as ei:
        cl.tell("nope", 0, 1.0)
    assert ei.value.status == 404
    with pytest.raises(ServiceError) as ei:
        cl._request("POST", "/no/such/route", {})
    assert ei.value.status == 404


def test_remote_optimizer_matches_local_bank(http_service):
    """Proposals served over HTTP are bit-equal to the same bank row
    driven in-process: JSON floats round-trip exactly."""
    from repro_torch.core.studybank import StudyBank
    from repro_torch.service.server import space_from_spec
    base, svc = http_service
    ro = RemoteOptimizer(ServiceClient(base), "par")
    ro.sign = 1.0
    local = StudyBank(space_from_spec(CFG["space"]),
                      n_studies=CFG["max_studies"],
                      optimizer=CFG["optimizer"], seed=CFG["seed"],
                      mc_samples=CFG["mc_samples"],
                      fit_steps=CFG["fit_steps"], device="cpu")
    lview = local.studies[svc._names["par"]]
    for rnd in range(3):
        remote = ro.ask(2)
        mine = lview.ask(2)
        assert [t.id for t in remote] == [t.id for t in mine]
        assert [t.params for t in remote] == [t.params for t in mine]
        ro.tell(remote[0].id, float(rnd))
        lview.tell(mine[0].id, float(rnd))
        ro.tell_failed(remote[1].id)
        lview.tell_failed(mine[1].id)
    assert ro.n_observed == lview.n_observed == 3
    assert ro.n_failed == lview.n_failed == 3


def test_tuner_against_service(http_service):
    from repro_torch.core import Tuner
    from repro_torch.scheduler import ServiceScheduler

    base, svc = http_service
    sched = ServiceScheduler(base, study="tuned")
    t = Tuner({"x": stats.uniform(-1, 2), "lr": stats.loguniform(1e-4, 1e-1)},
              lambda p: -(p["x"] - 0.5) ** 2,
              {"num_iteration": 4, "batch_size": 2, "scheduler": sched})
    res = t.maximize()
    assert res.best_objective <= 0.0
    # initial random batch + num_iteration batches, all told remotely
    assert len(res.objective_values) == 10
    # state lives server-side
    assert svc.best("tuned")["n_observed"] == 10


def test_async_tuner_against_service(http_service):
    from repro_torch.core.async_tuner import AsyncTuner
    from repro_torch.scheduler import ServiceScheduler, TaskQueueScheduler

    base, svc = http_service
    inner = TaskQueueScheduler(n_workers=2)
    sched = ServiceScheduler(base, study="atuned", inner=inner)
    at = AsyncTuner({"x": stats.uniform(-1, 2),
                     "lr": stats.loguniform(1e-4, 1e-1)},
                    lambda p: -(p["x"] - 0.5) ** 2, sched,
                    num_evals=6, batch_size=2)
    res = at.maximize()
    assert len(res.objective_values) == 6
    assert svc.best("atuned")["n_observed"] == 6
    assert inner.shutdown(timeout=5.0)


# --------------------------------------------------------------------------- #
# chaos: subprocess SIGKILL/restart, deterministic kill points
# --------------------------------------------------------------------------- #
def test_chaos_kill_restart_quick(tmp_path):
    """Five seeded SIGKILLs mid-workload (compaction, after-apply and
    after-journal points) at the JAX package's quick size, each server a
    subprocess on the CPU; the recovered service's ledger, op_seq and next
    proposals must be bit-equal to the uninterrupted oracle."""
    report = chaos_run(str(tmp_path / "chaos"), kills=5, seed=1,
                       studies=2, rounds=3, verbose=False, device="cpu")
    assert report["failures"] == []
    assert report["kills_fired"] == 5


# --------------------------------------------------------------------------- #
# against the JAX package's service
# --------------------------------------------------------------------------- #
MIXED = [("g", "bayesian"), ("t", "tpe"), ("c", "clustering")]


def _drive_mixed(svc, rounds=range(4), compact_at=1):
    """Every journal op kind over a three-family fleet: creates, asks,
    tells, failures, an observe, traces and a compaction."""
    for name, strat in MIXED:
        svc.create_study(name, optimizer=strat, sign=-1.0 if name == "t"
                         else 1.0)
    svc.observe("g", {"x": 0.25, "lr": 1e-3}, 0.5, req_id="o0")
    for rnd in rounds:
        for name, _ in MIXED:
            ids = [t["id"] for t in
                   svc.ask(name, 2, req_id=f"{name}{rnd}")["trials"]]
            svc.tell(name, ids[0], float(np.cos(rnd)))
            svc.tell_failed(name, ids[1])
            svc.trace(name, req_id=f"tr{name}{rnd}")
        if rnd == compact_at:
            svc.compact()


def _ledgers(svc):
    return {name: svc.trials(name) for name, _ in MIXED}


def test_wal_and_ledgers_match_repro(tmp_path):
    """The same workload through the JAX package's service and the port's
    on the CPU: byte-identical WAL files (before and after a compaction),
    JSON-equal trial ledgers, equal op_seq and equal next proposals."""
    from repro.service.server import CrashPoints as JCrash
    from repro.service.server import TuningService as JService
    mine = _svc(tmp_path, name="port")
    ref = JService(tmp_path / "ref", config=CFG, crash=JCrash(""))
    _drive_mixed(mine, rounds=range(1), compact_at=None)
    _drive_mixed(ref, rounds=range(1), compact_at=None)
    wal = [os.path.join(s.data_dir, WAL_FILE) for s in (mine, ref)]
    raw = [open(p, "rb").read() for p in wal]
    assert raw[0] == raw[1] and len(raw[0]) > 0
    for svc in (mine, ref):
        svc.compact()
        for rnd in range(1, 4):
            for name, _ in MIXED:
                ids = [t["id"] for t in
                       svc.ask(name, 2, req_id=f"{name}{rnd}")["trials"]]
                svc.tell(name, ids[0], float(np.sin(rnd)))
                svc.tell_failed(name, ids[1])
    raw = [open(p, "rb").read() for p in wal]
    assert raw[0] == raw[1] and len(raw[0]) > 0
    assert _ledgers(mine) == _ledgers(ref)
    assert mine.health()["op_seq"] == ref.health()["op_seq"]
    for name, _ in MIXED:
        assert mine.ask(name, 3, req_id="fin")["trials"] == \
            ref.ask(name, 3, req_id="fin")["trials"], name
        assert mine.results(name) == ref.results(name)
    mine.close()
    ref.close()


def test_hallucination_ref_study_matches_repro_and_recovers(tmp_path):
    """A ``hallucination_ref`` study asks through its strategy's own loop
    in the service: the same trials as the JAX package's service, and a
    restart from snapshot + WAL suffix (the snapshot's ``"gp"`` entry
    carrying the strategy GP's fit schedule) asks what the uninterrupted
    service asks."""
    from repro.service.server import CrashPoints as JCrash
    from repro.service.server import TuningService as JService

    def drive(svc):
        svc.create_study("h", optimizer="hallucination_ref")
        for rnd in range(4):
            ids = [t["id"] for t in
                   svc.ask("h", 2, req_id=f"h{rnd}")["trials"]]
            svc.tell("h", ids[0], float(np.cos(rnd)))
            svc.tell("h", ids[1], float(np.sin(rnd)))
            if rnd == 2:
                svc.compact()

    mine = _svc(tmp_path, name="port")
    ref = JService(tmp_path / "ref", config=CFG, crash=JCrash(""))
    drive(mine)
    drive(ref)
    assert mine.trials("h") == ref.trials("h")
    mine.close()
    back = TuningService(tmp_path / "port", crash=CrashPoints(""),
                         device="cpu")
    assert back.recovery.snapshot_loaded
    assert back.ask("h", 2, req_id="fin")["trials"] == \
        ref.ask("h", 2, req_id="fin")["trials"]
    back.close()
    ref.close()


def test_port_serves_a_data_dir_written_by_repro(tmp_path):
    """A JAX-package data dir (its ``service.json`` carrying
    ``use_pallas: true``, a snapshot and a WAL suffix) recovers in the port
    with the same op_seq and ledgers, and asks on as the JAX package's own
    uninterrupted service does."""
    from repro.service.server import CrashPoints as JCrash
    from repro.service.server import TuningService as JService
    cfg = {**CFG, "use_pallas": True}
    ref = JService(tmp_path / "ref", config=cfg, crash=JCrash(""))
    _drive_mixed(ref)
    seq, led = ref.bank.op_seq, _ledgers(ref)
    ref.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "copy")
    mine = TuningService(tmp_path / "copy", crash=CrashPoints(""),
                         device="cpu")
    assert mine.recovery.snapshot_loaded and mine.recovery.replayed > 0
    assert mine.bank.op_seq == seq
    assert _ledgers(mine) == led
    twin = JService(tmp_path / "ref", crash=JCrash(""))
    for name, _ in MIXED:
        assert mine.ask(name, 2, req_id="next")["trials"] == \
            twin.ask(name, 2, req_id="next")["trials"], name
    mine.close()
    twin.close()


def test_use_pallas_key_is_accepted_and_ignored(tmp_path):
    """A persisted ``use_pallas`` (either value) neither fails the start
    nor changes a proposal: the bank runs its kernels on the card and
    their plain versions on the CPU.  The key stays in ``service.json``
    as written; the run-time device is never written there.  ``Tuner``,
    whose config is not durable state, still rejects the key."""
    from repro_torch.core import Tuner
    plain = _svc(tmp_path, name="plain")
    _drive_mixed(plain)
    for flag in (True, False):
        svc = _svc(tmp_path, name=f"pallas{flag}", use_pallas=flag)
        with open(os.path.join(svc.data_dir, CONFIG)) as fh:
            on_disk = json.load(fh)
        assert on_disk["use_pallas"] is flag and "device" not in on_disk
        _drive_mixed(svc)
        assert _ledgers(svc) == _ledgers(plain)
        svc.close()
    plain.close()
    with pytest.raises(ValueError, match="use_pallas"):
        Tuner({"x": stats.uniform(0, 1)}, lambda ps: [0.0] * len(ps),
              {"use_pallas": True, "device": "cpu"})


def test_service_defaults_to_cuda_and_never_falls_back(tmp_path):
    """With no ``device`` the service's bank is on the card; without a
    card the start raises (before any journal exists)."""
    if torch.cuda.is_available():
        svc = TuningService(tmp_path / "d", config=CFG)
        assert svc.bank.device.type == "cuda"
        svc.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TuningService(tmp_path / "d", config=CFG)


# --------------------------------------------------------------------------- #
# signatures and exports against the JAX package
# --------------------------------------------------------------------------- #
def _params(fn):
    return [(p.name, p.default, p.kind)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["TuningService.__init__", "serve",
                                  "run", "OracleExec.__init__",
                                  "ServiceScheduler.__init__",
                                  "RemoteOptimizer.__init__",
                                  "ServiceClient.__init__"])
def test_signatures_match_repro(name):
    """The reference's parameters in its order; the port adds ``device``
    last (where a bank is built: the service, ``serve``, ``chaos.run`` and
    its oracle) and nothing else."""
    import repro.scheduler.service as jsched
    import repro.service.chaos as jchaos
    import repro.service.client as jclient
    import repro.service.server as jserver
    import repro_torch.scheduler.service as psched
    import repro_torch.service.chaos as pchaos
    import repro_torch.service.client as pclient
    import repro_torch.service.server as pserver
    mods = {"TuningService": (jserver, pserver), "serve": (jserver, pserver),
            "run": (jchaos, pchaos), "OracleExec": (jchaos, pchaos),
            "ServiceScheduler": (jsched, psched),
            "RemoteOptimizer": (jclient, pclient),
            "ServiceClient": (jclient, pclient)}
    head, *rest = name.split(".")
    j, p = mods[head]
    j, p = getattr(j, head), getattr(p, head)
    for attr in rest:
        j, p = getattr(j, attr), getattr(p, attr)
    got, want = _params(p), _params(j)
    if name in ("ServiceScheduler.__init__", "RemoteOptimizer.__init__",
                "ServiceClient.__init__"):
        assert got == want
    else:
        assert got[-1][:2] == ("device", None)
        assert got[:-1] == want


def test_service_exports_match_repro():
    import repro.service as J
    import repro_torch.service as P
    assert P.__all__ == J.__all__
    from repro.service import chaos as jchaos
    from repro_torch.service import chaos as pchaos
    assert pchaos.KILL_TAGS == jchaos.KILL_TAGS
    assert pchaos.DEFAULT_CONFIG == jchaos.DEFAULT_CONFIG
    assert [pchaos.kill_specs(s, 5) for s in range(4)] == \
        [jchaos.kill_specs(s, 5) for s in range(4)]
    assert list(pchaos.Workload(0, 3, 6, 2).steps()) == \
        list(jchaos.Workload(0, 3, 6, 2).steps())
    for rec in ({"seq": 1, "op": "trace", "study": 0},
                {"seq": 7, "op": "observe", "study": 2, "value": -0.125,
                 "params": {"x": 0.1, "lr": 3e-4}, "req_id": "é"}):
        from repro.service.wal import encode_frame as jencode
        assert encode_frame(rec) == jencode(rec)


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_service_recovers_a_cpu_data_dir(tmp_path):
    """A data dir written on the CPU recovers on the card (the device is
    not part of the durable state); its ledgers and op_seq are equal, and
    asks on the card return valid proposals through HTTP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = _svc(tmp_path, name="d")
    _drive_mixed(cpu)
    seq, led = cpu.bank.op_seq, _ledgers(cpu)
    cpu.close()
    httpd, svc = serve(tmp_path / "d", port=0, device="cuda")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert svc.bank.device.type == "cuda"
        assert svc.bank.op_seq == seq and _ledgers(svc) == led
        cl = ServiceClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        for name, _ in MIXED:
            trials = cl.ask(name, n=2)["trials"]
            assert len(trials) == 2
            for tr in trials:
                assert -1.0 <= tr["params"]["x"] <= 1.0
                cl.tell(name, tr["id"], float(tr["params"]["x"]))
    finally:
        httpd.shutdown()
        svc.close()
