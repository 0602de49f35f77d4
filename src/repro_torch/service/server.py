"""Durable ask/tell tuning service over HTTP (stdlib only).

One process hosts many named studies backed by a single ``StudyBank``.
Every state-mutating request — create / ask / tell / tell_failed /
observe / trace — is assigned a monotonic ``seq``, journaled to the
CRC-framed WAL (``repro_torch.service.wal``) with an fsync, and only *then*
applied to the bank, all under one lock so journal order equals apply
order.  Crash recovery (``repro_torch.service.recovery``) loads the latest
fleet snapshot and replays the WAL suffix; because every proposal is a
pure function of bank state and the per-study RNG streams, a replayed
``ask`` mints bit-identical trial ids and configurations, which is what
lets an interrupted ask be *re-served* rather than re-drawn.

Exactly-once effect on at-least-once delivery:

  * tells are deduped by trial id — a pending trial is resolved once,
    a repeat (client retry, or a WAL suffix overlapping the snapshot)
    is a no-op reply with ``applied: false``;
  * asks, observes and traces are deduped by client ``req_id`` — a
    retried request returns the cached reply instead of journaling a
    second op; the reply cache rides in the snapshot's ``extra`` block
    so it survives compaction;
  * creates are idempotent by study name.

Journal-then-apply requires apply to be infallible once journaled, so
every op is validated against the bank (``StudyBank.validate_op``)
*before* the WAL append — a malformed request (``ask`` with ``n<1``, an
``observe`` whose params don't encode) is rejected with 4xx and never
reaches the log, where it would poison every future replay.

Degradation: if the WAL volume errors, the service stays up read-only —
``best``/``results``/``studies`` keep serving, mutations get 503.

``GET /health`` (``TuningService.health``) also reports ``asks``, the
bank's last 64 asks as ``repro_torch.core.telemetry`` records them: each
stage span's median and p90 ms (``ask_view``, the root of a study's ask,
and its stages ``ask.draw``, ``ask.obs`` with ``ask.obs.gather`` /
``.fit`` / ``.factors`` / ``.copy``, ``ask.pick``, ``ask.register``) and
each counter's mean (``na``, the bucket; ``fit_rows`` / ``due_rows``;
``fit_steps`` / ``fit_nonfinite``, the fit's Adam steps and its rows
whose hyperparameters came back not finite; ``obs_cache_hits``; ``exits`` / ``d2h_bytes``, ``uploads`` /
``h2d_bytes``; ``entry_calls`` / ``new_signatures``; ``builds``).

``REPRO_SERVICE_CRASH`` (``tag:index`` specs, comma-separated — e.g.
``tell.after_journal:3``) arms deterministic SIGKILL points for the
chaos harness; unset in production.

The port's copy of ``repro.service.server`` over the port's ``StudyBank``:
its asks run the bank's device pipeline on ``device`` (``cuda`` unless
``"cpu"`` is asked for).  The device is chosen at each start and is not
written into ``service.json``, so a data dir moves between the CPU and the
card.  A ``use_pallas`` key in ``service.json`` (data dirs written by the
JAX package may carry one) is accepted and ignored: the bank runs its
kernels on the card and their plain versions on the CPU.

    PYTHONPATH=src python -m repro_torch.service.server --data-dir DIR \
        --config cfg.json --device cpu      # or --device cuda (default)
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import unquote, urlparse

from repro_torch.analysis.sanitizers import assert_holds
from repro_torch.device import DeviceLike
from repro_torch.service.client import ServiceError
from repro_torch.service.recovery import CONFIG, SNAPSHOT, WAL_FILE, recover
from repro_torch.service.wal import WriteAheadLog, atomic_write_text

REPLY_CACHE_CAP = 128   # retained req_id replies per study


def space_from_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Build a ``ParamSpace``-ready dict from a JSON space spec.

    Each entry is a one-key tagged dict::

        {"lr": {"loguniform": [1e-4, 1e-1]},
         "x":  {"uniform": [-1.0, 2.0]},        # [loc, scale]
         "n":  {"range": [16, 256, 16]},        # start, stop, step
         "act": {"choice": ["relu", "gelu"]},
         "tile": {"int": [1, 16]},              # inclusive bounds
         "bq":  {"logint": [32, 512]},
         "tag": {"const": "v1"}}

    Conditional subspaces nest one level of the same grammar under
    ``cond`` (core.spaces.Choice)::

        {"plan": {"cond": {"dp":  {"zero": {"choice": ["z1", "z3"]}},
                           "tp8": {"sp": {"choice": [0, 1]}}}}}
    """
    from scipy.stats import loguniform, uniform

    from repro_torch.core.spaces import Choice, Int, LogInt

    def one(name: str, s: Any, nested: bool = False) -> Any:
        if not isinstance(s, dict) or len(s) != 1:
            raise ServiceError(400, f"bad spec for param {name!r}: {s!r}")
        kind, arg = next(iter(s.items()))
        if kind == "uniform":
            return uniform(float(arg[0]), float(arg[1]))
        if kind == "loguniform":
            return loguniform(float(arg[0]), float(arg[1]))
        if kind == "range":
            return range(*[int(a) for a in arg])
        if kind == "choice":
            return list(arg)
        if kind == "int":
            return Int(int(arg[0]), int(arg[1]))
        if kind == "logint":
            return LogInt(int(arg[0]), int(arg[1]))
        if kind == "const":
            return arg
        if kind == "cond" and not nested:
            if not isinstance(arg, dict) or not arg:
                raise ServiceError(
                    400, f"cond spec for {name!r} wants a branch dict")
            return Choice({
                bname: {cn: one(f"{name}.{bname}.{cn}", cs, nested=True)
                        for cn, cs in sub.items()}
                for bname, sub in arg.items()})
        raise ServiceError(400, f"unknown spec kind {kind!r} "
                                f"for param {name!r}")

    return {name: one(name, s) for name, s in spec.items()}


class CrashPoints:
    """Deterministic SIGKILL injection for the chaos harness.

    ``REPRO_SERVICE_CRASH="ask.mid_journal:2,compact.after_snapshot:0"``
    kills the process at the 3rd hit of the first tag or the 1st of the
    second (0-based hit index per tag).  Mutations are serialized under
    the service lock, so hit counts are a pure function of the op stream
    — the same workload always dies at the same byte.
    """

    def __init__(self, spec: Optional[str] = None):
        spec = (os.environ.get("REPRO_SERVICE_CRASH", "")
                if spec is None else spec)
        self._armed: Dict[str, int] = {}
        self._hits: Dict[str, int] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            tag, idx = part.rsplit(":", 1)
            self._armed[tag] = int(idx)

    def check(self, tag: str) -> None:
        if tag not in self._armed:
            return
        hit = self._hits.get(tag, 0)
        self._hits[tag] = hit + 1
        if hit == self._armed[tag]:
            os.kill(os.getpid(), signal.SIGKILL)

    def hook(self, tag: str) -> Optional[Callable[[], None]]:
        """A callable for WAL ``mid_hook`` — only when the tag is armed,
        so production appends stay single-write."""
        if tag not in self._armed:
            return None
        return lambda: self.check(tag)


class TuningService:
    """The service core: bank + WAL + side tables, HTTP-agnostic.  The
    bank's device stages run on ``device`` (``cuda`` unless ``"cpu"``)."""

    def __init__(self, data_dir, config: Optional[Dict[str, Any]] = None,
                 crash: Optional[CrashPoints] = None,
                 device: DeviceLike = None):
        from repro_torch.core.studybank import StudyBank
        self.data_dir = str(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        cfg_path = os.path.join(self.data_dir, CONFIG)
        if config is not None and not os.path.exists(cfg_path):
            atomic_write_text(cfg_path, json.dumps(config, indent=1))
        if not os.path.exists(cfg_path):
            raise ServiceError(500, f"no {CONFIG} in {self.data_dir}; pass "
                                    "config= on first start")
        with open(cfg_path) as fh:
            self.config = json.load(fh)
        cfg = self.config
        # a persisted ``use_pallas`` (JAX package data dirs) is ignored: the
        # bank runs its kernels on the card, their plain versions on the CPU
        self.bank = StudyBank(
            space_from_spec(cfg["space"]),
            n_studies=int(cfg.get("max_studies", 16)),
            optimizer=cfg.get("optimizer", "bayesian"),
            seed=int(cfg.get("seed", 0)),
            mc_samples=cfg.get("mc_samples"),
            fit_steps=int(cfg.get("fit_steps", 40)),
            refit_every=int(cfg.get("refit_every", 8)),
            strategy_kwargs=cfg.get("strategy_kwargs"), device=device)
        self.compact_every_ops = int(cfg.get("compact_every_ops", 0))
        self.compact_interval_s = float(cfg.get("compact_interval_s", 0.0))
        self.crash = crash or CrashPoints()
        self._lock = threading.RLock()
        self._names: Dict[str, int] = {}
        # per-study req_id -> trial-id list: asks cache their proposal ids,
        # observes the single registered id, traces an empty list (the
        # reply is rebuilt from the live trials, so status stays current)
        self._reply_cache: Dict[int, "OrderedDict[str, List[int]]"] = {}
        self.wal_error: Optional[str] = None
        self._ops_since_snapshot = 0
        self._snap_path = os.path.join(self.data_dir, SNAPSHOT)
        self.recovery = recover(
            self.data_dir, self.bank, self._apply_record,
            on_snapshot=lambda: self._restore_extra(self.bank.extra))
        self.wal = WriteAheadLog(os.path.join(self.data_dir, WAL_FILE))
        # background compaction: the request path only *signals* (an Event
        # set is nanoseconds); the snapshot+truncate stall moves off the
        # serving threads onto this timer-driven daemon
        self._compact_wake = threading.Event()
        self._stop = threading.Event()
        self._compact_thread: Optional[threading.Thread] = None
        if self.compact_every_ops or self.compact_interval_s:
            self._compact_thread = threading.Thread(
                target=self._compact_loop, name="wal-compactor", daemon=True)
            self._compact_thread.start()

    # ------------------------------------------------------- side tables
    def _restore_extra(self, extra) -> None:
        if not extra:
            return
        self._names = dict(extra.get("names", {}))
        self._reply_cache = {
            int(b): OrderedDict((rid, list(ids)) for rid, ids in entries)
            for b, entries in extra.get("reply_cache", {}).items()}

    def _extra_meta(self) -> Dict[str, Any]:
        return {"names": self._names,
                "reply_cache": {str(b): [[rid, ids]
                                         for rid, ids in od.items()]
                                for b, od in self._reply_cache.items()}}

    def _row(self, name: str) -> int:
        b = self._names.get(name)
        if b is None:
            raise ServiceError(404, f"unknown study {name!r}")
        return b

    def _check_writable(self) -> None:
        if self.wal_error is not None:
            raise ServiceError(
                503, f"journal volume failed ({self.wal_error}); service "
                     "is read-only until restarted on healthy storage")

    # -------------------------------------------------- journal-then-apply
    def _apply_record(self, op: Dict[str, Any]):
        """Apply one journal op to bank + side tables.  This is the ONE
        mutation path — live serving and crash replay both land here, so
        the name table and ask cache can never diverge from the bank."""
        kind = op["op"]
        b = int(op["study"])
        if kind == "create":
            self._names[op["name"]] = b
        # the shared live/replay apply path: live callers journal in
        # _commit (wal.append precedes this call), replay reads ops that
        # are already on disk
        result = self.bank.apply_op(op)  # repro: noqa REPRO-W301
        if op.get("req_id") is not None:
            payload = {"ask": lambda: [t.id for t in result],
                       "observe": lambda: [result.id],
                       "trace": lambda: []}.get(kind)
            if payload is not None:
                od = self._reply_cache.setdefault(b, OrderedDict())
                od[op["req_id"]] = payload()
                while len(od) > REPLY_CACHE_CAP:
                    od.popitem(last=False)
        return result

    def _commit(self, op: Dict[str, Any]):
        """Validate, assign the next seq, journal (fsync), then apply.
        Caller must hold the lock — WAL order must equal apply order for
        replay to be exact.  Validation comes first: once a record is
        fsync'd it WILL be replayed on every restart, so nothing that
        can't apply may reach the log."""
        assert_holds(self._lock)
        op = dict(op)
        self.bank.validate_op(op)
        op["seq"] = self.bank.next_op_seq()
        kind = op["op"]
        self.crash.check(f"{kind}.before_journal")
        try:
            self.wal.append(op, mid_hook=self.crash.hook(
                f"{kind}.mid_journal"))
        except OSError as e:
            self.wal_error = f"{type(e).__name__}: {e}"
            self._check_writable()
        self.crash.check(f"{kind}.after_journal")
        result = self._apply_record(op)
        self.crash.check(f"{kind}.after_apply")
        self._ops_since_snapshot += 1
        if (self.compact_every_ops
                and self._ops_since_snapshot >= self.compact_every_ops):
            # wake the compactor instead of snapshotting inline: the old
            # synchronous path stalled whichever unlucky request crossed
            # the threshold for the whole snapshot+fsync
            self._compact_wake.set()
        return result

    # ------------------------------------------------------------- public
    def create_study(self, name: str, sign: float = 1.0,
                     optimizer: Optional[str] = None) -> Dict[str, Any]:
        """Create (or idempotently re-create) a named study.  ``optimizer``
        picks the per-study strategy — one bank serves a heterogeneous
        GP+TPE+clustering fleet, sub-batched per family inside a single
        ``ask_all`` — and defaults to the bank-wide config strategy."""
        sign = float(sign)
        with self._lock:
            if name in self._names:
                b = self._names[name]
                view = self.bank.studies[b]
                cur = self.bank.strategy_names[b]
                if sign == view.sign and optimizer in (None, cur):
                    return {"study": b, "name": name, "optimizer": cur,
                            "created": False}
                if view.num_trials > 0:
                    raise ServiceError(
                        409, f"study {name!r} already has trials with "
                             f"sign {view.sign} / strategy {cur!r}")
            else:
                b = len(self._names)
                if b >= self.bank.n_studies:
                    raise ServiceError(
                        507, f"bank capacity {self.bank.n_studies} "
                             "exhausted (raise max_studies)")
            self._check_writable()
            op = {"op": "create", "study": b, "name": name, "sign": sign}
            if optimizer is not None:
                op["optimizer"] = str(optimizer)
            self._commit(op)
            return {"study": b, "name": name,
                    "optimizer": self.bank.strategy_names[b],
                    "created": True}

    def ask(self, name: str, n: int = 1,
            req_id: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            b = self._row(name)
            view = self.bank.studies[b]
            if req_id is not None:
                cached = self._reply_cache.get(b, {}).get(req_id)
                if cached is not None:
                    return {"trials": [self._trial_json(view._trials[i])
                                       for i in cached], "cached": True}
            self._check_writable()
            trials = self._commit({"op": "ask", "study": b, "n": int(n),
                                   "req_id": req_id})
            return {"trials": [self._trial_json(t) for t in trials],
                    "cached": False}

    def tell(self, name: str, trial_id: int, value: float) -> Dict[str, Any]:
        return self._resolve(name, trial_id, "tell", value=float(value))

    def tell_failed(self, name: str, trial_id: int) -> Dict[str, Any]:
        return self._resolve(name, trial_id, "tell_failed")

    def _resolve(self, name: str, trial_id: int, kind: str,
                 **extra) -> Dict[str, Any]:
        with self._lock:
            b = self._row(name)
            view = self.bank.studies[b]
            t = view._trials.get(int(trial_id))
            if t is None:
                raise ServiceError(404, f"study {name!r} has no trial "
                                        f"{trial_id} (tell before ask?)")
            from repro_torch.core.optimizer import PENDING
            if t.status != PENDING:
                # duplicate delivery: reply, don't journal — retries must
                # not grow the WAL
                return {**self._trial_json(t), "applied": False}
            self._check_writable()
            t, applied = self._commit({"op": kind, "study": b,
                                       "trial_id": int(trial_id), **extra})
            return {**self._trial_json(t), "applied": applied}

    def observe(self, name: str, params: Dict[str, Any], value: float,
                req_id: Optional[str] = None) -> Dict[str, Any]:
        from repro_torch.core.optimizer import _to_jsonable
        with self._lock:
            b = self._row(name)
            if req_id is not None:
                cached = self._reply_cache.get(b, {}).get(req_id)
                if cached is not None:
                    view = self.bank.studies[b]
                    return {**self._trial_json(view._trials[cached[0]]),
                            "cached": True}
            self._check_writable()
            t = self._commit({"op": "observe", "study": b,
                              "params": _to_jsonable(dict(params)),
                              "value": float(value), "req_id": req_id})
            return {**self._trial_json(t), "cached": False}

    def trace(self, name: str,
              req_id: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            b = self._row(name)
            if req_id is not None \
                    and req_id in self._reply_cache.get(b, {}):
                return {"ok": True, "cached": True}
            self._check_writable()
            self._commit({"op": "trace", "study": b, "req_id": req_id})
            return {"ok": True, "cached": False}

    def best(self, name: str) -> Dict[str, Any]:
        from repro_torch.core.optimizer import _to_jsonable
        with self._lock:
            view = self.bank.studies[self._row(name)]
            res = view.results()
            return {"best_objective": res.best_objective,
                    "best_params": _to_jsonable(res.best_params),
                    "num_trials": view.num_trials,
                    "n_observed": view.n_observed,
                    "n_failed": view.n_failed}

    def results(self, name: str) -> Dict[str, Any]:
        from repro_torch.core.optimizer import _to_jsonable
        with self._lock:
            view = self.bank.studies[self._row(name)]
            res = view.results()
            return {"best_objective": res.best_objective,
                    "best_params": _to_jsonable(res.best_params),
                    "params_tried": [_to_jsonable(p)
                                     for p in res.params_tried],
                    "objective_values": res.objective_values,
                    "best_trace": res.best_trace,
                    "n_failed": res.n_failed}

    def trials(self, name: str) -> Dict[str, Any]:
        with self._lock:
            view = self.bank.studies[self._row(name)]
            return {"trials": [self._trial_json(t)
                               for t in view._trials.values()]}

    def studies(self) -> Dict[str, Any]:
        with self._lock:
            out = []
            for name, b in sorted(self._names.items(), key=lambda kv: kv[1]):
                v = self.bank.studies[b]
                out.append({"name": name, "study": b, "sign": v.sign,
                            "num_trials": v.num_trials,
                            "n_observed": v.n_observed,
                            "n_failed": v.n_failed})
            return {"studies": out}

    def health(self) -> Dict[str, Any]:
        """Status, op sequence, studies, the WAL's error, and ``asks``:
        the bank's last asks as ``core.telemetry.summary`` gives them."""
        from repro_torch.core import telemetry
        return {"status": "degraded" if self.wal_error else "ok",
                "op_seq": self.bank.op_seq,
                "n_studies": len(self._names),
                "wal_error": self.wal_error,
                "asks": telemetry.summary(self.bank.telemetry_id)}

    # --------------------------------------------------------- compaction
    def compact(self) -> Dict[str, Any]:
        with self._lock:
            self._check_writable()
            return self._compact_locked()

    def _compact_loop(self) -> None:
        """Daemon compactor: sleeps until the op-count threshold signal
        (``_commit``) or the ``compact_interval_s`` timer, then takes the
        service lock and snapshots.  Compaction never changes bank state
        (replay skips ``seq <= snapshot op_seq``), so running it off the
        request path is crash-equivalent to the old inline call — the
        chaos harness's ``compact.background`` point proves it."""
        while not self._stop.is_set():
            self._compact_wake.wait(self.compact_interval_s or None)
            if self._stop.is_set():
                return
            self._compact_wake.clear()
            with self._lock:
                if self.wal_error is not None \
                        or self._ops_since_snapshot == 0:
                    continue
                self.crash.check("compact.background")
                try:
                    self._compact_locked()
                except ServiceError:
                    continue    # degraded -> read-only; nothing to drain

    def _compact_locked(self) -> Dict[str, Any]:
        assert_holds(self._lock)  # caller-must-hold: snapshot vs. commits
        self.crash.check("compact.before_snapshot")
        try:
            # the snapshot carries op_seq + side tables; the replace is
            # atomic, and the truncate below need not be coupled to it —
            # replay skips seq <= snapshot op_seq
            self.bank.save(self._snap_path, iteration=self.bank.op_seq,
                           extra=self._extra_meta())
            self.crash.check("compact.after_snapshot")
            self.wal.reset()
        except OSError as e:
            self.wal_error = f"{type(e).__name__}: {e}"
            self._check_writable()
        self.crash.check("compact.after_truncate")
        self._ops_since_snapshot = 0
        return {"op_seq": self.bank.op_seq}

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _trial_json(t) -> Dict[str, Any]:
        from repro_torch.core.optimizer import _to_jsonable
        return {"id": t.id, "params": _to_jsonable(t.params),
                "status": t.status, "value": t.value}

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Stop the background compactor (joining it for up to
        ``timeout`` seconds — an in-flight snapshot finishes first) and
        close the WAL.  Idempotent."""
        self._stop.set()
        self._compact_wake.set()
        if self._compact_thread is not None:
            self._compact_thread.join(timeout)
            self._compact_thread = None
        self.wal.close()

    def close(self) -> None:
        self.shutdown(timeout=10.0)


# ---------------------------------------------------------------- HTTP layer
class _Handler(BaseHTTPRequestHandler):
    service: TuningService = None   # set by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):       # quiet: chaos restarts spam otherwise
        pass

    def _reply(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length") or 0)
        if not n:
            return {}
        try:
            return json.loads(self.rfile.read(n).decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise ServiceError(400, "request body is not valid JSON")

    def _route(self, method: str) -> None:
        svc = self.service
        parts = [unquote(p) for p in
                 urlparse(self.path).path.strip("/").split("/") if p]
        try:
            if method == "GET":
                if parts == ["health"]:
                    return self._reply(200, svc.health())
                if parts == ["studies"]:
                    return self._reply(200, svc.studies())
                if len(parts) == 3 and parts[0] == "studies":
                    name, verb = parts[1], parts[2]
                    if verb == "best":
                        return self._reply(200, svc.best(name))
                    if verb == "results":
                        return self._reply(200, svc.results(name))
                    if verb == "trials":
                        return self._reply(200, svc.trials(name))
            else:  # POST
                body = self._body()
                if parts == ["studies"]:
                    return self._reply(200, svc.create_study(
                        body["name"], body.get("sign", 1.0),
                        body.get("optimizer")))
                if parts == ["admin", "compact"]:
                    return self._reply(200, svc.compact())
                if len(parts) == 3 and parts[0] == "studies":
                    name, verb = parts[1], parts[2]
                    if verb == "ask":
                        return self._reply(200, svc.ask(
                            name, body.get("n", 1), body.get("req_id")))
                    if verb == "tell":
                        return self._reply(200, svc.tell(
                            name, body["trial_id"], body["value"]))
                    if verb == "tell_failed":
                        return self._reply(200, svc.tell_failed(
                            name, body["trial_id"]))
                    if verb == "observe":
                        return self._reply(200, svc.observe(
                            name, body["params"], body["value"],
                            body.get("req_id")))
                    if verb == "trace":
                        return self._reply(200, svc.trace(
                            name, body.get("req_id")))
            raise ServiceError(404, f"no route {method} {self.path}")
        except ServiceError as e:
            self._reply(e.status, {"error": str(e)})
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — the service must stay up
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")


def serve(data_dir, host: str = "127.0.0.1", port: int = 0,
          config: Optional[Dict[str, Any]] = None,
          device: DeviceLike = None):
    """Build the service and a threaded HTTP server bound to ``port``
    (0 = ephemeral).  Returns ``(httpd, service)``; caller runs
    ``httpd.serve_forever()``."""
    service = TuningService(data_dir, config=config, device=device)
    handler = type("BoundHandler", (_Handler,), {"service": service})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd, service


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="durable tuning service")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--config", default=None,
                    help="JSON config file (first start only)")
    ap.add_argument("--device", default="cuda",
                    help="where the bank's device stages run (cuda|cpu)")
    args = ap.parse_args(argv)
    config = None
    if args.config:
        with open(args.config) as fh:
            config = json.load(fh)
    httpd, service = serve(args.data_dir, args.host, args.port,
                           config=config, device=args.device)
    # the chaos harness parses this line to learn the bound port
    print(f"SERVING {httpd.server_address[0]} {httpd.server_address[1]} "
          f"op_seq={service.bank.op_seq}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
