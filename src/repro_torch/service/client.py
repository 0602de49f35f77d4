"""Client for the durable tuning service (stdlib ``urllib`` only).

Two layers:

  * ``ServiceClient`` — thin JSON-over-HTTP wrapper, one method per
    endpoint, with bounded retries on connection errors.  Retries are
    safe by construction: every mutating endpoint is idempotent (create
    by name, tell by trial id, ask/observe/trace by ``req_id`` — minted
    here per logical call, before the retry loop, so every resend
    carries the same id), so a request whose response was lost to a
    crash can be resent verbatim and lands exactly once.
  * ``RemoteOptimizer`` — duck-types the ``AskTellOptimizer`` surface the
    tuner drivers use (``ask``/``tell``/``tell_failed``/
    ``observe_params``/``snapshot_trace``/``results``/counters), backed
    by one named study on the service.  ``ServiceScheduler.make_engine``
    hands this to ``Tuner``/``AsyncTuner``, so the existing driver loops
    run against a remote service unchanged.

The port's copy of ``repro.service.client``: the wire format is the same,
so a client of either package talks to a server of either.
"""
from __future__ import annotations

import http.client
import json
import time
import uuid
from typing import Any, Dict, List, Optional
from urllib.error import HTTPError, URLError
from urllib.parse import quote
from urllib.request import Request, urlopen


class ServiceError(Exception):
    """An error with an HTTP status.  The server core raises it to name
    the reply code (the handler maps it to a JSON error body); the client
    re-raises it for any non-2xx response, so callers on either side of
    the wire catch the same type."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ServiceDown(Exception):
    """Could not reach the service at all (refused/reset/timeout)."""


class ServiceClient:
    def __init__(self, base_url: str, timeout: float = 10.0,
                 retries: int = 3, retry_wait: float = 0.1):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.retry_wait = retry_wait

    # ------------------------------------------------------------- plumbing
    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        data = None if body is None else json.dumps(body).encode()
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            req = Request(self.base_url + path, data=data, method=method,
                          headers={"Content-Type": "application/json"})
            try:
                with urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read().decode())
            except HTTPError as e:
                # the server answered: no retry, surface its error
                try:
                    msg = json.loads(e.read().decode()).get("error", str(e))
                except Exception:  # noqa: BLE001
                    msg = str(e)
                raise ServiceError(e.code, msg) from None
            except (URLError, ConnectionError, TimeoutError, OSError,
                    http.client.HTTPException) as e:
                # HTTPException covers a SIGKILL mid-response
                # (RemoteDisconnected / IncompleteRead)
                last = e
                if attempt < self.retries:
                    time.sleep(self.retry_wait * (attempt + 1))
        raise ServiceDown(f"{method} {path}: {last}") from last

    @staticmethod
    def _study_path(name: str, verb: str) -> str:
        return f"/studies/{quote(name, safe='')}/{verb}"

    # ------------------------------------------------------------ endpoints
    def create_study(self, name: str, sign: float = 1.0,
                     optimizer: Optional[str] = None) -> Dict[str, Any]:
        body = {"name": name, "sign": sign}
        if optimizer is not None:
            body["optimizer"] = optimizer
        return self._request("POST", "/studies", body)

    def ask(self, name: str, n: int = 1,
            req_id: Optional[str] = None) -> Dict[str, Any]:
        return self._request("POST", self._study_path(name, "ask"),
                             {"n": n,
                              "req_id": req_id or uuid.uuid4().hex})

    def tell(self, name: str, trial_id: int, value: float) -> Dict[str, Any]:
        return self._request("POST", self._study_path(name, "tell"),
                             {"trial_id": trial_id, "value": value})

    def tell_failed(self, name: str, trial_id: int) -> Dict[str, Any]:
        return self._request("POST", self._study_path(name, "tell_failed"),
                             {"trial_id": trial_id})

    def observe(self, name: str, params: Dict[str, Any], value: float,
                req_id: Optional[str] = None) -> Dict[str, Any]:
        return self._request("POST", self._study_path(name, "observe"),
                             {"params": params, "value": value,
                              "req_id": req_id or uuid.uuid4().hex})

    def trace(self, name: str,
              req_id: Optional[str] = None) -> Dict[str, Any]:
        return self._request("POST", self._study_path(name, "trace"),
                             {"req_id": req_id or uuid.uuid4().hex})

    def best(self, name: str) -> Dict[str, Any]:
        return self._request("GET", self._study_path(name, "best"))

    def results(self, name: str) -> Dict[str, Any]:
        return self._request("GET", self._study_path(name, "results"))

    def trials(self, name: str) -> Dict[str, Any]:
        return self._request("GET", self._study_path(name, "trials"))

    def studies(self) -> Dict[str, Any]:
        return self._request("GET", "/studies")

    def health(self) -> Dict[str, Any]:
        return self._request("GET", "/health")

    def compact(self) -> Dict[str, Any]:
        return self._request("POST", "/admin/compact", {})


class RemoteTrial:
    """Client-side view of a service trial (duck-types ``Trial`` for the
    driver loops: ``id``/``params``/``status``/``value``; ``params`` is
    rebindable like the ledger-backed original)."""

    __slots__ = ("id", "params", "status", "value")

    def __init__(self, d: Dict[str, Any]):
        self.id = int(d["id"])
        self.params = dict(d["params"])
        self.status = d["status"]
        self.value = d["value"]


class RemoteOptimizer:
    """``AskTellOptimizer`` surface over one named remote study."""

    def __init__(self, client: ServiceClient, study: str,
                 param_space=None, sign: float = 1.0):
        from repro_torch.core.spaces import ParamSpace
        self.client = client
        self.study = study
        if param_space is None or isinstance(param_space, ParamSpace):
            self.space = param_space
        else:
            self.space = ParamSpace(param_space)
        self._sign = float(sign)
        self._created = False

    # sign assignment is how the drivers select maximize/minimize; the
    # study direction lives server-side, so propagate it (create is
    # idempotent by name — a same-sign repeat is a no-op)
    @property
    def sign(self) -> float:
        return self._sign

    @sign.setter
    def sign(self, v: float) -> None:
        self._sign = float(v)
        self.client.create_study(self.study, sign=self._sign)
        self._created = True

    def _ensure(self) -> None:
        if not self._created:
            self.client.create_study(self.study, sign=self._sign)
            self._created = True

    # ----------------------------------------------------------- ask/tell
    def ask(self, n: int = 1) -> List[RemoteTrial]:
        self._ensure()
        # a fresh req_id per logical ask: a lost response is retried with
        # the SAME id, so the service re-serves the cached proposals
        # instead of minting (and journaling) a second draw
        out = self.client.ask(self.study, n=n, req_id=uuid.uuid4().hex)
        return [RemoteTrial(t) for t in out["trials"]]

    def tell(self, trial_id: int, value: float) -> RemoteTrial:
        return RemoteTrial(self.client.tell(self.study, trial_id,
                                            float(value)))

    def tell_failed(self, trial_id: int) -> RemoteTrial:
        return RemoteTrial(self.client.tell_failed(self.study, trial_id))

    def observe_params(self, params: Dict[str, Any],
                       value: float) -> RemoteTrial:
        from repro_torch.core.optimizer import _to_jsonable
        self._ensure()
        return RemoteTrial(self.client.observe(
            self.study, _to_jsonable(dict(params)), float(value)))

    def snapshot_trace(self) -> None:
        self.client.trace(self.study)

    def pending_trials(self) -> List[RemoteTrial]:
        out = self.client.trials(self.study)
        return [RemoteTrial(t) for t in out["trials"]
                if t["status"] == "pending"]

    # ------------------------------------------------------------ counters
    def _best(self) -> Dict[str, Any]:
        self._ensure()
        return self.client.best(self.study)

    @property
    def num_trials(self) -> int:
        return int(self._best()["num_trials"])

    @property
    def n_observed(self) -> int:
        return int(self._best()["n_observed"])

    @property
    def n_failed(self) -> int:
        return int(self._best()["n_failed"])

    # ------------------------------------------------------------- results
    def results(self, iterations: Optional[int] = None, wall: float = 0.0):
        from repro_torch.core.tuner import TunerResults
        r = self.client.results(self.study)
        return TunerResults(
            best_objective=r["best_objective"],
            best_params=r["best_params"],
            params_tried=r["params_tried"],
            objective_values=r["objective_values"],
            best_trace=r["best_trace"],
            iterations=(len(r["objective_values"]) if iterations is None
                        else iterations),
            n_failed=r["n_failed"],
            wall_time_s=wall)

    # the service journals every mutation — driver-side checkpointing is
    # redundant, so the hooks are accepted and ignored
    def save(self, path, iteration: int = 0) -> None:
        pass

    def load(self, path) -> int:
        return 0
