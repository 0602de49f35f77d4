"""Chaos harness: SIGKILL the tuning service at seeded points, restart,
and prove recovery is *exact*.

The harness runs the service as a subprocess and drives a deterministic
multi-study ask/tell workload against it over HTTP.  For each of
``--kills`` phases it arms one crash point (``REPRO_SERVICE_CRASH``,
derived from ``random.Random(seed * 1_000_003 + phase)`` — the same
per-task seeding idiom as ``scheduler.distributed.FaultInjection``, so
the kill schedule is a pure function of the seed).  When the process dies
mid-call, the harness restarts it and *re-issues the interrupted request
verbatim* — same ``req_id``, same trial id — exercising every recovery
guarantee at once: torn-tail truncation, WAL suffix replay over the
snapshot, ask dedup, tell dedup.

After the workload (plus one final crash-free restart, proving recovery
is idempotent), an uninterrupted in-process oracle runs the identical
script in a second data dir, and the harness asserts:

  * ``op_seq`` equal — no journaled op was lost or double-counted;
  * every study's full trial ledger (ids, params, status, values) is
    JSON-equal — no tell double-applied, no proposal re-drawn;
  * the *next* proposals from both services are bit-equal — the
    recovered optimizer state (RNG streams, GP fit schedule) is exact,
    not merely consistent.

Exit code 0 = all phases passed; on failure the data dirs (WAL +
snapshots) are left in place as artifacts.

The port's copy of ``repro.service.chaos``.  Both sides run on ``device``
(``cuda`` unless ``"cpu"`` is asked for): each server subprocess is started
with ``--device`` and the oracle's bank is built there.  On the card the
ask path's kernels are built once, in this process, before the first
server starts; every server then loads them from ``build/``.

    PYTHONPATH=src python -m repro_torch.service.chaos --data-dir DIR \
        --device cuda      # or --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.service.client import ServiceClient, ServiceDown
from repro_torch.service.wal import atomic_write_text

# the directory holding the ``repro_torch`` package: server subprocesses
# import it from there whatever the caller's working directory
_SRC = str(Path(__file__).resolve().parents[2])

# tags eligible for a seeded kill; indices stay small so every spec fires
# within one phase's slice of the workload
KILL_TAGS = [
    ("ask.mid_journal", 2),        # (tag, index upper bound)
    ("ask.after_journal", 2),
    ("tell.mid_journal", 3),
    ("tell.after_journal", 3),
    ("tell.after_apply", 3),
    ("tell_failed.after_journal", 1),
    ("compact.before_snapshot", 1),
    ("compact.after_snapshot", 1),
    ("compact.after_truncate", 1),
    ("compact.background", 1),     # dies inside the compactor daemon
]

DEFAULT_CONFIG = {
    "space": {"x": {"uniform": [-2.0, 4.0]},
              "lr": {"loguniform": [1e-4, 1e-1]}},
    "max_studies": 8,
    "optimizer": "bayesian",
    "seed": 0,
    "mc_samples": 32,
    "fit_steps": 4,
    "refit_every": 4,
    "compact_every_ops": 10,       # arms the background compactor
}

# the heterogeneous fleet the workload provisions: one bank serves all
# three families, sub-batched inside each ask_all
STRATEGY_CYCLE = ["bayesian", "tpe", "clustering"]


def kill_specs(seed: int, kills: int) -> List[str]:
    """One ``tag:index`` spec per phase, a pure function of the seed."""
    specs = []
    for i in range(kills):
        rng = random.Random(seed * 1_000_003 + i)
        tag, bound = KILL_TAGS[rng.randrange(len(KILL_TAGS))]
        specs.append(f"{tag}:{rng.randrange(bound)}")
    return specs


# --------------------------------------------------------------- workload
class Workload:
    """Deterministic script of service calls.  ``run_step`` executes one
    step against any executor (HTTP client or in-process service) and
    keeps per-study trial bookkeeping, so the oracle and the chaos run
    issue byte-identical request sequences."""

    def __init__(self, seed: int, studies: int, rounds: int, batch: int):
        self.seed = seed
        self.names = [f"s{i}" for i in range(studies)]
        self.rounds = rounds
        self.batch = batch
        self._value_seq = 0

    def _value(self) -> float:
        v = random.Random(self.seed * 1_000_003
                          + 7_777_777 + self._value_seq).uniform(-2.0, 2.0)
        self._value_seq += 1
        return v

    def steps(self):
        """Yields (kind, name, payload) tuples.  Tell steps reference ask
        replies positionally: trial ids are minted sequentially per study,
        so id = round*batch + slot deterministically."""
        for i, name in enumerate(self.names):
            yield ("create", name,
                   {"sign": -1.0 if i % 2 else 1.0,
                    "optimizer": STRATEGY_CYCLE[i % len(STRATEGY_CYCLE)]})
        for r in range(self.rounds):
            for s, name in enumerate(self.names):
                yield ("ask", name, {"n": self.batch,
                                     "req_id": f"r{r}s{s}"})
                for slot in range(self.batch):
                    tid = r * self.batch + slot
                    # every 7th resolution is a failure (deterministic)
                    if (r * self.batch + slot + s) % 7 == 3:
                        yield ("tell_failed", name, {"trial_id": tid})
                    else:
                        yield ("tell", name, {"trial_id": tid,
                                              "value": self._value()})
                yield ("trace", name, {})
            yield ("compact", None, {})


def exec_step(ex, step: Tuple[str, Optional[str], Dict[str, Any]]):
    kind, name, p = step
    if kind == "create":
        return ex.create_study(name, sign=p["sign"],
                               optimizer=p.get("optimizer"))
    if kind == "ask":
        return ex.ask(name, n=p["n"], req_id=p["req_id"])
    if kind == "tell":
        return ex.tell(name, p["trial_id"], p["value"])
    if kind == "tell_failed":
        return ex.tell_failed(name, p["trial_id"])
    if kind == "trace":
        return ex.trace(name)
    if kind == "compact":
        return ex.compact()
    raise ValueError(kind)


# ------------------------------------------------------------- subprocess
class ServerProc:
    def __init__(self, data_dir: str, config_path: Optional[str],
                 crash_spec: str = "", device: str = "cuda"):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH")) if p)
        if crash_spec:
            env["REPRO_SERVICE_CRASH"] = crash_spec
        else:
            env.pop("REPRO_SERVICE_CRASH", None)
        cmd = [sys.executable, "-m", "repro_torch.service.server",
               "--data-dir", data_dir, "--port", "0", "--device", device]
        if config_path:
            cmd += ["--config", config_path]
        t0 = time.monotonic()
        self.proc = subprocess.Popen(cmd, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.base_url = self._await_serving()
        # seconds from the start to SERVING: interpreter, torch, recovery
        self.start_s = time.monotonic() - t0

    def _await_serving(self, timeout: float = 180.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"server exited during startup "
                    f"(rc={self.proc.poll()})")
            if line.startswith("SERVING "):
                _, host, port = line.split()[:3]
                return f"http://{host}:{port}"
        raise RuntimeError("server did not print SERVING in time")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait_dead(self, timeout: float = 10.0) -> bool:
        try:
            self.proc.wait(timeout)
            return True
        except subprocess.TimeoutExpired:
            return False

    def kill(self) -> None:
        if self.alive():
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait()


# ----------------------------------------------------------------- oracle
class OracleExec:
    """In-process uninterrupted run of the same workload (the ground
    truth the chaos run must be bit-equal to)."""

    def __init__(self, data_dir: str, config: Dict[str, Any],
                 device: DeviceLike = None):
        from repro_torch.service.server import CrashPoints, TuningService
        # explicit empty spec: the oracle must never inherit the harness
        # environment's crash points
        self.svc = TuningService(data_dir, config=config,
                                 crash=CrashPoints(""), device=device)

    def __getattr__(self, item):
        if item in ("create_study", "ask", "tell", "tell_failed", "trace",
                    "compact", "best", "results", "trials", "health"):
            return getattr(self.svc, item)
        raise AttributeError(item)


def build_kernels(device: DeviceLike = None) -> None:
    """On the card, build the ask path's kernel libraries (GP and TPE) in
    this process, so that server subprocesses load them from ``build/``
    instead of each running nvcc into the same directory."""
    if resolve_device(device).type != "cuda":
        return
    from repro_torch.kernels.gp_acquisition import ops
    from repro_torch.kernels.tpe_kde import ops as tpe_ops
    ops.library()
    tpe_ops.library()


# ------------------------------------------------------------------ main
def run(data_dir: str, kills: int = 5, seed: int = 0, studies: int = 3,
        rounds: int = 6, batch: int = 2,
        config: Optional[Dict[str, Any]] = None,
        verbose: bool = True, device: DeviceLike = None) -> Dict[str, Any]:
    dev = str(resolve_device(device))
    build_kernels(dev)
    cfg = dict(config or DEFAULT_CONFIG)
    cfg["seed"] = seed
    os.makedirs(data_dir, exist_ok=True)
    svc_dir = os.path.join(data_dir, "service")
    oracle_dir = os.path.join(data_dir, "oracle")
    cfg_path = os.path.join(data_dir, "config.json")
    atomic_write_text(cfg_path, json.dumps(cfg))

    def say(msg):
        if verbose:
            print(msg, flush=True)

    specs = kill_specs(seed, kills)
    say(f"chaos: kill schedule {specs}")

    steps = list(Workload(seed, studies, rounds, batch).steps())
    fired: List[str] = []
    pos = 0
    phase = 0
    server = ServerProc(svc_dir, cfg_path,
                        specs[phase] if phase < len(specs) else "", dev)
    start_s = [server.start_s]
    client = ServiceClient(server.base_url, timeout=60.0, retries=0)
    while pos < len(steps):
        step = steps[pos]
        try:
            exec_step(client, step)
            pos += 1
        except ServiceDown:
            if not server.wait_dead(timeout=15.0):
                server.kill()
                raise RuntimeError(
                    f"call failed but server still alive at step {pos} "
                    f"({step[0]}) — not a crash-point death")
            say(f"chaos: killed at step {pos} ({step[0]}) by "
                f"{specs[phase]}; restarting")
            fired.append(specs[phase])
            phase += 1
            server = ServerProc(
                svc_dir, None, specs[phase] if phase < len(specs) else "",
                dev)
            start_s.append(server.start_s)
            client = ServiceClient(server.base_url, timeout=60.0, retries=0)
            # re-issue the interrupted step verbatim: dedup must absorb it
    # a spec may not fire if the workload ran out first — report, and the
    # bit-equality checks below still hold for however many fired
    if phase < len(specs):
        say(f"chaos: {len(specs) - phase} spec(s) never fired: "
            f"{specs[phase:]}")
    server.kill()

    # final crash-free restart: recovery must be idempotent (replaying an
    # already-recovered dir changes nothing)
    server = ServerProc(svc_dir, None, "", dev)
    start_s.append(server.start_s)
    client = ServiceClient(server.base_url, timeout=60.0, retries=2)

    say("chaos: running uninterrupted oracle")
    oracle = OracleExec(oracle_dir, cfg, dev)
    for step in list(Workload(seed, studies, rounds, batch).steps()):
        exec_step(oracle, step)

    # ---------------------------------------------------------- compare
    failures: List[str] = []
    h_svc, h_orc = client.health(), oracle.health()
    if h_svc["op_seq"] != h_orc["op_seq"]:
        failures.append(f"op_seq diverged: service {h_svc['op_seq']} "
                        f"vs oracle {h_orc['op_seq']}")
    names = [f"s{i}" for i in range(studies)]
    for name in names:
        t_svc = client.trials(name)["trials"]
        t_orc = oracle.trials(name)["trials"]
        if t_svc != t_orc:
            failures.append(f"{name}: trial ledger diverged "
                            f"(dedup violated or replay drifted)")
            for a, b in zip(t_svc, t_orc):
                if a != b:
                    failures.append(f"  first diff: {a!r} != {b!r}")
                    break
        # remaining proposals must be bit-equal: the recovered RNG/GP
        # state, not just the ledger, is exact
        p_svc = client.ask(name, n=2 * batch)["trials"]
        p_orc = oracle.ask(name, n=2 * batch)["trials"]
        if p_svc != p_orc:
            failures.append(f"{name}: post-recovery proposals diverged")
            failures.append(f"  service: {p_svc!r}")
            failures.append(f"  oracle:  {p_orc!r}")
    server.kill()
    oracle.svc.close()

    report = {"kills_requested": kills, "kills_fired": len(fired),
              "fired": fired, "steps": len(steps), "failures": failures,
              "start_s": start_s}
    say(f"chaos: {len(fired)}/{kills} kills fired over {len(steps)} steps; "
        f"{'PASS' if not failures else 'FAIL'}")
    for f in failures:
        say(f"  {f}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SIGKILL chaos harness for the durable tuning service")
    ap.add_argument("--data-dir", required=True,
                    help="work dir; service/ and oracle/ land here and are "
                         "left as artifacts on failure")
    ap.add_argument("--kills", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--studies", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the servers' and the oracle's banks run "
                         "(cuda|cpu)")
    args = ap.parse_args(argv)
    report = run(args.data_dir, kills=args.kills, seed=args.seed,
                 studies=args.studies, rounds=args.rounds, batch=args.batch,
                 device=args.device)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
