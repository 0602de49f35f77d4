"""One run of one cell: set-up, the measured window, the correctness check
and the result line.

The cell's files are found by name: ``configs/<config>.json`` (the
configuration as it is run), the objective it names
(``objectives/<objective>.py``) and its reference (the file its
``reference`` key names), ``traffic/<traffic>.json`` (the mix, read by
``fleet.Fleet``), ``limits/<workload>.json`` (the limit of each number the
check compares) and, for a ``--trace 1`` run, ``metrics/<metric>.py`` for
each per-layer metric that ``BENCHMARK.json`` lists for the cell.  A
configuration the harness cannot run as it states (another dimension than
its objective's, a precision other than the port's float32, an optimizer
its reference does not judge) is refused before anything runs.  A
reference module names the optimizers it judges (``OPTIMIZERS``), judges
one recorded ask (``judge_ask``), and may name further numbers of the check
(``NUMBERS``: each reading's name and whether the check takes its ``max``
or its ``sum``) and its control precision (``CONTROL``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PRECISION = "float32"    # the port's ask runs in float32 only
# the configuration keys a strategy takes, passed as its ``strategy_kwargs``
STRATEGY_KEYS = ("top_frac", "gamma", "pending_penalty")


# ------------------------------------------------------------------ files
def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str, pb: Path = PB) -> dict:
    """The workload's entry and everything it names, read from disk."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((pb.parent / cfg_entry["file"]).read_text())
    traffic = json.loads((pb / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    lim_path = pb / "limits" / f"{workload}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    objective = load_module(pb / "objectives" / f"{cfg['objective']}.py")
    reference = load_module(pb.parent / cfg["reference"])
    if objective.DIM != cfg["dim"]:
        raise ValueError(f"{cfg['name']}: dim {cfg['dim']} is not its "
                         f"objective's {objective.DIM}")
    if cfg["precision"] != PRECISION:
        raise ValueError(f"{cfg['name']}: the port runs the ask in "
                         f"{PRECISION}, not {cfg['precision']}")
    if cfg["optimizer"] not in reference.OPTIMIZERS:
        raise ValueError(f"{cfg['name']}: {cfg['reference']} judges "
                         f"{reference.OPTIMIZERS}, not {cfg['optimizer']!r}")
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": limits.get("limits", {}), "objective": objective,
            "reference": reference}


def metric_entries(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics a traced run of ``workload`` reports (every
    per-layer entry lists its cells)."""
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def end_to_end_entries(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


_MODULES: Dict[Path, object] = {}


def load_module(path: Path):
    """The module in the file ``path``, loaded once; a missing file is
    refused with its name."""
    path = Path(path).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"the benchmark has no {path.name}")
        name = "portbench_file_" + "_".join(
            path.with_suffix("").parts[-2:]).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str, pb: Path = PB) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return load_module(pb / "metrics" / f"{name}.py").read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------- the program
def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def bank_config(cfg: dict) -> dict:
    """Everything the reference and the work counts need of the config."""
    out = dict(cfg)
    out["domain_size"] = float(cfg["domain_size"])
    if cfg["optimizer"] == "clustering":
        S, n = cfg["mc_samples"], cfg["batch_size"]
        out["n_top"] = min(max(n * 4, int(S * cfg["top_frac"])), S)
    return out


def make_bank(cfg: dict, objective, seed: int, device):
    from repro_torch.core.studybank import StudyBank
    kw = {k: cfg[k] for k in STRATEGY_KEYS if k in cfg} or None
    bank = StudyBank(objective.space(), cfg["n_studies"],
                     optimizer=cfg["optimizer"], seed=seed,
                     mc_samples=cfg["mc_samples"],
                     fit_steps=cfg["fit_steps"],
                     refit_every=cfg["refit_every"], strategy_kwargs=kw,
                     device=device)
    if bank.space.domain_size != cfg["domain_size"]:
        raise ValueError("the space's domain size is not the config's")
    return bank


class Probe:
    """Wraps the bank's entry points (``gp.BANK_ENTRY_POINTS``) and the
    scorers (``ops.score_cov``, the TPE ``ops.tpe_scores``) for the window:
    records the bucket ``na`` of every pick, captures the inputs and scores
    of the asks the check will read (the candidate block that
    ``bank_prescale_C`` or ``fused_tpe_propose_bank`` takes, the clustering
    head's uniforms, what ``score_cov`` and ``tpe_scores`` return), and in
    a traced run opens a host annotation and a pair of CUDA events around
    each entry."""

    STAGE = {"fit_hypers_bank": "fit", "bank_factors": "fit",
             "bank_prescale_X": "fit", "bank_prescale_C": "pick",
             "bank_absorb": "pick", "bank_pick": "pick",
             "bank_cluster_pick": "pick", "fused_tpe_propose_bank": "pick"}
    # the argument that holds the observation block (B, na, dp) of a pick
    XS_ARG = {"bank_pick": 1, "bank_cluster_pick": 2,
              "fused_tpe_propose_bank": 0}
    # the captured inputs: (entry, key, position, keyword)
    CAPTURE = (("bank_prescale_C", "C", 0, "C"),
               ("bank_cluster_pick", "u", 10, "u"),
               ("fused_tpe_propose_bank", "C", 2, "C"))
    # the keys of one ask's capture
    KEYS = ("C", "u", "scores", "tpe_scores")

    def __init__(self, device, trace: bool):
        self.device = device
        self.trace = trace and str(device).startswith("cuda")
        self.annotate = trace
        self.na: List[int] = []
        self.fits = 0
        self.capture: Optional[Dict[str, list]] = None
        self.round = 0
        self.spans: List[tuple] = []
        self._undo: List[Callable] = []

    def install(self) -> None:
        from repro_torch.core import gp
        from repro_torch.kernels.gp_acquisition import ops
        from repro_torch.kernels.tpe_kde import ops as tpe_ops
        entries = gp.BANK_ENTRY_POINTS
        for name, stage in self.STAGE.items():
            if name in entries:
                entries[name] = self._wrap_entry(name, stage, entries[name])
        score_cov = ops.score_cov
        tpe_scores = tpe_ops.tpe_scores

        def capture_scores(*a, **k):
            mu, sig2, K = score_cov(*a, **k)
            if self.capture is not None:
                self.capture["scores"].append((mu.clone(), sig2.clone()))
            return mu, sig2, K

        def capture_tpe_scores(*a, **k):
            score = tpe_scores(*a, **k)
            if self.capture is not None:
                self.capture["tpe_scores"].append(score.clone())
            return score

        ops.score_cov = capture_scores
        tpe_ops.tpe_scores = capture_tpe_scores
        self._undo.append(lambda: setattr(ops, "score_cov", score_cov))
        self._undo.append(
            lambda: setattr(tpe_ops, "tpe_scores", tpe_scores))

    def _wrap_entry(self, name, stage, fn):
        import torch
        from repro_torch.core import gp

        grab = [(key, pos, kw) for e, key, pos, kw in self.CAPTURE
                if e == name]

        def call(*a, **k):
            if name in self.XS_ARG:
                self.na.append(int(a[self.XS_ARG[name]].shape[1]))
            if name == "fit_hypers_bank":
                self.fits += 1
            if self.capture is not None:
                for key, pos, kw in grab:
                    x = k[kw] if kw in k else a[pos]
                    self.capture[key].append(x.detach().clone())
            if not self.annotate:
                return fn(*a, **k)
            with torch.profiler.record_function(f"pb:bank.{name}"):
                if not self.trace:
                    return fn(*a, **k)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.spans.append((stage, self.round, e0, e1))
                return out

        self._undo.append(
            lambda: gp.BANK_ENTRY_POINTS.__setitem__(name, fn))
        return call

    def uninstall(self) -> None:
        for f in reversed(self._undo):
            f()
        self._undo = []

    def span_ms(self) -> Dict[int, Dict[str, float]]:
        """Milliseconds of each stage's spans by round (synchronizes)."""
        sync(self.device)
        out: Dict[int, Dict[str, float]] = {}
        for stage, rnd, e0, e1 in self.spans:
            by = out.setdefault(rnd, {"fit": 0.0, "pick": 0.0})
            by[stage] += e0.elapsed_time(e1)
        return out


class Recorder:
    """A seeded reservoir of the window's asks for the correctness check,
    half over even and half over odd rounds (in a lock-step mix only one
    parity refits), with what the check needs of each."""

    def __init__(self, k: int, seed: int):
        self.k = max(2, int(k))
        self.rng = np.random.default_rng([seed, 3])
        self.slots: Dict[int, List[dict]] = {0: [], 1: []}
        self.seen = {0: 0, 1: 0}

    def select(self, round_index: int) -> Optional[dict]:
        par = round_index % 2
        cap = self.k // 2 + (self.k % 2 if par == 0 else 0)
        self.seen[par] += 1
        slots = self.slots[par]
        rec = {"round": round_index}
        if len(slots) < cap:
            slots.append(rec)
            return rec
        j = int(self.rng.integers(0, self.seen[par]))
        if j < cap:
            slots[j] = rec
            return rec
        return None

    def asks(self) -> List[dict]:
        return sorted((r for s in self.slots.values() for r in s
                       if "after" in r), key=lambda r: r["round"])


def hypers(led, b: int) -> dict:
    return {"log_ls": led.log_ls[b].copy(), "log_var": float(led.log_var[b]),
            "log_noise": float(led.log_noise[b]),
            "n_fit": int(led.n_fit[b]), "have_fit": int(led.have_fit[b]),
            "y_mean": float(led.y_mean[b]), "y_std": float(led.y_std[b])}


def pick_rows(trials, objective) -> np.ndarray:
    """The encoded rows (B, n, DIM) of one ask's trials."""
    from portbench.fleet import trial_rows
    return objective.encode(trial_rows(trials, objective.NAMES))


def invalid_picks(rows: np.ndarray, n: int) -> int:
    """Trials of one ask whose encoded rows are out of the unit cube, not
    finite, missing or repeated within their study."""
    bad = 0
    for r in rows:
        if len(r) != n:
            bad += n
            continue
        ok = np.isfinite(r).all(-1) & (r >= 0).all(-1) & (r <= 1).all(-1)
        bad += int((~ok).sum()) + n - len({tuple(x) for x in r})
    return bad


# ------------------------------------------------------------------ a run
def run_cell(files: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log: Callable[[str], None],
             bench: Optional[dict] = None, workload: str = "",
             judge_precisions=("float64",), pb: Path = PB) -> dict:
    """Set up, measure for ``seconds``, judge, and return the result
    object (without the JAX check, which the caller makes last)."""
    import torch
    from portbench.fleet import Fleet
    cfg = bank_config(files["config"])
    traffic, objective = files["traffic"], files["objective"]
    n = cfg["batch_size"]
    is_cuda = str(device).startswith("cuda")
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    bank = make_bank(cfg, objective, seed, device)
    fleet = Fleet(bank, traffic, n, seed, objective)
    fleet.load(seed + 1)
    fleet.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: {cfg['n_studies']} studies, starts "
        f"{int(fleet.sizes.min())}-{int(fleet.sizes.max())} observations, "
        f"{int(fleet.lag.sum())} lagging, {cfg['mc_samples']} candidates")

    probe = Probe(device, trace)
    probe.install()
    recorder = Recorder(traffic["judge_asks"], seed)
    asks: List[dict] = []
    told = failed = 0
    prof = None
    prof_rounds = int(traffic.get("profile_rounds", 0)) if trace else 0
    prof_first = 1
    prof_t = [None, None]
    if trace:
        _annotate_draws(bank)
    t_w0 = time.perf_counter()
    deadline = t_w0 + float(seconds)
    rnd = 0
    while rnd == 0 or time.perf_counter() < deadline:
        if trace and rnd == prof_first and prof_rounds:
            sync(device)
            prof = _start_profiler(is_cuda)
            prof_t[0] = time.perf_counter()
        rec = recorder.select(rnd)
        probe.round = rnd
        led = bank.ledger
        before_fit = led.n_fit.copy()
        k_obs = fleet.n_obs.copy()
        if rec is not None:
            rec["obs"] = [r.view() for r in fleet.records]
            rec["before"] = [hypers(led, b) for b in range(bank.n_studies)]
            probe.capture = {k: [] for k in probe.KEYS}
        na0 = len(probe.na)
        sync(device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("pb:ask_all"):
            trials = fleet.ask()
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        rows = pick_rows(trials, objective)
        failed += invalid_picks(rows, n)
        due = led.n_fit != before_fit
        asks.append({"ms": ms, "k_obs": k_obs, "due": due,
                     "na": probe.na[na0:], "round": rnd})
        if rec is not None:
            rec["after"] = [hypers(led, b) for b in range(bank.n_studies)]
            rec["picks"] = rows
            cap, probe.capture = probe.capture, None
            sc = cap["scores"]
            rec["scores"] = (torch.cat([c[0] for c in sc]),
                             torch.cat([c[1] for c in sc])) if sc else None
            for key in ("C", "u", "tpe_scores"):
                rec[key] = torch.cat(cap[key]) if cap[key] else None
        with torch.profiler.record_function("pb:evaluate_tell"):
            told += fleet.tell(trials)
        with torch.profiler.record_function("pb:restore"):
            fleet.restore_due()
        rnd += 1
        if prof is not None and rnd == prof_first + prof_rounds:
            sync(device)
            prof_t[1] = time.perf_counter()
            prof.stop()
    sync(device)
    t_end = time.perf_counter()
    if prof is not None and prof_t[1] is None:
        prof_t[1] = time.perf_counter()
        prof.stop()
    window_s = t_end - t_w0
    spans = probe.span_ms() if probe.trace else None
    probe.uninstall()
    peak = int(torch.cuda.max_memory_allocated()) if is_cuda else 0
    nas = sorted({x for a in asks for x in a["na"]})
    log(f"[window] {len(asks)} asks in {window_s:.3f} s, {told} trials, "
        f"{fleet.restores} restores, na {nas}, fits {probe.fits}")

    # the program's state goes before the reference runs
    draw = _draw_ms(bank, cfg, seed) if trace else None
    del bank, fleet, trials
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    checks = judge(recorder.asks(), cfg, files, device, asks, failed,
                   judge_precisions)
    limits = files["limits"]
    compared = {}
    correct = True
    for name, lim in limits.items():
        value = checks["values"].get(name)
        compared[name] = {"value": value, "limit": lim}
        if value is None or not value <= lim:
            correct = False
    if not limits:
        correct = False
    result = {"correct": correct, "attempted": len(asks) * cfg["n_studies"]
              * n, "failed": failed}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    ctx = {"cfg": cfg, "asks": asks, "window_s": window_s, "told": told,
           "setup_s": setup_s, "spans": spans, "draw_ms": draw,
           "workload": workload}
    p = ctx["profile"] = (_reduce_profile(prof, prof_t, asks, prof_first,
                                          prof_rounds) if prof else None)
    if p is not None:
        dev["busy_s"] = p["busy_s"]
        dev["window_s"] = p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    entries = (metric_entries(bench, workload) if trace
               else end_to_end_entries(bench, workload))
    metrics = {}
    for m in entries:
        v = reader(m["name"], pb)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["readings"] = checks["readings"]
    result["check"] = compared
    return result


def judge(recorded: List[dict], cfg: dict, files: dict, device,
          asks: List[dict], failed: int, precisions) -> dict:
    """Every number the check can compare (``values``) and, for each
    reading, its count and largest value (``readings``), over the judged
    asks.  ``na_changes`` counts the buckets past the first and every ask
    in which no pick recorded its bucket.  Beside the thirteen numbers every
    reference gives, a reference's ``NUMBERS`` adds each reading it names,
    its largest value (``max``) or its sum (``sum``)."""
    reference, objective = files["reference"], files["objective"]
    readings: Dict[str, List[float]] = {}
    for rec in recorded:
        for k, v in reference.judge_ask(
                rec, cfg, device, objective.candidate_cdf, precisions,
                cdf_left=objective.candidate_cdf_left).items():
            readings.setdefault(k, []).extend(float(x) for x in v)
    repeats = reference.repeated_blocks(
        [r["C"] for r in recorded if r.get("C") is not None])
    nas = {x for a in asks for x in a["na"]}
    unseen = sum(1 for a in asks if not a["na"])

    def worst(name):
        """The largest reading, None without one or with one not finite."""
        v = readings.get(name)
        return max(v) if v and all(math.isfinite(x) for x in v) else None

    values = {
        "fit_gap": worst("fit_gap"),
        "std_gap": worst("std_gap"),
        "mu_gap": worst("mu_gap"),
        "sig2_gap": worst("sig2_gap"),
        "pick_gap": worst("pick_gap"),
        "picks_outside_top_set": float(sum(
            g > 0 for g in readings.get("top_set_gap", []))),
        "head_mismatches": float(sum(readings.get("head_mismatch", []))),
        "candidate_ks": worst("candidate_ks"),
        "candidate_faults": float(
            sum(readings.get("candidate_faults", [])) + repeats),
        "missing_picks": float(sum(readings.get("missing_picks", []))),
        "schedule_faults": float(sum(readings.get("schedule_faults", []))),
        "na_changes": float(max(len(nas) - 1, 0) + unseen),
        "invalid_trials": float(failed),
    }
    for name, how in getattr(reference, "NUMBERS", {}).items():
        if name not in values:
            values[name] = (worst(name) if how == "max" else
                            float(sum(readings.get(name, []))))
    summary = {k: {"n": len(v), "max": worst(k), "sum": float(sum(v))}
               for k, v in readings.items()}
    return {"values": values, "readings": summary}


# --------------------------------------------------------------- tracing
def _annotate_draws(bank) -> None:
    """Host annotations around the bank's candidate draw (traced runs)."""
    import torch
    space = bank.space
    for name in ("sample_columns", "encode_columns"):
        fn = getattr(space, name)

        def call(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function(f"pb:draw.{_name}"):
                return _fn(*a, **k)

        setattr(space, name, call)


def _start_profiler(is_cuda: bool):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if is_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _reduce_profile(prof, prof_t, asks, first, rounds) -> dict:
    from portbench import trace as tr
    dev, host = tr.events(prof)
    window = prof_t[1] - prof_t[0]
    prof_asks = [a for a in asks if first <= a["round"] < first + rounds]
    t_from = min((h.start for h in host), default=0.0)
    return {"window_s": window, "busy_s": tr.busy_s(dev), "dev": dev,
            "asks": prof_asks, "device_ops": tr.top_ops(dev),
            "idle_gaps": tr.idle_gaps(dev, host, t_from, t_from + window)}


def _draw_ms(bank, cfg: dict, seed: int, reps: int = 5) -> List[float]:
    """The host candidate draw of one ask (``sample_columns`` and
    ``encode_columns`` of B x S rows) timed alone, from a stream of its
    own."""
    rng = np.random.default_rng([seed, 4])
    N = cfg["n_studies"] * cfg["mc_samples"]
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cols = bank.space.sample_columns(N, rng)
        bank.space.encode_columns(cols, N)
        out.append((time.perf_counter() - t0) * 1e3)
    return out
