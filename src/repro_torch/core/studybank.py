"""StudyBank: many studies over one array ledger, one batched ask.

The PyTorch counterpart of ``repro.core.studybank`` for the GP-BUCB family
(``bayesian`` / ``hallucination``), clustering, TPE, the random strategy
and the reference strategy (``hallucination_ref``, which asks through its
own view).

  * ``StudyLedger`` holds every study's trial ledger in fixed-capacity numpy
    arrays (encoded X rows, raw y, status, completion order), counters, RNG
    state, GP hyperparameters and fit schedule, and the last Cholesky factors.
    ``AskTellOptimizer`` is a view into one row.
  * ``StudyBank.ask_all`` gathers every device-phase study into
    shape-bucketed tensors (power-of-2 trial capacity) and serves them
    sub-batched per strategy family over one columnar candidate draw.  GP
    rows: ``gp.fit_hypers_bank`` when a refit is due, ``gp.bank_factors``,
    the prescales, ``gp.bank_absorb`` for in-flight trials, and
    ``gp.bank_pick``, whose scoring and downdates run the CUDA kernels on
    the card; their observation stage is cached on the ledger's
    ``obs_stamp``.  Clustering rows share that observation stage and
    differ only in the pick, ``gp.bank_cluster_pick`` (``score_cov``, then
    top set, k-means and one pick per cluster), its k-means seeded from
    host uniforms of ``PRNGKey(ask_count)`` (``core.kmeans``).  TPE rows:
    ``tpe.fused_tpe_propose_bank``, whose scorer is the ``tpe_scores`` CUDA
    kernel.  A bank may mix the families.
  * ``save``/``load`` write and read the same single ``.npz`` (format v2)
    as the JAX package, byte for byte, so a checkpoint moves across.
  * Every ask leaves a record of its stages and counters in
    ``core.telemetry`` (the bank's ``telemetry_id`` marks its records).

Host work (candidate draws, gathers, standardization, registration) is the
reference's numpy code unchanged, so draws and checkpoints are bit-identical
to it; device stages agree with it to float32 tolerance.
"""
from __future__ import annotations

import json
import os
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.sanitizers import to_device, to_host
from repro_torch.core import telemetry
from repro_torch.device import DeviceLike, resolve_device

# trial-status codes (ledger ``status`` array; 0 = empty slot)
S_EMPTY, S_PENDING, S_OBSERVED, S_FAILED = 0, 1, 2, 3

_U64 = np.uint64
_MASK64 = (1 << 64) - 1


def _pow2(n: int) -> int:
    p = 16
    while p < n:
        p *= 2
    return p


# strategy name -> dispatch family.  "gp", "cluster" and "tpe" studies ask
# through the batched device pipeline (each family its own pick; "gp" and
# "cluster" share the observation stage); "random" and "legacy" (the
# reference strategy) studies ask through their own view.
_FAMILY = {
    "bayesian": "gp",
    "hallucination": "gp",
    "clustering": "cluster",
    "tpe": "tpe",
    "random": "random",
    "hallucination_ref": "legacy",
}


def _y_standardization(v: np.ndarray):
    """Frozen-standardization scalars over a signed f32 history: f32 numpy
    mean and ``float(v.std()) + 1e-6``, the reference's exact op sequence,
    so a resumed run standardizes bit-identically."""
    v = np.asarray(v, np.float32)
    if not len(v):
        return np.float32(0.0), np.float32(1.0)
    return np.float32(v.mean()), np.float32(float(v.std()) + 1e-6)


# the one bit-generator the 6-word packed layout below encodes
RNG_KIND = "PCG64"


def pack_rng_state(rng: np.random.Generator) -> np.ndarray:
    """Pack a PCG64 Generator's full state into 6 uint64 words
    (state lo/hi, inc lo/hi, has_uint32, uinteger) for array storage."""
    st = rng.bit_generator.state
    kind = st.get("bit_generator")
    if kind != RNG_KIND:
        raise ValueError(
            f"pack_rng_state only encodes {RNG_KIND} streams; this "
            f"generator is {kind!r} — its state does not fit the 6-word "
            "packed layout (add a new rng_kind to the checkpoint format)")
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array([s & _MASK64, (s >> 64) & _MASK64,
                     inc & _MASK64, (inc >> 64) & _MASK64,
                     st["has_uint32"], st["uinteger"]], dtype=_U64)


def rng_from_state(state: Dict[str, Any]) -> np.random.Generator:
    """Generator rebuilt from a serialized bit-generator state (the seed is
    a placeholder the state overwrite replaces: no OS entropy is drawn)."""
    rng = np.random.default_rng(0)
    rng.bit_generator.state = state
    return rng


def unpack_rng_state(words: np.ndarray) -> np.random.Generator:
    w = [int(x) for x in words]
    return rng_from_state({
        "bit_generator": "PCG64",
        "state": {"state": w[0] | (w[1] << 64), "inc": w[2] | (w[3] << 64)},
        "has_uint32": w[4], "uinteger": w[5]})


class StudyLedger:
    """Array state for ``n_studies`` concurrent studies.

    Trial slot index == trial id (ids are dense).  Capacities grow by
    doubling from 16, bank-wide, so every study shares one bucket shape.
    """

    # field order is the checkpoint contract
    ARRAY_FIELDS = (
        "X", "y", "status", "obs_seq",
        "n_trials", "ask_count", "obs_count", "n_failed",
        "log_ls", "log_var", "log_noise", "have_fit", "n_fit",
        "y_mean", "y_std", "L", "Linv", "rng_state",
    )

    # Monotone observation stamp: bumped by every mutation that can change
    # the observed system (tells, value/order writes, refits, resets, loads)
    # but not by pending-only traffic.  The bank's device cache is keyed on
    # it.  A class attribute, never serialized.
    obs_stamp = 0

    def __init__(self, n_studies: int, dim: int, capacity: int = 16,
                 gp_capacity: int = 16):
        if n_studies < 1:
            raise ValueError("n_studies must be >= 1")
        B, d = int(n_studies), int(dim)
        cap = _pow2(max(16, capacity))
        self.n_studies, self.dim = B, d
        self.X = np.zeros((B, cap, d), np.float32)   # encoded rows by id
        self.y = np.zeros((B, cap), np.float64)      # raw objective values
        self.status = np.zeros((B, cap), np.int8)
        self.obs_seq = np.full((B, cap), -1, np.int32)
        self.n_trials = np.zeros((B,), np.int64)     # == next trial id
        self.ask_count = np.zeros((B,), np.int64)
        self.obs_count = np.zeros((B,), np.int64)
        self.n_failed = np.zeros((B,), np.int64)
        # cold rows carry the cold-fit init values, so a bank fit can always
        # warm-start from these arrays
        self.log_ls = np.full((B, d), np.log(0.5), np.float32)
        self.log_var = np.zeros((B,), np.float32)
        self.log_noise = np.full((B,), np.log(1e-2), np.float32)
        self.have_fit = np.zeros((B,), np.int8)
        self.n_fit = np.zeros((B,), np.int64)
        self.y_mean = np.zeros((B,), np.float32)
        self.y_std = np.ones((B,), np.float32)
        gcap = _pow2(max(16, gp_capacity))
        eye = np.eye(gcap, dtype=np.float32)
        self.L = np.tile(eye, (B, 1, 1))
        self.Linv = np.tile(eye, (B, 1, 1))
        self.rng_state = np.zeros((B, 6), _U64)

    @property
    def capacity(self) -> int:
        return self.X.shape[1]

    @property
    def gp_capacity(self) -> int:
        return self.L.shape[1]

    def ensure_capacity(self, n: int) -> None:
        cap = self.capacity
        if n <= cap:
            return
        new = _pow2(n)
        B, d = self.n_studies, self.dim
        X = np.zeros((B, new, d), np.float32)
        X[:, :cap] = self.X
        y = np.zeros((B, new), np.float64)
        y[:, :cap] = self.y
        status = np.zeros((B, new), np.int8)
        status[:, :cap] = self.status
        obs_seq = np.full((B, new), -1, np.int32)
        obs_seq[:, :cap] = self.obs_seq
        self.X, self.y, self.status, self.obs_seq = X, y, status, obs_seq

    def ensure_gp_capacity(self, n: int) -> None:
        gcap = self.gp_capacity
        if n <= gcap:
            return
        new = _pow2(n)
        B = self.n_studies
        eye = np.eye(new, dtype=np.float32)
        L = np.tile(eye, (B, 1, 1))
        L[:, :gcap, :gcap] = self.L
        Linv = np.tile(eye, (B, 1, 1))
        Linv[:, :gcap, :gcap] = self.Linv
        self.L, self.Linv = L, Linv

    def reset_study(self, b: int) -> None:
        """Clear one study's row back to the cold state (load target)."""
        self.obs_stamp += 1
        self.X[b] = 0.0
        self.y[b] = 0.0
        self.status[b] = S_EMPTY
        self.obs_seq[b] = -1
        self.n_trials[b] = self.ask_count[b] = 0
        self.obs_count[b] = self.n_failed[b] = 0
        self.log_ls[b] = np.log(0.5)
        self.log_var[b] = 0.0
        self.log_noise[b] = np.log(1e-2)
        self.have_fit[b] = 0
        self.n_fit[b] = 0
        self.y_mean[b], self.y_std[b] = 0.0, 1.0
        g = self.gp_capacity
        self.L[b] = np.eye(g, dtype=np.float32)
        self.Linv[b] = np.eye(g, dtype=np.float32)
        self.rng_state[b] = 0

    def n_observed(self) -> np.ndarray:
        return (self.status == S_OBSERVED).sum(axis=1)

    def n_pending(self) -> np.ndarray:
        return (self.status == S_PENDING).sum(axis=1)

    def obs_ids(self, b: int) -> np.ndarray:
        """Observed trial ids of study ``b`` in completion (tell) order."""
        ids = np.nonzero(self.status[b] == S_OBSERVED)[0]
        return ids[np.argsort(self.obs_seq[b, ids], kind="stable")]

    def pending_ids(self, b: int) -> np.ndarray:
        return np.nonzero(self.status[b] == S_PENDING)[0]


class StudyBank:
    """N independent studies over one ``StudyLedger``; one batched device
    pass per ``ask_all`` for every GP study past its random phase.

    Every study shares the parameter space but owns its strategy, RNG
    stream, sign, counters and GP state, so its proposals do not depend on
    its bankmates' values.  ``device`` is where the device stages run:
    ``cuda`` unless the caller passes ``"cpu"``.
    """

    def __init__(self, param_space, n_studies: int, *,
                 optimizer=None, seed: int = 0,
                 sign: float = 1.0, domain_size: Optional[float] = None,
                 mc_samples: Optional[int] = None, fit_steps: int = 40,
                 refit_every: int = 8,
                 strategy_kwargs: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        from repro_torch.core.optimizer import AskTellOptimizer
        from repro_torch.core.spaces import ParamSpace
        self.device = resolve_device(device)
        self.space = (param_space if isinstance(param_space, ParamSpace)
                      else ParamSpace(param_space))
        if optimizer is None:
            optimizer = "bayesian"
        names = (list(optimizer)
                 if isinstance(optimizer, (list, tuple))
                 else [optimizer] * int(n_studies))
        if len(names) != int(n_studies):
            raise ValueError(
                f"optimizer list has {len(names)} entries for "
                f"{n_studies} studies")
        self.strategy_names: List[str] = names
        self.optimizer = (names[0] if len(set(names)) == 1 else "mixed")
        self.mc_samples = mc_samples
        self.fit_steps = fit_steps
        self.refit_every = refit_every
        self.strategy_kwargs = dict(strategy_kwargs or {})
        self.seed = seed
        self.ledger = StudyLedger(n_studies, self.space.dim)
        self._gp_cache = None   # obs_stamp-keyed device state
        self.telemetry_id = telemetry.new_bank_id()   # its asks' records
        # the last op applied through ``apply_op`` (journaled deployments)
        self.op_seq = 0
        self.extra = None       # side-channel meta restored by ``load``
        # bank-wide candidate stream: one flat draw of B*n_mc candidates per
        # ask_all, independent of the per-study streams
        self._rng = np.random.default_rng(seed)
        self.studies: List[AskTellOptimizer] = [
            AskTellOptimizer(self.space, optimizer=names[i],
                             seed=seed + 1 + i, sign=sign,
                             domain_size=domain_size, mc_samples=mc_samples,
                             fit_steps=fit_steps, refit_every=refit_every,
                             strategy_kwargs=strategy_kwargs,
                             ledger=self.ledger, study_index=i,
                             device=self.device)
            for i in range(n_studies)]
        for v in self.studies:
            v._bank = self
        self._members = {i: v for i, v in enumerate(self.studies)}
        self._rebuild_groups()

    @classmethod
    def _wrap_view(cls, view) -> "StudyBank":
        """Bank-of-one engine over an existing view's ledger (what a
        stand-alone ``AskTellOptimizer.ask`` routes through).  Candidates
        come from the view's own RNG stream; the bank stream is unused."""
        bank = object.__new__(cls)
        bank.device = view.device
        bank.space = view.space
        bank.optimizer = view.optimizer
        bank.mc_samples = view.mc_samples
        bank.fit_steps = view.fit_steps
        bank.refit_every = view.refit_every
        bank.strategy_kwargs = dict(view.strategy_kwargs)
        bank.seed = None
        bank.ledger = view._led
        bank._gp_cache = None
        bank.telemetry_id = telemetry.new_bank_id()
        bank.op_seq = 0
        bank.extra = None
        bank._rng = None
        bank.studies = [view]
        bank.strategy_names = [view.optimizer]
        bank._members = {view._b: view}
        bank._rebuild_groups()
        return bank

    def _rebuild_groups(self) -> None:
        """Recompute which rows ask through the device pipeline (and drop
        the device cache, whose row layout depends on them)."""
        fams = {b: _FAMILY[v.optimizer] for b, v in self._members.items()}
        self._fams = fams
        gpr = sorted(b for b, f in fams.items() if f in ("gp", "cluster"))
        self._gp_fam_rows = np.array(gpr, np.int64)
        self._gp_pos = {int(r): i for i, r in enumerate(gpr)}
        bankable = np.zeros(self.ledger.n_studies, bool)
        for b, f in fams.items():
            bankable[b] = f in ("gp", "cluster", "tpe")
        self._bankable = bankable
        self._gp_cache = None

    def set_strategy(self, b: int, name: str) -> None:
        """Switch study ``b``'s strategy; counters and observations stay."""
        from repro_torch.core.strategies import check_strategy
        check_strategy(name)
        b = int(b)
        v = self.studies[b]
        if v.optimizer != name:
            v.optimizer = name
            v._strat = None
            self.strategy_names[b] = name
        self.optimizer = (self.strategy_names[0]
                          if len(set(self.strategy_names)) == 1
                          else "mixed")
        self._rebuild_groups()

    # -------------------------------------------------------------- basics
    @property
    def n_studies(self) -> int:
        return self.ledger.n_studies

    def study(self, i: int):
        return self.studies[i]

    def tell(self, study: int, trial_id: int, value: float):
        return self.studies[study].tell(trial_id, value)

    def tell_failed(self, study: int, trial_id: int):
        return self.studies[study].tell_failed(trial_id)

    # ------------------------------------------------------ journal replay
    def next_op_seq(self) -> int:
        """Sequence number the next journaled operation must carry."""
        return self.op_seq + 1

    def validate_op(self, op: Dict[str, Any]) -> None:
        """Reject a malformed op before it is journaled (no state mutated):
        anything journaled must be guaranteed to apply.  Raises
        ``ValueError``/``KeyError``/``TypeError`` on a bad op."""
        kind = op["op"]
        b = int(op["study"])
        if not 0 <= b < self.n_studies:
            raise ValueError(f"op targets study row {b}, bank holds "
                             f"{self.n_studies}")
        view = self.studies[b]
        if kind == "create":
            float(op.get("sign", 1.0))
            nm = op.get("optimizer")
            if nm is not None:
                from repro_torch.core.strategies import check_strategy
                check_strategy(nm)
        elif kind == "ask":
            if int(op["n"]) < 1:
                raise ValueError("ask(n) requires n >= 1")
        elif kind in ("tell", "tell_failed"):
            tid = int(op["trial_id"])
            if tid not in view._trials:
                raise KeyError(f"unknown trial id {tid!r} "
                               "(tell before ask?)")
            if kind == "tell":
                float(op["value"])
        elif kind == "observe":
            self.space.encode([dict(op["params"])])
            float(op["value"])
        elif kind == "trace":
            pass
        else:
            raise ValueError(f"unknown journal op kind {kind!r}")

    def apply_op(self, op: Dict[str, Any]):
        """Apply one journaled operation (the replay entry point).  ``seq``
        must extend the bank's op sequence by exactly one; a gap or reorder
        raises.  Every proposal is a pure function of the bank state and the
        study's RNG stream, so replaying the ops from a snapshot reproduces
        the same trials; tells replay idempotently."""
        seq = int(op["seq"])
        if seq <= self.op_seq:
            return None     # already contained in the snapshot: skip
        if seq != self.op_seq + 1:
            raise ValueError(
                f"journal op seq {seq} does not extend bank op_seq "
                f"{self.op_seq} (missing or reordered WAL records)")
        kind = op["op"]
        b = int(op["study"])
        if not 0 <= b < self.n_studies:
            raise ValueError(f"journal op targets study row {b}, bank "
                             f"holds {self.n_studies}")
        view = self.studies[b]
        # the seq is consumed even if the apply raises, so a record is never
        # half-committed and replay re-raises at the same point
        try:
            if kind == "create":
                view.sign = float(op.get("sign", 1.0))
                nm = op.get("optimizer")
                if nm is not None:
                    self.set_strategy(b, nm)
                result = view
            elif kind == "ask":
                result = view.ask(int(op["n"]))
            elif kind == "tell":
                result = view.tell_once(int(op["trial_id"]),
                                        float(op["value"]))
            elif kind == "tell_failed":
                result = view.tell_failed_once(int(op["trial_id"]))
            elif kind == "observe":
                result = view.observe_params(dict(op["params"]),
                                             float(op["value"]))
            elif kind == "trace":
                view.snapshot_trace()
                result = None
            else:
                raise ValueError(f"unknown journal op kind {kind!r}")
        finally:
            self.op_seq = seq
        return result

    # ------------------------------------------------------------- ask_all
    def ask_all(self, n: int = 1) -> List[list]:
        """Propose ``n`` new trials for every study.

        Studies still in the random phase (< 2 observations) or with the
        random or reference strategy ask through their own view; every
        other study is served by the batched device pipeline, one pass per
        strategy family.  Returns ``[trials_of_study_0, ...]``.  The ask
        and its stages are recorded as ``core.telemetry`` describes.
        """
        if n < 1:
            raise ValueError("ask_all(n) requires n >= 1")
        with telemetry.root(self.telemetry_id, "ask"):
            return self._ask_all(n)

    def _ask_all(self, n: int) -> List[list]:
        led = self.ledger
        B = led.n_studies
        n_obs = led.n_observed()
        device = (n_obs >= 2) & self._bankable
        out: List[Optional[list]] = [None] * B
        if not device.all():
            with telemetry.span("ask.random"):
                for b in np.nonzero(~device)[0]:
                    out[b] = self.studies[int(b)].ask(n)
        if not device.any():
            return out
        cols, Cflat, n_mc, picked = self._ask_device(n, n_obs, device)
        with telemetry.span("ask.register"):
            self._register(n, cols, Cflat, n_mc, picked, out)
        return out

    def _register(self, n, cols, Cflat, n_mc, picked, out) -> None:
        """The picked configurations and encoded rows of every device-phase
        study into the ledger as pending trials, and their ``Trial``
        objects into ``out``."""
        from repro_torch.core.optimizer import Trial
        led, space = self.ledger, self.space
        picks: Dict[int, tuple] = {}
        for rows, idx in picked:
            flat = (rows[:, None] * n_mc + idx).astype(np.int64)  # (R, n)
            cfgs = space.configs_at(cols, flat.ravel())
            enc = Cflat[flat.ravel()].reshape(len(rows), -1, Cflat.shape[1])
            for i, b in enumerate(rows):
                picks[int(b)] = (cfgs[i * n:(i + 1) * n], enc[i])
        # bulk registration: one fancy-indexed ledger write per field
        dev = np.array(sorted(picks))
        tids0 = led.n_trials[dev].astype(np.int64)
        led.ensure_capacity(int((tids0 + n).max()))
        rows = dev[:, None]
        slot = tids0[:, None] + np.arange(n)[None, :]
        led.X[rows, slot] = np.stack([picks[int(b)][1] for b in dev])
        led.status[rows, slot] = S_PENDING
        led.obs_seq[rows, slot] = -1
        led.n_trials[dev] = tids0 + n
        led.ask_count[dev] += 1
        for i, b in enumerate(dev):
            b = int(b)
            v = self.studies[b]
            trials = []
            for j, p in enumerate(picks[b][0]):
                t = Trial(int(tids0[i]) + j, dict(p), _ledger=led,
                          _study=b)
                v._trials[t.id] = t
                trials.append(t)
            out[b] = trials

    def _ask_device(self, n: int, n_obs: np.ndarray, device: np.ndarray):
        """Per-family sub-batched dispatch over one columnar candidate draw;
        returns ``(cols, Cflat, n_mc, [(rows, idx), ...])``: the draw, its
        encoding, candidates per study, and each family's rows with their
        (R, n) picked candidate indices on the host.  GP rows share the
        cached observation stage; each family pays one pick pass and one
        exit sync."""
        led, space = self.ledger, self.space
        B, d = led.n_studies, led.dim
        k_obs = n_obs.astype(np.int32)
        k_pend = led.n_pending().astype(np.int32)
        pend_cap = max(4, -(-int(k_pend.max()) // 4) * 4)
        na = _pow2(max(16, int(k_obs.max()) + pend_cap + n))
        telemetry.count("na", na)
        n_mc = self.mc_samples or self.space.mc_samples(n)
        with telemetry.span("ask.draw"):
            cols = space.sample_columns(B * n_mc, self._rng)
            Cflat = np.asarray(space.encode_columns(cols, B * n_mc),
                               np.float32)
        C = Cflat.reshape(B, n_mc, d)
        dev = np.nonzero(device)[0]
        picked = []
        for fam in ("gp", "cluster", "tpe"):
            rows = np.array([int(b) for b in dev if self._fams[int(b)] == fam],
                            np.int64)
            if len(rows):
                picked.append((rows, self._pick_family(
                    fam, rows, C[rows], k_obs, k_pend, n, na, pend_cap)))
        return cols, Cflat, n_mc, picked

    def _pick_family(self, fam, rows, C, k_obs, k_pend, n, na, pend_cap):
        """One family's pick for the ``rows`` sub-batch: (R, n) candidate
        indices, brought to the host by the family's one exit."""
        if fam == "tpe":
            with telemetry.span("ask.pick", fam):
                Xd, yraw, _ = self._gather_obs(k_obs[rows], na, rows)
                Pd = self._gather_pend(k_pend[rows], pend_cap, rows)
                return to_host(self._dispatch_tpe(
                    Xd, yraw, Pd, C, k_obs[rows], k_pend[rows], n, na))
        with telemetry.span("ask.obs"):
            cache = self._obs_stage(k_obs, na)
        with telemetry.span("ask.pick", fam):
            return to_host(self._pick_gp(cache, rows, C, k_obs[rows],
                                         k_pend[rows], n, pend_cap, fam))

    def ask_view(self, view, n: int, cols, n_mc: int):
        """Bank-of-one ask: one view's proposal served by the bucketed
        pipeline, with candidates drawn by the view's own RNG stream.
        Returns ``(configs, encoded_rows)`` for ``n`` picks.  Recorded under
        a root ``ask_view`` (``core.telemetry``)."""
        with telemetry.root(self.telemetry_id, "ask_view"):
            led, space = self.ledger, self.space
            b = view._b
            n = min(n, n_mc)
            k_obs = led.n_observed().astype(np.int32)
            k_pend = led.n_pending().astype(np.int32)
            pend_cap = max(4, -(-int(k_pend.max()) // 4) * 4)
            na = _pow2(max(16, int(k_obs.max()) + pend_cap + n))
            telemetry.count("na", na)
            with telemetry.span("ask.draw"):
                Cflat = np.asarray(space.encode_columns(cols, n_mc),
                                   np.float32)
            C = Cflat.reshape(1, n_mc, led.dim)
            rows = np.array([b], np.int64)
            idx = self._pick_family(self._fams[b], rows, C, k_obs, k_pend, n,
                                    na, pend_cap)
            with telemetry.span("ask.register"):
                idx = idx[0].astype(np.int64)
                return space.configs_at(cols, idx), Cflat[idx]

    def _gather_obs(self, k_obs: np.ndarray, na: int, rows: np.ndarray):
        """Masked-rank observation gather at the bucket shape for ``rows``:
        one stable argsort of the completion order (non-observed slots pushed
        past the horizon by a sentinel).  Returns ``(Xd (R, na, d), yraw
        signed (R, na), mask (R, na))``."""
        led = self.ledger
        d, cap = led.dim, led.capacity
        R = len(rows)
        m = min(cap, na)
        status = led.status[rows]
        seq = np.where(status == S_OBSERVED, led.obs_seq[rows],
                       np.iinfo(np.int32).max)
        order = np.argsort(seq, axis=1, kind="stable")[:, :m]
        rr = np.arange(R)[:, None]
        valid = np.arange(m)[None, :] < k_obs[:, None]
        sign = np.array([self._members[int(b)].sign
                         for b in rows])[:, None]
        Xsub, ysub = led.X[rows], led.y[rows]
        Xd = np.zeros((R, na, d), np.float32)
        yraw = np.zeros((R, na), np.float32)     # signed, unstandardized
        mask = np.zeros((R, na), np.float32)
        Xd[:, :m] = np.where(valid[..., None], Xsub[rr, order], 0.0)
        yraw[:, :m] = np.where(valid, sign * ysub[rr, order],
                               0.0).astype(np.float32)
        mask[:, :m] = valid
        return Xd, yraw, mask

    def _gather_pend(self, k_pend: np.ndarray, pend_cap: int,
                     rows: np.ndarray) -> np.ndarray:
        """In-flight rows at the ``pend_cap`` shape (ascending trial id) for
        ``rows``.  Never cached: pending churn happens every ask."""
        led = self.ledger
        d, cap = led.dim, led.capacity
        R = len(rows)
        Pd = np.zeros((R, pend_cap, d), np.float32)
        if int(k_pend.max()):
            status = led.status[rows]
            ids = np.where(status == S_PENDING,
                           np.arange(cap)[None, :], np.iinfo(np.int32).max)
            order = np.argsort(ids, axis=1, kind="stable")[:, :pend_cap]
            rr = np.arange(R)[:, None]
            valid = np.arange(pend_cap)[None, :] < k_pend[:, None]
            Pd[:] = np.where(valid[..., None], led.X[rows][rr, order], 0.0)
        return Pd

    def _tensor(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def _fit_if_due(self, Xd, yraw, mask, ko, rows) -> bool:
        """Count-based fit schedule: (re)fit hypers for every study whose
        observation count advanced ``refit_every`` past its last fit (or
        that never fit), over the whole sub-batch at the bucket shape, and
        write back only the due rows.  Returns True when anything refit
        (the obs stamp was bumped)."""
        led = self.ledger
        ko64 = ko.astype(np.int64)
        due = ((led.have_fit[rows] == 0) |
               (ko64 - led.n_fit[rows] >= self.refit_every))
        # frozen-standardization sanity: a degenerate fit (y_std ~ 1e-6)
        # would blow new values up to ~1e6 standardized; re-tune instead.
        # Checked over everything observed since the last fit, so replay
        # reaches the same decision.
        for i, r in enumerate(rows):
            if due[i] or not led.have_fit[r]:
                continue
            nf, k = int(led.n_fit[r]), int(ko64[i])
            if k > nf:
                zt = (np.abs(yraw[i, nf:k] - led.y_mean[r])
                      / led.y_std[r])
                if zt.size and float(zt.max()) > 1e3:
                    due[i] = True
        due &= ko64 >= 2
        if not due.any():
            return False
        telemetry.count("fit_rows", len(rows))
        telemetry.count("due_rows", int(due.sum()))
        from repro_torch.core import gp as gp_lib
        ym = led.y_mean[rows].copy()
        ys = led.y_std[rows].copy()
        sel = np.nonzero(due)[0]
        for i in sel:
            ym[i], ys[i] = _y_standardization(yraw[i, :int(ko64[i])])
        t = self._tensor
        lls, lv, ln = gp_lib.BANK_ENTRY_POINTS["fit_hypers_bank"](
            t(Xd), t(yraw), t(mask), t(led.log_ls[rows]),
            t(led.log_var[rows]), t(led.log_noise[rows]), t(ym), t(ys),
            steps=self.fit_steps)
        lls, lv, ln = to_host(lls, lv, ln)   # one exit for the hypers
        telemetry.count("fit_steps", self.fit_steps)
        telemetry.count("fit_nonfinite", int(np.count_nonzero(
            ~(np.isfinite(lls).all(-1) & np.isfinite(lv)
              & np.isfinite(ln)))))
        g = np.asarray(rows)[sel]
        led.log_ls[g] = lls[sel]
        led.log_var[g] = lv[sel]
        led.log_noise[g] = ln[sel]
        led.y_mean[g] = ym[sel]
        led.y_std[g] = ys[sel]
        led.n_fit[g] = ko64[sel]
        led.have_fit[g] = 1
        led.obs_stamp += 1    # new hypers/standardization: factors stale
        return True

    def _obs_stage(self, k_obs: np.ndarray, na: int):
        """Observation-dependent stages for every GP row: masked gather, fit
        schedule, frozen standardization, prescale, Cholesky factors and the
        condition estimate.  Cached on ``obs_stamp`` + bucket shape, so the
        ask/tell_failed steady state pays only the candidate stages."""
        led = self.ledger
        gpr = self._gp_fam_rows
        ko = k_obs[gpr]
        signs = tuple(self._members[int(b)].sign for b in gpr)
        key = (led.obs_stamp, na, signs)
        cache = self._gp_cache
        if cache is not None and cache["key"] == key:
            telemetry.count("obs_cache_hits")
            return cache
        from repro_torch.core import gp as gp_lib
        with telemetry.span("ask.obs.gather"):
            Xd, yraw, mask = self._gather_obs(ko, na, gpr)
        with telemetry.span("ask.obs.fit"):
            if self._fit_if_due(Xd, yraw, mask, ko, gpr):
                key = (led.obs_stamp, na, signs)
        with telemetry.span("ask.obs.factors"):
            # frozen standardization, exactly the single-study GP contract
            z = (yraw - led.y_mean[gpr][:, None]) / led.y_std[gpr][:, None]
            z = (z * mask).astype(np.float32)
            ls = np.exp(led.log_ls[gpr]).astype(np.float32)
            var = np.exp(led.log_var[gpr]).astype(np.float32)
            noise = (np.exp(led.log_noise[gpr]) + 1e-5).astype(np.float32)
            t = self._tensor
            Xd_t, mask_t, ls_t = t(Xd), t(mask), t(ls)
            var_t, noise_t = t(var), t(noise)
            entry = gp_lib.BANK_ENTRY_POINTS
            L, Linv, cond = entry["bank_factors"](Xd_t, mask_t, ls_t, var_t,
                                                  noise_t)
            Xs = entry["bank_prescale_X"](Xd_t, ls_t)
            led.ensure_gp_capacity(na)
            mark = telemetry.device_mark(self.device)
            L_host, Linv_host, cond_host = to_host(L, Linv, cond)
        with telemetry.span("ask.obs.copy", since=mark):
            led.L[gpr, :na, :na] = L_host
            led.Linv[gpr, :na, :na] = Linv_host
        cache = self._gp_cache = {
            "key": key, "Xs": Xs, "z": t(z), "mask": mask_t, "L": L,
            "Linv": Linv, "ls": ls_t, "var": var_t, "noise": noise_t,
            "cond": cond_host.astype(np.float64)}
        self._warn_if_ill_conditioned(cache["cond"], gpr)
        return cache

    def _warn_if_ill_conditioned(self, cond: np.ndarray,
                                 gpr: np.ndarray) -> None:
        from repro_torch.core import scoring
        if getattr(self, "_cond_warned", False):
            return
        bad = np.nonzero(cond > scoring.COND_PROXY_WARN)[0]
        if len(bad):
            self._cond_warned = True
            b = int(gpr[bad[0]])
            warnings.warn(
                f"study {b}: GP kernel condition estimate "
                f"{cond[bad[0]]:.2e} exceeds {scoring.COND_PROXY_WARN:.0e};"
                " posterior scores may be unreliable (consider more noise"
                " or fewer near-duplicate observations)", RuntimeWarning)

    def _pick_gp(self, cache, rows, C, ko, kp, n, pend_cap,
                 fam: str = "gp") -> torch.Tensor:
        """Candidate-dependent stages for the ``rows`` sub-batch of family
        ``fam`` ("gp" or "cluster"), sliced out of the shared obs-stage
        cache: prescale-C, pending absorb, and the family's pick (GP-BUCB,
        or the clustering head on the raw candidates ``C``, its top set
        sized from ``strategy_kwargs["top_frac"]``).  Returns (R, n)
        candidate indices on the device."""
        from repro_torch.core import gp as gp_lib
        pos = np.array([self._gp_pos[int(r)] for r in rows])
        full = (len(pos) == len(self._gp_fam_rows)
                and np.array_equal(pos, np.arange(len(pos))))
        sel = None if full else to_device(pos, self.device)
        parts = {k: cache[k] if full else cache[k][sel]
                 for k in ("ls", "var", "noise", "Xs", "z", "mask", "L",
                           "Linv")}
        ls, var, noise = parts["ls"], parts["var"], parts["noise"]
        Xs, z, maskd = parts["Xs"], parts["z"], parts["mask"]
        L, Linv = parts["L"], parts["Linv"]
        # the slot loop appends pick b < n - 1 at row n_obs + n_pending + b
        # and the downdate kernel writes that column of the (S, na) block
        # unchecked, so every such row must exist
        if fam == "gp" and int((ko + kp).max()) + n - 1 > Xs.shape[1]:
            raise ValueError(
                f"bucket na={Xs.shape[1]} has no room for {n} picks after "
                f"{int((ko + kp).max())} observed and pending rows")
        t = self._tensor
        entry = gp_lib.BANK_ENTRY_POINTS
        Cs = entry["bank_prescale_C"](t(C), ls)
        if int(kp.max()):
            Pd = self._gather_pend(kp, pend_cap, rows)
            # the pending counts stay on the host: absorb chooses each
            # slot's rows there and reads nothing back
            Xs, z, maskd, L, Linv = entry["bank_absorb"](
                Xs, z, maskd, L, Linv, t(Pd), kp.astype(np.float32),
                t(ko.astype(np.float32)), ls, var, noise)
        n_eff = t((ko + kp).astype(np.float32))
        dom = t(np.float32(self._members[int(rows[0])].domain_size))
        if fam == "cluster":
            from repro_torch.core.kmeans import kmeans_uniforms
            from repro_torch.core.strategies import n_top_candidates
            S = C.shape[1]
            n_top = n_top_candidates(
                S, n, self.strategy_kwargs.get("top_frac", 0.2))
            u = t(kmeans_uniforms(self.ledger.ask_count[rows], n))
            return entry["bank_cluster_pick"](
                Cs, t(C), Xs, z, maskd, Linv, var, noise, n_eff, dom, u,
                n_top=n_top, batch_size=n)
        return entry["bank_pick"](Cs, Xs, z, maskd, L, Linv, var, noise,
                                  n_eff, dom, batch_size=n)

    def _dispatch_tpe(self, Xd, yraw, Pd, C, k_obs, k_pend, n, na):
        """TPE pick for a sub-batch: lay each study out as observed rows,
        then pending rows, then zeros (the layout the ``tpe_scores`` kernel
        relies on to stop at n_obs + n_pend), and run the fused proposal.
        ``gamma`` and ``pending_penalty`` come from ``strategy_kwargs``."""
        from repro_torch.core import gp as gp_lib
        from repro_torch.kernels.tpe_kde.ops import pad_dims
        d = self.ledger.dim
        R = Xd.shape[0]
        dp = pad_dims(d)
        Xt = np.zeros((R, na, dp), np.float32)
        yt = np.zeros((R, na), np.float32)
        for i in range(R):
            ko, kp = int(k_obs[i]), int(k_pend[i])
            Xt[i, :ko, :d] = Xd[i, :ko]
            yt[i, :ko] = yraw[i, :ko]
            if kp:
                Xt[i, ko:ko + kp, :d] = Pd[i, :kp]
        S = C.shape[1]
        gamma = self.strategy_kwargs.get("gamma", 0.25)
        pending_penalty = self.strategy_kwargs.get("pending_penalty", False)
        kp_eff = k_pend if pending_penalty else np.zeros_like(k_pend)
        meta = np.stack([k_obs.astype(np.float32),
                         kp_eff.astype(np.float32),
                         np.full((R,), S, np.float32),
                         np.full((R,), gamma, np.float32)], axis=1)
        t = self._tensor
        # candidates go up unpadded and gain their zero columns on the device
        Ct = torch.nn.functional.pad(t(C), (0, dp - d)).contiguous()
        return gp_lib.BANK_ENTRY_POINTS["fused_tpe_propose_bank"](
            t(Xt), t(yt), Ct, t(meta), batch_size=n, d_true=d)

    # ---------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, Any]:
        """JSON-able fleet snapshot: the bank candidate stream plus every
        study's v1 single-study snapshot."""
        led = self.ledger
        return {
            "version": 1,
            "kind": "study_bank",
            "n_studies": self.n_studies,
            "rng_state": self._rng.bit_generator.state,
            "strategies": list(self.strategy_names),
            "studies": [v.state_dict() for v in self.studies],
            # the bank fit schedule lives in the ledger
            "gp_bank": [{
                "log_ls": [float(x) for x in led.log_ls[b]],
                "log_var": float(led.log_var[b]),
                "log_noise": float(led.log_noise[b]),
                "have_fit": int(led.have_fit[b]),
                "n_fit": int(led.n_fit[b]),
                "y_mean": float(led.y_mean[b]),
                "y_std": float(led.y_std[b]),
            } for b in range(led.n_studies)],
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if sd.get("kind") != "study_bank":
            raise ValueError("not a study_bank state dict")
        if sd["n_studies"] != self.n_studies:
            raise ValueError(f"bank holds {self.n_studies} studies, "
                             f"snapshot has {sd['n_studies']}")
        self._rng = rng_from_state(sd["rng_state"])
        for b, nm in enumerate(sd.get("strategies", [])):
            self.set_strategy(b, nm)
        for v, s in zip(self.studies, sd["studies"]):
            v.load_state_dict(s)      # resets the ledger row first
        led = self.ledger
        for b, g in enumerate(sd.get("gp_bank", [])):
            led.log_ls[b] = np.asarray(g["log_ls"], np.float32)
            led.log_var[b] = g["log_var"]
            led.log_noise[b] = g["log_noise"]
            led.have_fit[b] = g["have_fit"]
            led.n_fit[b] = g["n_fit"]
            led.y_mean[b] = g["y_mean"]
            led.y_std[b] = g["y_std"]

    def save(self, path, iteration: int = 0, extra=None) -> None:
        """One-write fleet checkpoint: every ledger array plus a JSON meta
        block (params dicts, traces, RNG streams) in one atomically
        replaced ``.npz``, in the JAX package's v2 format.  ``extra`` is a
        JSON side channel stored verbatim (``self.extra`` when omitted)."""
        from repro_torch.core.optimizer import _to_jsonable
        led = self.ledger
        for b, v in enumerate(self.studies):
            led.rng_state[b] = pack_rng_state(v._rng)
        arrays = {f"led_{name}": np.asarray(getattr(led, name))
                  for name in StudyLedger.ARRAY_FIELDS}
        meta = {
            "version": 2,
            "kind": "study_bank",
            "rng_kind": RNG_KIND,
            "iteration": iteration,
            "op_seq": self.op_seq,
            "extra": self.extra if extra is None else extra,
            "n_studies": self.n_studies,
            "dim": led.dim,
            "bank_rng_state": self._rng.bit_generator.state,
            "studies": [{
                "sign": v.sign,
                "strategy": self.strategy_names[b],
                "best_trace": list(v._best_trace),
                "gp": v._gp_export(),
                "params": [_to_jsonable(v._trials[i].params)
                           for i in range(int(led.n_trials[b]))],
            } for b, v in enumerate(self.studies)],
        }
        p = Path(path)
        tmp = p.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            np.savez(fh, meta=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, p)  # atomic: a crash never corrupts the checkpoint

    def load(self, path) -> int:
        """Restore a ``save`` checkpoint (this package's or the JAX
        package's) in place; returns the stored iteration."""
        from repro_torch.core.optimizer import Trial
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "study_bank":
                raise ValueError("not a study_bank checkpoint")
            # checkpoints written before the tag existed are all PCG64
            rng_kind = meta.get("rng_kind", RNG_KIND)
            if rng_kind != RNG_KIND:
                raise ValueError(
                    f"checkpoint packs {rng_kind!r} RNG streams but this "
                    f"build only decodes {RNG_KIND}; the 6-word rng_state "
                    "rows would unpack into a different generator's state")
            if meta["n_studies"] != self.n_studies:
                raise ValueError(
                    f"bank holds {self.n_studies} studies, checkpoint has "
                    f"{meta['n_studies']}")
            arrays = {name: z[f"led_{name}"]
                      for name in StudyLedger.ARRAY_FIELDS}
        led = self.ledger
        for name in StudyLedger.ARRAY_FIELDS:
            setattr(led, name, arrays[name])
        led.obs_stamp += 1   # wholesale array swap: device cache is stale
        self._rng = rng_from_state(meta["bank_rng_state"])
        for b, v in enumerate(self.studies):
            ms = meta["studies"][b]
            nm = ms.get("strategy")
            if nm is not None:     # v2 meta; v1 keeps constructed names
                self.set_strategy(b, nm)
            v.sign = ms["sign"]
            v._best_trace = list(ms["best_trace"])
            v._gp_snapshot = ms["gp"]
            v._strat = None
            v._rng = unpack_rng_state(led.rng_state[b])
            v._trials = {
                tid: Trial(tid, dict(params), _ledger=led, _study=b)
                for tid, params in enumerate(ms["params"])}
        self.op_seq = int(meta.get("op_seq", 0))
        self.extra = meta.get("extra")
        return meta["iteration"]
