"""Plain reference of the tuner's TPE ask, in PyTorch, and the judge of the
program's TPE asks.

Written from the Tree-structured Parzen Estimator of Bergstra et al.
("Algorithms for Hyper-Parameter Optimization", NeurIPS 2011) and
Hyperopt's ``tpe.suggest``, as the port's ask contract states the rule:
the observations ranked best first (ties to the earlier told), the best
``max(1, ceil(gamma n))`` of them the good split l and the rest the bad
split g; each split models each encoded dimension j with a Gaussian Parzen
window of bandwidth ``bw_j = base(n_split) * clip(2 std_j, 0.1, 1.0)``,
``base(m) = max(m^(-1/(d+4)), 1e-2) * 0.5 + 1e-3`` (Scott's rule) and
``std_j`` the split's population standard deviation along j; a candidate
c scores ``sum_j [log(dens_l,j(c) + 1e-12) - log(dens_g,j(c) + 1e-12)]``
with ``dens_j(c) = mean_i exp(-(c_j - x_ij)^2 / (2 bw_j^2))`` over the
split's rows; a batch takes the ``batch_size`` best candidates, the lower
index first among equal scores.

Departures from Bergstra et al. and Hyperopt, each the port's own rule:

* Per-dimension windows with no normalizing constant: each dimension's
  density is a mean of unnormalized Gaussian kernels, and a candidate's
  log-density the sum of the dimensions' logs (a product of 1-D
  estimators, not Hyperopt's per-parameter adaptive Parzen mixture).  The
  constant the windows leave out, ``sum_j log(bw_g,j / bw_l,j)``, is the
  same for every candidate of a study, so it moves no ranking.
* Candidates drawn from the space (the ask's uniform block of
  ``mc_samples``), not from l(x) as Hyperopt draws its 24.
* Scott's bandwidth, scaled by each split's spread, in place of
  Hyperopt's adaptive bandwidths (distances to neighbours, with a prior
  component); no prior in either split.
* The top ``batch_size`` by score in place of one sequential
  expected-improvement pick a trial.
* The ``1e-12`` floor under each dimension's density, so that no log sees
  zero.

It imports nothing of the program and takes none of its derived state: the
split, the bandwidths and the densities come from the observations the
harness told (``ask["obs"]``, each study's encoded rows as float32, the
ledger's precision, and its values ranked as float32, the precision the
program ranks them in).  The candidate block is the ask's random input:
the harness captures the block the timed ask scored, the picks and the
captured scores are judged against it, and the block is held to the
space's distribution by itself (``reference.candidate_ks``,
``reference.repeated_blocks``).

``precision="float64"`` is the reference.  The control is ``bfloat16``:
the same computation in float32 with each exponent's argument rounded to
bfloat16, the precision below the configuration's float32 that a faster
exponential would tempt a scorer into.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import (candidate_ks, pick_indices,  # noqa: F401
                                 repeated_blocks)

OPTIMIZERS = ("tpe",)     # the asks judge_ask judges
CONTROL = "bfloat16"      # the control's precision (calibrate.py)
# the numbers of the check this module adds to the harness's thirteen: a
# score's gap is a difference of logs of density ratios, so it reads as
# the ratio's relative error, whatever the ratio's size, and it is what
# the ranking compares
NUMBERS = {"tpe_score_gap": "max", "tpe_pick_gap": "max"}
FLOOR = 1e-12
BLOCK_ELEMS = 1 << 24     # (candidates x rows x dims) a block holds


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("float64", CONTROL):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def split(y: np.ndarray, gamma: float) -> np.ndarray:
    """Rows of the good split: the best ``max(1, ceil(gamma n))`` values of
    y as float32, ties to the earlier row."""
    n = len(y)
    n_good = max(1, math.ceil(gamma * n))
    order = np.argsort(-np.asarray(y, np.float32), kind="stable")
    good = np.zeros(n, bool)
    good[order[:n_good]] = True
    return good


def bandwidth(P: torch.Tensor) -> torch.Tensor:
    """Per-dimension bandwidth (d,) of the split P (m, d): Scott's base at
    m rows times ``clip(2 std_j, 0.1, 1.0)``."""
    m, d = P.shape
    base = max(max(m, 1) ** (-1.0 / (d + 4)), 1e-2) * 0.5 + 1e-3
    std = torch.sqrt(((P - P.mean(0)) ** 2).mean(0))
    return base * torch.clamp(2.0 * std, 0.1, 1.0)


def log_density(C: torch.Tensor, P: torch.Tensor, precision: str):
    """Each candidate's (S,) summed per-dimension log-density under the
    split P (m, d), in blocks of candidates."""
    inv2 = 0.5 / bandwidth(P) ** 2
    m, d = P.shape
    step = max(1, BLOCK_ELEMS // max(m * d, 1))
    out = []
    for i in range(0, C.shape[0], step):
        arg = (C[i:i + step, None, :] - P[None]) ** 2 * inv2
        if precision == CONTROL:
            arg = arg.to(torch.bfloat16).to(arg.dtype)
        dens = torch.exp(-arg).mean(1)
        out.append(torch.log(dens + FLOOR).sum(-1))
    return torch.cat(out)


def scores(C: torch.Tensor, X: np.ndarray, y: np.ndarray, gamma: float,
           precision: str = "float64") -> torch.Tensor:
    """The l/g log-ratio (S,) of candidates C (S, d) given one study's
    observations X (n, d) and values y (n,)."""
    dt = _dtype(precision)
    good = torch.as_tensor(split(y, gamma), device=C.device)
    Xt = torch.as_tensor(np.asarray(X, np.float32), device=C.device).to(dt)
    Ct = C.to(dt)
    return (log_density(Ct, Xt[good], precision)
            - log_density(Ct, Xt[~good], precision))


def pick_gaps(ref: torch.Tensor, picks: np.ndarray) -> np.ndarray:
    """Slot by slot, the reference score of its k-th best candidate less
    that of the side's k-th pick."""
    best = torch.sort(ref, descending=True, stable=True).values[:len(picks)]
    return (best - ref[torch.as_tensor(picks, device=ref.device)]) \
        .cpu().numpy()


def top(score: torch.Tensor, n: int) -> np.ndarray:
    """The n best candidates, the lower index first among equal scores."""
    return torch.sort(score, descending=True, stable=True) \
        .indices[:n].cpu().numpy()


def judge_ask(ask: dict, cfg: dict, device, cdf,
              precisions: Sequence[str] = ("float64",),
              cdf_left=None) -> Dict[str, List]:
    """Readings of one recorded ask (see ``harness.Recorder``) for every
    study: the candidate block's form and distance from the space's
    distribution (``cdf`` and ``cdf_left``), the gap of the program's
    captured scores from this module's, and the pick gaps.  With the
    control in ``precisions`` its readings on the same asks are added under
    ``control.*``."""
    if cfg["optimizer"] not in OPTIMIZERS:
        raise ValueError(f"no judge for optimizer {cfg['optimizer']!r}")
    d, B, S = cfg["dim"], cfg["n_studies"], cfg["mc_samples"]
    n, gamma = cfg["batch_size"], cfg["gamma"]
    out: Dict[str, List] = {k: [] for k in (
        "tpe_score_gap", "tpe_pick_gap", "missing_picks", "candidate_ks",
        "candidate_faults")}
    C_all = ask.get("C")
    if C_all is None or C_all.dim() != 3 or \
            tuple(C_all.shape[:2]) != (B, S) or C_all.shape[2] < d or \
            bool((C_all[..., d:] != 0).any()):
        out["candidate_faults"].append(float(B))
        out["missing_picks"].append(float(B * n))
        return out
    C_all = C_all[..., :d].to(device)
    ks = candidate_ks(C_all, cdf, cdf_left)
    out["candidate_ks"] = ks.flatten().tolist()
    captured = ask.get("tpe_scores")
    controls = [p for p in precisions if p != "float64"]
    for b in range(B):
        X, y = ask["obs"][b]
        C = C_all[b]
        ref = scores(C, X, y, gamma)
        if captured is not None:
            prog = captured[b].to(device=device, dtype=torch.float64)
            out["tpe_score_gap"].append(float((prog - ref).abs().max()))
        idx = pick_indices(C.cpu().numpy(), ask["picks"][b])
        if (idx < 0).any() or len(set(idx.tolist())) != n:
            out["missing_picks"].append(float((idx < 0).sum()) or 1.0)
        else:
            out["tpe_pick_gap"].extend(pick_gaps(ref, idx).tolist())
        for p in controls:
            ctl = scores(C, X, y, gamma, p).to(torch.float64)
            out.setdefault("control.tpe_score_gap", []).append(
                float((ctl - ref).abs().max()))
            out.setdefault("control.tpe_pick_gap", []).extend(
                pick_gaps(ref, top(ctl, n)).tolist())
    return out
