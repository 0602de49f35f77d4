"""Plain reference of the tuner's GP ask, in PyTorch, and the judge of the
program's asks.

Written from the published method (Mango, arXiv:2005.11394 §2; GP-BUCB,
Desautels et al. 2014; clustering, Groves & Pyzer-Knapp 2018) and the
ask contract the port documents: a Matern-5/2 ARD kernel on the encoded
unit cube, hyperparameters by 40 Adam steps (lr 0.08, betas 0.9 / 0.999,
eps 1e-8, log-lengthscales clipped to [log 0.01, log 10]) on the
per-observation negative log marginal likelihood, a frozen standardization
of y over the observations of the last fit, noise ``exp(log_noise) +
1e-5``, a diagonal jitter ``1e-6 * max(var, 1)``, the predictive variance
``var + noise - k^T K^-1 k`` floored at 1e-10, the UCB weight ``beta(t) =
clip(2 log(max(D, 2) t^2 pi^2 / 0.6), 1, 100)`` at ``t`` = observations
plus slot, and GP-BUCB's hallucination at the posterior mean (the mean
stays, the variance contracts by the new point).

It imports nothing of the program and takes none of its derived state:
the observations are the ones the harness told, and every factor is
computed here.  The candidates and the clustering head's uniforms are the
ask's random inputs: the harness captures the block the timed ask scored
and the uniforms its head drew from, the picks are judged against that
block, and the block is held to the space's distribution by itself
(``candidate_ks``, ``repeated_blocks``).  The program's hyperparameters
are an output of its fit stage: ``fit_gaps`` judges them against this
module's own fit from the same warm start, and the pick stage is then
judged under them.  The clustering head is judged one stage at a time:
its input, the scores, against this module's (``score_gaps``,
``top_set_gaps``), and the head itself by running it again
(``cluster_head``, in float64) on the program's scores (see PERF.md, "How
correct is decided").

``precision="float64"`` is the reference; ``"tf32"`` is the control: the
same computation in float32 with the scorer's products ``K alpha`` and
``K L^-T`` in plain TF32 (the port's kernel keeps them at float32
accuracy, ``K L^-T`` in split TF32, three TF32 products for each float32
one), and the fit's matrix products in TF32; on the card through
PyTorch's TF32 switch, and on the CPU by rounding the scorer's operands
to TF32 (the fit stays in float32 there).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

SQRT5 = math.sqrt(5.0)
LOG_LS_MIN, LOG_LS_MAX = math.log(0.01), math.log(10.0)
ADAM = dict(lr=0.08, b1=0.9, b2=0.999, eps=1e-8)
NOISE_FLOOR = 1e-5
JITTER = 1e-6
VAR_FLOOR = 1e-10
ROW_BLOCK = 4096      # candidate rows per block
HEAD_MARGIN = 1e-5    # seeding margin below which a head is a near-tie
OPTIMIZERS = ("bayesian", "clustering")   # the asks judge_ask judges


# ---------------------------------------------------------------- candidates
def candidate_ks(C: torch.Tensor, cdf, cdf_left=None) -> torch.Tensor:
    """Kolmogorov's statistic, sqrt(S) times the Kolmogorov-Smirnov
    distance, of each column of each study's candidate block C (B, S, d)
    from the distribution whose CDF ``cdf`` gives: (B, d).  Scaled so, its
    spread under a sound draw does not depend on S.

    Each column is sorted raw, and the empirical CDF is compared with F(x)
    above each point and with its left limit F(x-) (``cdf_left``; ``cdf``
    where not given, as for a continuous column) below it: on a column
    with atoms (a one-hot, an ordinal, an imputed child) this is the exact
    distance, where F(x) on both sides would read a tie's jump as a gap."""
    x = torch.sort(C.to(torch.float64), dim=1).values
    F = cdf(x)
    F_left = F if cdf_left is None else cdf_left(x)
    S = x.shape[1]
    i = torch.arange(1, S + 1, dtype=torch.float64, device=x.device)
    above = (i / S)[None, :, None] - F
    below = F_left - ((i - 1) / S)[None, :, None]
    return math.sqrt(S) * torch.maximum(above.amax(1), below.amax(1))


def repeated_blocks(blocks: Sequence[torch.Tensor]) -> int:
    """Studies' candidate blocks (each (B, S, d), one per judged ask) that
    repeat one seen before, in the same ask or an earlier one."""
    seen, rep = set(), 0
    for C in blocks:
        for b in range(C.shape[0]):
            key = C[b].cpu().numpy().tobytes()
            rep += key in seen
            seen.add(key)
    return rep


# ------------------------------------------------------------------ numerics
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties away from 0)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class Precision:
    """The dtype of one side and the rule of its scorer products K alpha
    and K L^-T: ``float64`` (the reference), or ``tf32`` (the control:
    float32 with those products in TF32, the step the ask contract
    forbids)."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name != "tf32":
            return a @ b
        if a.device.type != "cuda":
            return round_tf32(a) @ round_tf32(b)
        with tf32(True):
            return a @ b


@contextlib.contextmanager
def tf32(enabled: bool):
    """PyTorch's TF32 switches for matrix products, set within the block."""
    m = torch.backends.cuda.matmul
    old = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def matern52(A: torch.Tensor, B: torch.Tensor, var):
    """Matern-5/2 between lengthscale-divided rows A (n, d), B (m, d)."""
    d2 = ((A * A).sum(-1)[:, None] + (B * B).sum(-1)[None, :]
          - 2.0 * (A @ B.T))
    d2 = torch.clamp(d2, min=1e-12)
    s = SQRT5 * torch.sqrt(d2)
    return var * (1.0 + s + (5.0 / 3.0) * d2) * torch.exp(-s)


def adaptive_beta(t: float, domain_size: float) -> float:
    t = max(float(t), 1.0)
    b = 2.0 * math.log(max(domain_size, 2.0) * t * t * math.pi ** 2 / 0.6)
    return min(max(b, 1.0), 100.0)


def standardization(y: np.ndarray):
    """(mean, std + 1e-6) of the float32 values of y, in float64."""
    v = np.asarray(y, np.float32).astype(np.float64)
    return float(v.mean()), float(v.std()) + 1e-6


class GP:
    """One study's GP at given log-hyperparameters: X (n, d) on the unit
    cube, y (n,) raw values (maximized), the standardization (ym, ys)."""

    def __init__(self, X, y, log_ls, log_var, log_noise, ym, ys,
                 prec: Precision, device):
        dt = prec.dtype
        self.prec, self.device = prec, device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        self.ls = torch.exp(t(log_ls))
        self.var = torch.exp(t(log_var))
        self.noise = torch.exp(t(log_noise)) + NOISE_FLOOR
        self.c = self.var + self.noise + JITTER * torch.clamp(self.var,
                                                              min=1.0)
        self.Xs = t(np.asarray(X, np.float32)) / self.ls
        self.n = self.Xs.shape[0]
        z = (t(np.asarray(y, np.float32)) - float(ym)) / float(ys)
        with tf32(False):
            K = matern52(self.Xs, self.Xs, self.var)
            K.diagonal().copy_(self.c.expand(self.n))
            L, info = torch.linalg.cholesky_ex(K)
            self.L = L if int(info) == 0 else torch.full_like(L, math.nan)
            eye = torch.eye(self.n, dtype=dt, device=device)
            self.Linv = torch.linalg.solve_triangular(self.L, eye,
                                                      upper=False)
            self.alpha = self.Linv.T @ (self.Linv @ z)

    def cross(self, C: torch.Tensor) -> torch.Tensor:
        """k(C, X) (S, n) for candidates C (S, d) on the unit cube."""
        return matern52(C / self.ls, self.Xs, self.var)

    def scores(self, C: torch.Tensor):
        """(mu, sig2, V) at candidates C (S, d); V = L^-1 k(X, C) (n, S)."""
        mus, sig2s, Vs = [], [], []
        with tf32(False):
            for i in range(0, C.shape[0], ROW_BLOCK):
                Kc = self.cross(C[i:i + ROW_BLOCK])
                mus.append(self.prec.product(Kc, self.alpha[:, None])[:, 0])
                V = self.prec.product(Kc, self.Linv.T)     # (s, n)
                sig2s.append(torch.clamp(
                    self.var + self.noise - (V * V).sum(-1), min=VAR_FLOOR))
                Vs.append(V.T)
        return torch.cat(mus), torch.cat(sig2s), torch.cat(Vs, dim=1)


# ---------------------------------------------------------------------- fit
def nll(X, z, mask, log_ls, log_var, log_noise):
    """Per-observation -log marginal likelihood of every padded study
    (B, n); padded rows are masked out of the kernel and carry 1 on its
    diagonal."""
    ls, var = torch.exp(log_ls), torch.exp(log_var)
    noise = torch.exp(log_noise) + NOISE_FLOOR
    Xs = X / ls[:, None, :]
    d2 = torch.clamp(((Xs[:, :, None, :] - Xs[:, None, :, :]) ** 2).sum(-1),
                     min=1e-12)
    s = SQRT5 * torch.sqrt(d2)
    K = var[:, None, None] * (1.0 + s + (5.0 / 3.0) * d2) * torch.exp(-s)
    K = K * (mask[:, :, None] * mask[:, None, :])
    diag = torch.where(mask > 0, (var + noise + JITTER * torch.clamp(
        var, min=1.0))[:, None], torch.ones_like(mask))
    K = torch.diagonal_scatter(K, diag, dim1=-2, dim2=-1)
    L = torch.linalg.cholesky(K)
    zm = z * mask
    alpha = torch.cholesky_solve(zm[..., None], L)[..., 0]
    n_eff = mask.sum(-1)
    ll = (-0.5 * (zm * alpha).sum(-1)
          - (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)) * mask).sum(-1)
          - 0.5 * n_eff * math.log(2 * math.pi))
    return -ll / n_eff


def _padded(studies: Sequence[dict], device, dtype):
    n = max(len(s["y"]) for s in studies)
    d = studies[0]["X"].shape[1]
    X = np.zeros((len(studies), n, d))
    z = np.zeros((len(studies), n))
    mask = np.zeros((len(studies), n))
    for i, s in enumerate(studies):
        k = len(s["y"])
        X[i, :k] = np.asarray(s["X"], np.float32)
        z[i, :k] = (np.asarray(s["y"], np.float32) - s["ym"]) / s["ys"]
        mask[i, :k] = 1.0
    t = lambda a: torch.as_tensor(a, device=device, dtype=dtype)  # noqa: E731
    return t(X), t(z), t(mask)


def hyper_tensors(studies, key, device, dtype):
    return torch.as_tensor(np.array([np.asarray(s[key], np.float32)
                                     for s in studies]),
                           device=device).to(dtype)


def fit(studies: Sequence[dict], steps: int, device,
        prec: Precision = Precision("float64")):
    """Adam on the per-observation -log ML of every study from its warm
    start (``start`` log-hypers); returns the fitted (log_ls, log_var,
    log_noise) as float64 numpy arrays.  In ``tf32`` the fit runs in
    float32 with every matrix product in TF32 (on the card; the CPU has
    no TF32 and runs it in float32)."""
    dtype = prec.dtype
    with tf32(prec.name == "tf32"):
        return _fit(studies, steps, device, dtype)


def _fit(studies, steps, device, dtype):
    X, z, mask = _padded(studies, device, dtype)
    params = [hyper_tensors([s["start"] for s in studies], k, device, dtype)
              for k in ("log_ls", "log_var", "log_noise")]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    lr, b1, b2, eps = ADAM["lr"], ADAM["b1"], ADAM["b2"], ADAM["eps"]
    for i in range(steps):
        ps = [p.detach().requires_grad_(True) for p in params]
        grads = torch.autograd.grad(nll(X, z, mask, *ps).sum(), ps)
        t = i + 1
        with torch.no_grad():
            for k, g in enumerate(grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                params[k] = params[k] - lr * (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
            params[0] = torch.clamp(params[0], LOG_LS_MIN, LOG_LS_MAX)
    return [p.detach().cpu().numpy() for p in params]


def nll_at(studies, hypers, device, dtype=torch.float64) -> np.ndarray:
    """Per-observation -log ML of each study at the given log-hypers
    (a list of dicts with log_ls, log_var, log_noise)."""
    X, z, mask = _padded(studies, device, dtype)
    hp = [hyper_tensors(hypers, k, device, dtype)
          for k in ("log_ls", "log_var", "log_noise")]
    with torch.no_grad():
        return nll(X, z, mask, *hp).cpu().numpy()


# -------------------------------------------------------------------- judge
def _as_hypers(fitted) -> List[dict]:
    return [{"log_ls": fitted[0][i], "log_var": fitted[1][i],
             "log_noise": fitted[2][i]} for i in range(len(fitted[0]))]


def fit_gaps(studies: Sequence[dict], steps: int, device,
             control: str = None):
    """For each study the program refit: the per-observation -log ML (float64)
    at the program's fitted log-hypers less that at this module's own fit
    from the same warm start and observations.  Positive when the program's
    fit is worse.  With ``control``, also the gaps of the fit made in that
    precision in the program's place.  Returns (gaps, control gaps)."""
    if not studies:
        return np.zeros(0), np.zeros(0)
    best = nll_at(studies, _as_hypers(fit(studies, steps, device)), device)
    prog = nll_at(studies, [s["fitted"] for s in studies], device) - best
    if control is None:
        return prog, np.zeros(0)
    ctl = fit(studies, steps, device, Precision(control))
    return prog, nll_at(studies, _as_hypers(ctl), device) - best


def pick_indices(C: np.ndarray, picks: np.ndarray) -> np.ndarray:
    """Index of each picked row among the candidates C (S, d), -1 where a
    pick is not a candidate."""
    out = np.full(len(picks), -1, np.int64)
    for j, p in enumerate(picks):
        hit = np.nonzero((C == p[None, :]).all(-1))[0]
        if len(hit):
            out[j] = hit[0]
    return out


def bucb_gaps(gp: GP, mu, sig2, V, C: torch.Tensor, picks: np.ndarray,
              n_obs: int, domain_size: float, judge: GP = None,
              judge_scores=None) -> np.ndarray:
    """GP-BUCB slot by slot along the given picks: at slot s, the UCB at
    ``n_obs + s``, the gap by which pick s lies below the best available
    candidate, then pick s hallucinated (the variance contracts by its
    column of the extended L^-1 k).  ``judge`` (float64) judges the picks
    of ``gp`` (another precision) when given: the gap is then the judge's,
    of the candidate that ``gp`` puts first.  Returns one gap per slot."""
    sides = [(gp, mu, sig2, V)]
    if judge is not None:
        sides.append((judge, *judge_scores))
    state = [[s2.clone(), Vm, []] for _, _, s2, Vm in sides]
    avail = torch.ones(C.shape[0], dtype=torch.bool, device=C.device)
    gaps = []
    for s, p in enumerate(picks):
        w = math.sqrt(adaptive_beta(n_obs + s, domain_size))
        acqs = [torch.where(avail, m + w * torch.sqrt(st[0]), -torch.inf)
                for (_, m, _, _), st in zip(sides, state)]
        a_judge = acqs[-1]
        first = int(torch.argmax(acqs[0])) if judge is not None else p
        gaps.append(float(a_judge.max() - a_judge[first]))
        if s == len(picks) - 1:
            break
        avail[p] = False
        for (g, _, _, _), st in zip(sides, state):
            with tf32(False):
                col = torch.cat([st[1][:, p]] + [r[p:p + 1] for r in st[2]])
                l_nn2 = torch.clamp(g.c - (col * col).sum(),
                                    min=1e-8 * float(g.var + g.noise))
                rows = torch.cat([st[1]] + [r[None] for r in st[2]])
                k_new = matern52(C / g.ls, (C[p] / g.ls)[None], g.var)[:, 0]
                v_new = (k_new - col @ rows) / torch.sqrt(l_nn2)
                st[0] = torch.clamp(st[0] - v_new * v_new, min=VAR_FLOOR)
                st[2].append(v_new)
    return np.array(gaps)


def top_set_gaps(mu, sig2, picks: np.ndarray, n_obs: int,
                 domain_size: float, n_top: int) -> np.ndarray:
    """Clustering: by how much each pick's UCB (at ``n_obs``) lies below the
    ``n_top``-th best, 0 for a pick inside the top set."""
    acq = mu + math.sqrt(adaptive_beta(n_obs, domain_size)) * torch.sqrt(
        sig2)
    thr = torch.topk(acq, n_top).values[-1]
    return np.array([max(0.0, float(thr - acq[p])) for p in picks])


def _choice(p: torch.Tensor, u: float):
    """Index drawn from the weights p (n,) by the uniform u, as Mango's
    k-means draws it (``jax.random.choice``: r = cumsum(p)[-1] * (1 - u),
    the first index whose cumulative weight reaches r), and the draw's
    margin: r's distance from the nearer edge of its interval, as a share
    of the total weight."""
    cum = torch.cumsum(p, 0)
    r = cum[-1] * (1.0 - u)
    idx = min(int(torch.searchsorted(cum, r.reshape(1), side="left")[0]),
              p.shape[0] - 1)
    lo = cum[idx - 1] if idx > 0 else torch.zeros_like(r)
    return idx, float(torch.minimum(cum[idx] - r, r - lo) / cum[-1])


def cluster_head(acq: torch.Tensor, C: torch.Tensor, u: Sequence[float],
                 n_top: int, n: int, iters: int = 10):
    """The clustering head of Groves & Pyzer-Knapp (2018) as Mango runs it,
    in ``acq``'s dtype: keep the ``n_top`` best candidates by ``acq`` (the
    lower index first among equal values), weight each by its value less
    the ``n_top``-th best plus 1e-6, seed ``n`` weighted k-means++ centers
    from the uniforms ``u`` (n,), run ``iters`` weighted Lloyd steps (the
    first center on ties; a cluster left empty keeps its center), and pick
    each cluster's best not yet picked (the best of the rest of the top set
    for a cluster left empty).  Returns (picked candidate indices (n,), the
    smallest seeding margin; see ``_choice``)."""
    dt = acq.dtype
    order = torch.sort(acq, descending=True, stable=True).indices[:n_top]
    vals = acq[order]
    w = vals - vals[-1] + 1e-6
    X = C[order].to(dt)
    i0, margin = _choice(w / torch.clamp(w.sum(), min=1e-9), float(u[0]))
    centers = [X[i0]]
    d2min = ((X - X[i0]) ** 2).sum(-1)
    for i in range(1, n):
        p = d2min * w
        tot = p.sum()
        p = p / tot if tot > 0 else torch.full_like(p, 1.0 / n_top)
        j, m = _choice(p, float(u[i]))
        margin = min(margin, m)
        centers.append(X[j])
        d2min = torch.minimum(d2min, ((X - X[j]) ** 2).sum(-1))
    cen = torch.stack(centers)
    for _ in range(iters):
        a = torch.argmin(((X[:, None, :] - cen[None]) ** 2).sum(-1), -1)
        onehot = torch.nn.functional.one_hot(a, n).to(dt) * w[:, None]
        count = onehot.sum(0)[:, None]
        cen = torch.where(count > 0, (onehot.T @ X)
                          / torch.clamp(count, min=1e-9), cen)
    a = torch.argmin(((X[:, None, :] - cen[None]) ** 2).sum(-1), -1)
    picked = torch.zeros(n_top, dtype=torch.bool, device=acq.device)
    picks = []
    for c in range(n):
        sel = (a == c) & ~picked
        if not bool(sel.any()):
            sel = ~picked
        j = int(torch.argmax(torch.where(sel, vals, -torch.inf)))
        picked[j] = True
        picks.append(int(order[j]))
    return np.array(picks), margin


def head_mismatch(acq: torch.Tensor, C: torch.Tensor, u, picks, n_top: int):
    """The head run again in float64 on a side's acquisition surface
    ``acq`` (S,): 1.0 where its picks are not the side's ``picks`` (as
    sets), 0.0 where they are, None on a near-tie: a seeding draw within
    ``HEAD_MARGIN`` of its interval's edge, or a float32 run of the same
    head picking otherwise."""
    n = len(picks)
    mine, margin = cluster_head(acq.to(torch.float64), C, u, n_top, n)
    twin, _ = cluster_head(acq.to(torch.float32), C.to(torch.float32), u,
                           n_top, n)
    if margin < HEAD_MARGIN or set(twin.tolist()) != set(mine.tolist()):
        return None
    return float(set(mine.tolist()) != set(np.asarray(picks).tolist()))


def score_gaps(mu_p, sig2_p, mu_r, sig2_r, gp: GP) -> Dict[str, float]:
    """Largest gaps of a side's scores from the reference's: the mean in
    units of the standardized y, the variance in units of the prior
    variance (var + noise)."""
    mu_p, sig2_p = mu_p.to(mu_r.dtype), sig2_p.to(mu_r.dtype)
    return {"mu_gap": float((mu_p - mu_r).abs().max()),
            "sig2_gap": float((sig2_p - sig2_r).abs().max()
                              / (gp.var + gp.noise))}


def judge_ask(ask: dict, cfg: dict, device, cdf,
              precisions: Sequence[str] = ("float64",),
              cdf_left=None) -> Dict[str, List]:
    """Readings of one recorded ask (see ``harness.Recorder``) for every
    study: the candidate block's distance from the space's distribution
    (``cdf`` and ``cdf_left``, see ``candidate_ks``), the fit gap of the
    studies that refit, the standardization gap, the score gaps of the
    program's captured scores, and the pick readings: GP-BUCB's slot gaps,
    or the clustering top-set gaps and head mismatches.  With a control
    precision in ``precisions`` its readings on the same asks are added
    under ``control.*``."""
    if cfg["optimizer"] not in OPTIMIZERS:
        raise ValueError(f"no judge for optimizer {cfg['optimizer']!r}")
    clustering = cfg["optimizer"] == "clustering"
    dim, B, S = cfg["dim"], cfg["n_studies"], cfg["mc_samples"]
    n = cfg["batch_size"]
    pick_key = "top_set_gap" if clustering else "pick_gap"
    out: Dict[str, List] = {k: [] for k in (
        "fit_gap", "std_gap", "mu_gap", "sig2_gap", pick_key,
        "missing_picks", "schedule_faults", "candidate_ks",
        "candidate_faults")}
    if clustering:
        out["head_mismatch"], out["head_near_tie"] = [], []
    C_all = ask.get("C")
    if C_all is None or tuple(C_all.shape) != (B, S, dim):
        out["candidate_faults"].append(float(B))
        out["missing_picks"].append(float(B * n))
        return out
    C_all = C_all.to(device)
    ks = candidate_ks(C_all, cdf, cdf_left)
    out["candidate_ks"] = ks.flatten().tolist()
    due = []
    for b in range(B):
        X, y = ask["obs"][b]
        hp = ask["after"][b]
        n_fit = int(hp["n_fit"])
        if not (0 < n_fit <= len(y)) or \
                len(y) - n_fit >= cfg["refit_every"]:
            out["schedule_faults"].append(1.0)
            continue
        ym, ys = standardization(y[:n_fit])
        out["std_gap"].append(max(abs(hp["y_mean"] - ym),
                                  abs(hp["y_std"] - ys)) / ys)
        if hp["n_fit"] != ask["before"][b]["n_fit"] or \
                not ask["before"][b]["have_fit"]:
            due.append({"X": X, "y": y, "ym": ym, "ys": ys,
                        "start": ask["before"][b], "fitted": hp})
    control = next((p for p in precisions if p != "float64"), None)
    gaps, ctl = fit_gaps(due, cfg["fit_steps"], device, control)
    out["fit_gap"] = list(gaps)
    if control is not None:
        out["control.fit_gap"] = list(ctl)
    u_all = ask.get("u")
    for b in range(B):
        X, y = ask["obs"][b]
        hp = ask["after"][b]
        ym, ys = standardization(y[:int(hp["n_fit"])])
        C = C_all[b]
        idx = pick_indices(C.cpu().numpy(), ask["picks"][b])
        if (idx < 0).any() or len(set(idx.tolist())) != n:
            out["missing_picks"].append(float((idx < 0).sum()) or 1.0)
            continue
        sides = {}
        for name in ("float64", *[p for p in precisions
                                  if p != "float64"]):
            prec = Precision(name)
            gp = GP(X, y, hp["log_ls"], hp["log_var"], hp["log_noise"], ym,
                    ys, prec, device)
            sides[name] = (gp, *gp.scores(C.to(prec.dtype)))
        gp, mu, sig2, V = sides["float64"]
        w = math.sqrt(adaptive_beta(len(y), cfg["domain_size"]))
        scores = ask.get("scores")
        if scores is not None:
            mu_p, sig2_p = (x[b].to(device) for x in scores)
            for k, v in score_gaps(mu_p, sig2_p, mu, sig2, gp).items():
                out[k].append(v)
        C64 = C.to(torch.float64)
        if clustering:
            out[pick_key].extend(top_set_gaps(
                mu, sig2, idx, len(y), cfg["domain_size"],
                cfg["n_top"]).tolist())
            if scores is None or u_all is None:
                out["head_mismatch"].append(1.0)
            else:
                u = u_all[b].tolist()
                acq_p = (mu_p.to(torch.float64) + w * torch.sqrt(
                    sig2_p.to(torch.float64)))
                m = head_mismatch(acq_p, C64, u, idx, cfg["n_top"])
                out["head_near_tie"].append(float(m is None))
                if m is not None:
                    out["head_mismatch"].append(m)
        else:
            out[pick_key].extend(bucb_gaps(
                gp, mu, sig2, V, C64, idx, len(y),
                cfg["domain_size"]).tolist())
        for name, (g2, m2, s2, V2) in sides.items():
            if name == "float64":
                continue
            for k, v in score_gaps(m2, s2, mu, sig2, gp).items():
                out.setdefault(f"control.{k}", []).append(v)
            if clustering and u_all is not None:
                first, _ = cluster_head(m2 + w * torch.sqrt(s2),
                                        C.to(m2.dtype), u_all[b].tolist(),
                                        cfg["n_top"], n)
                cg = top_set_gaps(mu, sig2, first, len(y),
                                  cfg["domain_size"], cfg["n_top"])
            elif clustering:
                continue
            else:
                cg = bucb_gaps(g2, m2, s2, V2, C.to(g2.prec.dtype), idx,
                               len(y), cfg["domain_size"], judge=gp,
                               judge_scores=(mu, sig2, V))
            out.setdefault(f"control.{pick_key}", []).extend(cg.tolist())
    return out
