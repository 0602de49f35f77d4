"""Faults planted in the program under the harness, for the benchmark's
tests (on the CPU at a tiny fleet) and for ``calibrate.py --fault`` (on
the card at the cell's own size): each breaks one stage of the timed ask
where it is produced, and the check has to come out not correct.

``plant(name, patch)`` installs one; ``patch(obj, attr, value)`` sets an
attribute (``setattr``, or pytest's ``monkeypatch.setattr`` so that the
test undoes it).  The entry points are replaced in
``gp.BANK_ENTRY_POINTS``, the registry the bank calls them through.
``breaks(name, optimizer, space)`` says whether a fault touches the timed
path of a cell of that optimizer and parameter space: a fault of another
family's path, or of a kind of parameter the space does not have, leaves a
cell as it was.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

# the draw's columns scaled by this, so that they cover [0, CUT) only; the
# tests' tiny fleets draw too few candidates to see a smaller cut
CUT = {"card": 0.9, "tiny": 0.5}


def _entries():
    from repro_torch.core import gp
    return gp.BANK_ENTRY_POINTS


def fit_unchanged(patch):
    """The fit returns its warm start: a step that leaves its state as it
    was."""
    def fit(X, y, mask, log_ls, log_var, log_noise, y_mean, y_std, steps):
        return log_ls.clone(), log_var.clone(), log_noise.clone()
    _entries()["fit_hypers_bank"] = fit


def fit_half_batch(patch):
    """The fit's loss over half of each study's observations, its mean taken
    over the rest."""
    inner = _entries()["fit_hypers_bank"]

    def fit(X, y, mask, *a, **k):
        keep = torch.cumsum(mask, -1) <= mask.sum(-1, keepdim=True) / 2
        return inner(X, y, mask * keep, *a, **k)
    _entries()["fit_hypers_bank"] = fit


def scores_half_batch(patch):
    """The scorer serves the first half of the studies; the rest get the
    mean of their scores."""
    from repro_torch.kernels.gp_acquisition import ops
    inner = ops.score_cov

    def score_cov(Cs, *a):
        mu, sig2, K = inner(Cs, *a)
        h = max(1, Cs.shape[0] // 2)
        mu[h:], sig2[h:] = mu[:h].mean(0), sig2[:h].mean(0)
        return mu, sig2, K
    patch(ops, "score_cov", score_cov)


def pick_altered(patch):
    """Every study's first pick replaced by candidate 0 where the pick is
    made."""
    entries = _entries()
    for name in ("bank_pick", "bank_cluster_pick", "fused_tpe_propose_bank"):
        inner = entries[name]

        def pick(*a, _inner=inner, **k):
            idx = _inner(*a, **k).clone()
            idx[:, 0] = torch.where(idx[:, 0] == 0, 1, 0)
            return idx
        entries[name] = pick


def _head(choose):
    """A clustering head that keeps the top set and picks by ``choose``."""
    from repro_torch.core import gp

    def cluster_pick(acq, C, u, n_top, batch_size):
        top_vals, top_idx = gp.top_k(acq, n_top)
        j = choose(acq, C, u, n_top, batch_size, top_vals, top_idx)
        return torch.gather(top_idx, 1, j)
    return cluster_pick


def head_top_n(patch):
    """The clustering head skips k-means: the n best of the top set."""
    from repro_torch.core import gp

    def choose(acq, C, u, n_top, n, vals, idx):
        return torch.arange(n, device=acq.device).expand(acq.shape[0], n)
    patch(gp, "cluster_pick", _head(choose))


def head_one_cluster(patch):
    """k-means puts every point of the top set in one cluster."""
    from repro_torch.core import kmeans

    def one(X, w, u, iters=10):
        return torch.zeros(X.shape[:2], dtype=torch.int64, device=X.device)
    patch(kmeans, "kmeans", one)


def head_worst(patch):
    """The clustering head picks each cluster's worst point of the top set
    in place of its best."""
    from repro_torch.core import gp, kmeans

    def choose(acq, C, u, n_top, n, vals, idx):
        B = acq.shape[0]
        rows = torch.arange(B, device=acq.device)
        w = vals - vals[:, n_top - 1:n_top] + 1e-6
        assign = kmeans.kmeans(C[rows[:, None], idx], w, u)
        picked = torch.zeros((B, n_top), dtype=torch.bool, device=C.device)
        out = torch.zeros((B, n), dtype=torch.int64, device=C.device)
        for c in range(n):
            in_c = (assign == c) & ~picked
            sel = torch.where(in_c.any(-1, keepdim=True), in_c, ~picked)
            j = torch.argmin(torch.where(sel, vals, torch.inf), dim=-1)
            picked[rows, j] = True
            out[:, c] = j
        return out
    patch(gp, "cluster_pick", _head(choose))


def _draw(patch, change):
    """``ParamSpace.sample_columns`` with its columns changed by
    ``change(space, cols)``."""
    from repro_torch.core.spaces import ParamSpace
    inner = ParamSpace.sample_columns

    def sample_columns(self, n, rng):
        return change(self, inner(self, n, rng))
    patch(ParamSpace, "sample_columns", sample_columns)


def _encoding(patch, change):
    """``ParamSpace.encode_columns``, the candidates' encoding, with its
    rows changed by ``change(space, cols, rows)``."""
    from repro_torch.core.spaces import ParamSpace
    inner = ParamSpace.encode_columns

    def encode_columns(self, cols, n):
        return change(self, cols, inner(self, cols, n))
    patch(ParamSpace, "encode_columns", encode_columns)


def candidates_cut(patch, size="card"):
    """The candidate draw covers [0, CUT) of each parameter's range only."""
    cut = CUT[size]
    _draw(patch, lambda space, cols: {k: v * cut for k, v in cols.items()})


def candidates_stale(patch):
    """The candidate draw returns its first block at every ask."""
    first: Dict[int, dict] = {}

    def change(space, cols):
        n = len(next(iter(cols.values())))
        return {k: v.copy() for k, v in first.setdefault(n, cols).items()}
    _draw(patch, change)


def _list_param(space, strings: bool):
    """The first list parameter of the port's ``ParamSpace`` whose choices
    are strings (one-hot) or, with ``strings`` false, positive numbers
    (ordinal), and its first encoded column; (None, None) where it has
    none."""
    col = 0
    for p in space.params:
        if p.kind == "cat" and (not p.numeric if strings else
                                p.numeric and min(p.choices) > 0):
            return p, col
        col += p.dims
    return None, None


def categorical_short(patch):
    """The draw never gives a string list's last choice: the first takes
    its place."""
    def change(space, cols):
        p, _ = _list_param(space, strings=True)
        if p is not None:
            last, first = p.choices[-1], p.choices[0]
            cols[p.name] = [first if v == last else v for v in cols[p.name]]
        return cols
    _draw(patch, change)


def onehot_shifted(patch):
    """A string list's one-hot block written one column to the right
    within its width: the first column never hot, the last choice's bit
    lost."""
    def change(space, cols, rows):
        p, c = _list_param(space, strings=True)
        if p is not None:
            rows[:, c + 1:c + p.dims] = rows[:, c:c + p.dims - 1].copy()
            rows[:, c] = 0.0
        return rows
    _encoding(patch, change)


def ordinal_log_scale(patch):
    """A numeric list encoded on the log scale of its choices in place of
    the linear scale the port documents."""
    def change(space, cols, rows):
        p, c = _list_param(space, strings=False)
        if p is not None:
            lo, hi = np.log(min(p.choices)), np.log(max(p.choices))
            v = np.log(np.asarray(cols[p.name], np.float64))
            rows[:, c] = (v - lo) / (hi - lo)
        return rows
    _encoding(patch, change)


def _tpe_args(change):
    """The bank's TPE entry, its arguments (X, y, C, meta) changed by
    ``change`` before it runs."""
    entries = _entries()
    inner = entries["fused_tpe_propose_bank"]

    def propose(X, y, C, meta, **k):
        return inner(*change(X, y, C, meta), **k)
    entries["fused_tpe_propose_bank"] = propose


def tpe_split_off(patch):
    """The TPE split one row off: the good split takes one row more than
    ``ceil(gamma n)``."""
    def change(X, y, C, meta):
        meta = meta.clone()
        n = meta[:, 0]
        n_good = torch.clamp(torch.ceil(meta[:, 3] * n), min=1.0)
        meta[:, 3] = (n_good + 0.5) / n
        return X, y, C, meta
    _tpe_args(change)


def tpe_obs_stale(patch):
    """The TPE ask scores against the previous ask's observation block: a
    step that keeps its state as it was."""
    last = {}

    def change(X, y, C, meta):
        X0, y0, meta0 = last.get("block", (X, y, meta))
        last["block"] = (X, y, meta)
        return X0, y0, C, meta0
    _tpe_args(change)


def _tpe_scorer(patch, make):
    """``ops.tpe_scores`` replaced by ``make(inner)``."""
    from repro_torch.kernels.tpe_kde import ops
    patch(ops, "tpe_scores", make(ops.tpe_scores))


def tpe_bandwidths_swapped(patch):
    """Each TPE split's rows scored at the other split's bandwidths."""
    def make(inner):
        def tpe_scores(cands, pts, a, wg, wb, scal, n_live, *, d_true):
            def mean_a(w):
                return ((a * w[..., None]).sum(1)
                        / torch.clamp(w.sum(1), min=1.0)[:, None])
            swapped = a.clone()
            swapped[..., :d_true] = torch.where(
                wg[..., None] > 0, mean_a(wb)[:, None, :d_true],
                mean_a(wg)[:, None, :d_true])
            return inner(cands, pts, swapped, wg, wb, scal, n_live,
                         d_true=d_true)
        return tpe_scores
    _tpe_scorer(patch, make)


def tpe_scores_half_batch(patch):
    """The TPE scorer serves the first half of the studies; the rest get the
    mean of their scores."""
    def make(inner):
        def tpe_scores(cands, *a, **k):
            score = inner(cands, *a, **k)
            h = max(1, cands.shape[0] // 2)
            score[h:] = score[:h].mean(0)
            return score
        return tpe_scores
    _tpe_scorer(patch, make)


def tpe_exp_bf16(patch):
    """The TPE scorer with each exponent's argument rounded to bfloat16, a
    precision below the configuration's float32: the kernel's arithmetic in
    plain PyTorch, study by study in blocks of candidates."""
    def tpe_scores(cands, pts, a, wg, wb, scal, n_live, *, d_true):
        B, S, _ = cands.shape
        out = torch.empty((B, S), dtype=torch.float32, device=cands.device)
        for b in range(B):
            n = int(n_live[b])
            X, A = pts[b, :n, :d_true], a[b, :n, :d_true]
            step = max(1, (1 << 24) // max(n * d_true, 1))
            for i in range(0, S, step):
                arg = (cands[b, i:i + step, None, :d_true] - X) ** 2 * A
                E = torch.exp(-arg.to(torch.bfloat16).float())
                dg = (E * wg[b, :n, None]).sum(1) * scal[b, 0] + 1e-12
                db = (E * wb[b, :n, None]).sum(1) * scal[b, 1] + 1e-12
                out[b, i:i + step] = (dg.log() - db.log()).sum(-1)
        return out
    _tpe_scorer(patch, lambda inner: tpe_scores)


FAULTS: Dict[str, Callable] = {
    f.__name__: f for f in (fit_unchanged, fit_half_batch, scores_half_batch,
                            pick_altered, head_top_n, head_one_cluster,
                            head_worst, candidates_cut, candidates_stale,
                            categorical_short, onehot_shifted,
                            ordinal_log_scale, tpe_split_off, tpe_obs_stale,
                            tpe_bandwidths_swapped, tpe_scores_half_batch,
                            tpe_exp_bf16)}
GP = ("bayesian", "clustering")
# the optimizers whose timed path a fault breaks, where not every one's
ONLY = {"fit_unchanged": GP, "fit_half_batch": GP, "scores_half_batch": GP,
        "head_top_n": ("clustering",), "head_one_cluster": ("clustering",),
        "head_worst": ("clustering",), "tpe_split_off": ("tpe",),
        "tpe_obs_stale": ("tpe",), "tpe_bandwidths_swapped": ("tpe",),
        "tpe_scores_half_batch": ("tpe",), "tpe_exp_bf16": ("tpe",)}


# the parameter a fault changes, where a space may have none: a list of
# strings, or a list of positive numbers (see ``_list_param``)
NEEDS = {"categorical_short": "strings", "onehot_shifted": "strings",
         "ordinal_log_scale": "numbers"}


def breaks(name: str, optimizer: str, space: dict) -> bool:
    """Whether the fault ``name`` touches the timed path of a cell of
    ``optimizer`` over ``space`` (the dict the program's bank takes)."""
    if optimizer not in ONLY.get(name, (optimizer,)):
        return False
    if name not in NEEDS:
        return True
    from repro_torch.core.spaces import ParamSpace
    p, _ = _list_param(ParamSpace(space), NEEDS[name] == "strings")
    return p is not None


def plant(name: str, patch=setattr, **kw) -> None:
    FAULTS[name](patch, **kw)
