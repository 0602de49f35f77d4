"""Seeded study histories and the closed ask/tell loop over the objective
a configuration names (``objectives/<objective>.py``).

The seeded histories follow ``chip_smoke.seeded_fleet`` (points and their
objective values), at the sizes a traffic file gives: the objective file's
``history`` draws them as native rows, one value per parameter as the
program's trials carry it, and its ``encode`` gives the rows of ``DIM``
columns the program observes (see ``objectives/neg_hartmann6.py``).  The
states and trials handed to the program hold plain Python values, so
that a state stays JSON-serialisable.

A traffic file (``traffic/<name>.json``) holds the parameters of one mix:

* ``start_obs``: ``low``, ``high`` and ``multiple``: each study starts from a
  history whose length is one of ``n_studies`` sizes spread evenly over
  [low, high] and rounded down to ``multiple``.  Every seed uses the same set
  of sizes, dealt to the studies in a seeded order.
* ``restore_at``: after its tells, a study holding this many observations or
  more is restored to its start (``AskTellOptimizer.load_state_dict``), as a
  tuning service replaces a finished study with a new one.
* ``staggered_share``: the share of studies whose fit schedule runs one
  round behind the rest (``refit_every`` / batch rounds apart).
* ``judge_asks``: how many of the window's asks the correctness check reads.
* ``profile_rounds``: how many rounds a traced run holds under the profiler.

Set-up (``Fleet.warm``) makes two asks: every study fits in the first; the
lagging share then observes ``batch`` more seeded points, every study's
start is captured, and the second ask refits the lagging share only (none
when the share is 0).  From then on the window's rounds keep one of two
fit phases each, because a restored study's cycle, ``(restore_at - start) /
batch`` rounds, is even when the starts are multiples of
``2 * batch`` and ``restore_at`` is ``batch`` past such a multiple.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def start_sizes(traffic: dict, n_studies: int, seed: int) -> np.ndarray:
    """Each study's history length: the mix's fixed set of sizes, dealt in
    an order drawn from ``seed``."""
    s = traffic["start_obs"]
    m = int(s["multiple"])
    sizes = (np.linspace(s["low"], s["high"], n_studies) // m * m)
    rng = np.random.default_rng([seed, 1])
    return rng.permutation(sizes.astype(np.int64))


def lagging(traffic: dict, n_studies: int) -> np.ndarray:
    """Which studies' fit schedule runs one round behind (every other
    study, up to the mix's share)."""
    k = int(round(float(traffic["staggered_share"]) * n_studies))
    lag = np.zeros(n_studies, bool)
    lag[np.arange(n_studies)[::2][:k]] = True
    if lag.sum() < k:
        lag[np.nonzero(~lag)[0][:k - int(lag.sum())]] = True
    return lag


def histories(n_studies: int, length: int, seed: int, objective):
    """Seeded native rows (B, length, len(NAMES)) and their objective
    values."""
    rng = np.random.default_rng([seed, 2])
    X = objective.history(rng, n_studies, length)
    return X, objective.evaluate(X)


def native(x):
    """A parameter value as a plain Python value (a ``Choice``'s dict
    member by member)."""
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: native(v) for k, v in x.items()}
    return x


def params(row, names) -> dict:
    """One native row as a trial's parameters."""
    return dict(zip(names, map(native, row)))


def trial_rows(trials, names) -> np.ndarray:
    """The native rows (B, n, len(names)) of one ask's trials."""
    n = len(trials[0])
    if any(len(ts) != n for ts in trials):
        raise ValueError("the studies returned different numbers of trials")
    rows = np.empty((len(trials), n, len(names)), object)
    for b, ts in enumerate(trials):
        for j, t in enumerate(ts):
            for i, k in enumerate(names):
                rows[b, j, i] = t.params[k]
    return rows


def study_state(X: np.ndarray, y: np.ndarray, study_seed: int,
                names) -> dict:
    """An ``AskTellOptimizer`` state dict holding the observed history
    (X native rows, y) of the parameters ``names`` and a fresh study RNG
    stream."""
    trials = [{"id": i, "params": params(row, names),
               "status": "observed", "value": float(v), "obs_seq": i}
              for i, (row, v) in enumerate(zip(X, y))]
    return {"version": 1, "next_id": len(trials), "ask_count": 0,
            "n_failed": 0, "sign": 1.0, "best_trace": [], "trials": trials,
            "rng_state": np.random.default_rng(study_seed).bit_generator.state,
            "gp": None}


@dataclass
class Record:
    """One study's observations in tell order, as the harness handed them
    to the program (encoded rows, float32, and their values)."""
    X: np.ndarray
    y: np.ndarray
    n: int

    def append(self, rows: np.ndarray, vals: np.ndarray) -> None:
        k = len(rows)
        self.X[self.n:self.n + k] = rows
        self.y[self.n:self.n + k] = vals
        self.n += k

    def view(self):
        return self.X[:self.n].copy(), self.y[:self.n].copy()


class Fleet:
    """The closed loop over one ``StudyBank``: ask every study for
    ``batch`` trials, evaluate them, tell them, restore studies that
    reached ``restore_at``.  ``records`` mirror what the program
    observed."""

    def __init__(self, bank, traffic: dict, batch: int, seed: int,
                 objective):
        self.bank = bank
        self.traffic = traffic
        self.batch = int(batch)
        self.objective = objective
        B = bank.n_studies
        self.sizes = start_sizes(traffic, B, seed)
        self.lag = lagging(traffic, B)
        self.restore_at = int(traffic["restore_at"])
        self.hist_X, self.hist_y = histories(B, int(self.sizes.max()), seed,
                                             objective)
        cap = max(self.restore_at, int(self.sizes.max())) + 2 * self.batch
        self.records = [Record(np.zeros((cap, objective.DIM)),
                               np.zeros(cap), 0) for _ in range(B)]
        self.starts: List[dict] = []
        self.start_records: List[Record] = []
        self.restores = 0
        self.n_obs = np.zeros(B, np.int64)

    def load(self, study_seed0: int) -> None:
        """Every study's seeded history, in bulk through
        ``load_state_dict``; the lagging share holds ``batch`` fewer
        points until after the first ask."""
        for b, v in enumerate(self.bank.studies):
            n = int(self.sizes[b]) - (self.batch if self.lag[b] else 0)
            X, y = self.hist_X[b, :n], self.hist_y[b, :n]
            v.load_state_dict(study_state(X, y, study_seed0 + b,
                                          self.objective.NAMES))
            self.records[b].n = 0
            self.records[b].append(self.objective.encode(X), y)
            self.n_obs[b] = n

    def ask(self):
        return self.bank.ask_all(self.batch)

    def tell(self, trials) -> int:
        """Evaluate every trial of one ask and tell it; returns the count."""
        rows = trial_rows(trials, self.objective.NAMES)
        vals = self.objective.evaluate(rows)
        enc = self.objective.encode(rows)
        for b, ts in enumerate(trials):
            for j, t in enumerate(ts):
                self.bank.tell(b, t.id, float(vals[b, j]))
            self.records[b].append(enc[b], vals[b])
            self.n_obs[b] += len(ts)
        return int(rows.shape[0] * rows.shape[1])

    def restore_due(self) -> int:
        """Restore every study that reached ``restore_at`` to its start."""
        due = np.nonzero(self.n_obs >= self.restore_at)[0]
        for b in due:
            b = int(b)
            self.bank.study(b).load_state_dict(self.starts[b])
            st = self.start_records[b]
            self.records[b].n = 0
            self.records[b].append(st.X[:st.n], st.y[:st.n])
            self.n_obs[b] = st.n
        self.restores += len(due)
        return len(due)

    def warm(self) -> None:
        """Set-up's two asks (see the module docstring)."""
        self.tell(self.ask())
        for b in np.nonzero(self.lag)[0]:
            b = int(b)
            n = int(self.sizes[b])
            X = self.hist_X[b, n - self.batch:n]
            y = self.hist_y[b, n - self.batch:n]
            v = self.bank.study(b)
            for row, val in zip(X, y):
                v.observe_params(params(row, self.objective.NAMES),
                                 float(val))
            self.records[b].append(self.objective.encode(X), y)
            self.n_obs[b] += self.batch
        self.starts = [v.state_dict() for v in self.bank.studies]
        self.start_records = [Record(r.X.copy(), r.y.copy(), r.n)
                              for r in self.records]
        self.tell(self.ask())
