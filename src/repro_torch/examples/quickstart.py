"""Quickstart: tune an RBF-kernel classifier, the paper's Listing 2.

The SVM stand-in is a kernel logistic-regression classifier in PyTorch on
the tuner's device: hyperparameters C (inverse regularization) and gamma
(RBF width), the paper's two-parameter space.  A per-trial function and a
scheduler go in the config (``scheduler.make_objective`` wraps it into the
paper's batch objective).

    python -m repro_torch.examples.quickstart [--device cpu]
        [--iterations 10] [--batch 3]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
from scipy.stats import uniform

from repro_torch.core import Tuner, TunerResults, loguniform
from repro_torch.device import resolve_device
from repro_torch.scheduler import SerialScheduler

# --- the paper's Listing 2 space ------------------------------------------
param_space = {
    "C": uniform(0.1, 10),          # scipy.stats distribution
    "gamma": loguniform(-3, 3),     # Mango's log-uniform: 10^[-3, 0]
}


def make_blobs(seed=0, n=240):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [2.2, 1.2], [0.8, 2.4]])
    X = np.concatenate([rng.normal(c, 0.55, size=(n // 3, 2))
                        for c in centers])
    y = np.repeat(np.arange(3), n // 3)
    p = rng.permutation(n)
    return X[p].astype(np.float32), y[p].astype(np.int64)


def rbf_classifier_accuracy(C: float, gamma: float, device) -> float:
    """Kernel logistic regression with an RBF gram matrix, trained by 300
    gradient steps (the gradient written out: softmax minus one-hot, plus
    the RKHS penalty's)."""
    X, Y = make_blobs()
    X = torch.as_tensor(X, device=device)
    Y = torch.as_tensor(Y, device=device)
    X_tr, Y_tr, X_te, Y_te = X[:160], Y[:160], X[160:], Y[160:]
    K = torch.exp(-gamma * torch.cdist(X_tr, X_tr) ** 2)
    K_te = torch.exp(-gamma * torch.cdist(X_te, X_tr) ** 2)
    Yh = torch.nn.functional.one_hot(Y_tr, 3).to(torch.float32)
    n = len(X_tr)
    a = torch.zeros((n, 3), device=device)
    for _ in range(300):   # step bounded by the gram spectral norm
        p = torch.softmax(K @ a, -1)
        grad = K @ (p - Yh) / n + (K @ a) / (C * n)
        a = a - 0.03 * grad
    return float((torch.argmax(K_te @ a, -1) == Y_te).float().mean())


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> TunerResults:
    args = make_parser().parse_args(argv)
    dev = resolve_device(args.device)

    # the paper's Listing 3 trial: one config in, one score out
    def trial(par):
        return rbf_classifier_accuracy(par["C"], par["gamma"], dev)

    tuner = Tuner(param_space, trial,
                  dict(scheduler=SerialScheduler(), optimizer="bayesian",
                       batch_size=args.batch,
                       num_iteration=args.iterations, initial_random=2,
                       seed=0, device=dev))
    result = tuner.maximize()
    print(f"best accuracy: {result.best_objective:.4f}")
    print(f"best params:   C={result.best_params['C']:.3f} "
          f"gamma={result.best_params['gamma']:.5f}")
    print(f"evaluations:   {len(result.objective_values)}")
    return result


if __name__ == "__main__":
    res = main()
    assert res.best_objective > 0.85
