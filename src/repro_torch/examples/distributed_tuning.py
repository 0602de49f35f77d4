"""Distributed tuning with the Celery-style task queue and fault injection.

The paper's production deployment (Listing 4, Kubernetes + Celery): a
task-queue scheduler with a worker pool, a per-batch deadline, injected
worker failures and stragglers.  The tuner observes only the results that
make the deadline: the paper's fault-tolerance contract.

Both tuners drive the same ask/tell core with the same per-trial function;
the sync one takes the scheduler in its config, the async one keeps
``batch_size`` trials in flight (no barrier) and checkpoints after every
completion into a temporary directory.

    python -m repro_torch.examples.distributed_tuning [--device cpu]
        [--iterations 8] [--batch 8] [--evals 40]
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
from scipy.stats import randint, uniform

from repro_torch.core import AsyncTuner, Tuner
from repro_torch.device import resolve_device
from repro_torch.scheduler import FaultInjection, TaskQueueScheduler


# a KNN-like objective (the paper's KNN_Celery.ipynb example): accuracy of
# a k-nearest-neighbour classifier on a noisy two-moon dataset
def make_moons(seed=0, n=400):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n // 2)
    a = np.stack([np.cos(t), np.sin(t)], 1) + rng.normal(0, 0.18, (n // 2, 2))
    b = (np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
         + rng.normal(0, 0.18, (n // 2, 2)))
    X = np.concatenate([a, b])
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(int)
    p = rng.permutation(n)
    return X[p], y[p]


X, Y = make_moons()
X_tr, Y_tr, X_te, Y_te = X[:300], Y[:300], X[300:], Y[300:]


def knn_accuracy(par):
    time.sleep(0.02)  # stands in for an expensive remote job
    k = int(par["n_neighbors"])
    d = np.linalg.norm(X_te[:, None] - X_tr[None], axis=-1)
    idx = np.argsort(d, axis=1)[:, :k]
    if par["weights"] == "distance":
        wts = 1.0 / (np.take_along_axis(d, idx, 1) + 1e-9)
    else:
        wts = np.ones_like(idx, dtype=float)
    votes = np.zeros((len(X_te), 2))
    for c in (0, 1):
        votes[:, c] = np.where(Y_tr[idx] == c, wts, 0).sum(1)
    return float((votes.argmax(1) == Y_te).mean())


param_space = {
    "n_neighbors": randint(1, 60),
    "weights": ["uniform", "distance"],
    "p_jitter": uniform(0, 1),  # inert param: robustness to noise dims
}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--evals", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = make_parser().parse_args(argv)
    dev = resolve_device(args.device)
    # 20% of workers crash, 10% straggle past the 1 s batch deadline
    sched = TaskQueueScheduler(
        n_workers=8, timeout=1.0, max_retries=1,
        faults=FaultInjection(failure_rate=0.2, straggler_rate=0.1,
                              straggler_delay=5.0, seed=1))
    tuner = Tuner(param_space, knn_accuracy,
                  dict(scheduler=sched, optimizer="clustering",
                       batch_size=args.batch, num_iteration=args.iterations,
                       seed=0, device=dev))
    res = tuner.maximize()
    print(f"[sync ] best acc {res.best_objective:.4f} with "
          f"{res.best_params['n_neighbors']} neighbours "
          f"({res.best_params['weights']}); observed "
          f"{len(res.objective_values)} results, "
          f"{res.n_failed} lost to faults/stragglers")
    print(f"[sync ] scheduler stats: {sched.stats}")
    sched.shutdown()

    # async mode: continuous batching, no barrier between batches; the
    # checkpoint (in-flight trials included) would let a killed run resume
    # to identical proposals
    sched2 = TaskQueueScheduler(n_workers=8)
    with tempfile.TemporaryDirectory() as td:
        ares = AsyncTuner(param_space, knn_accuracy, sched2,
                          num_evals=args.evals, batch_size=args.batch,
                          seed=0, checkpoint_path=f"{td}/async_ckpt.json",
                          device=dev).maximize()
    print(f"[async] best acc {ares.best_objective:.4f} after "
          f"{len(ares.objective_values)} evals in "
          f"{ares.wall_time_s:.1f}s ({ares.n_failed} failed)")
    sched2.shutdown()
    return {"sync": res, "async": ares, "stats": dict(sched.stats)}


if __name__ == "__main__":
    out = main()
    assert out["sync"].best_objective > 0.9
