"""End-to-end: Mango tunes the LM trainer (the paper's production use).

The objective is a real training run of the smollm-135m architecture
(reduced width unless ``--full-width``) on the synthetic Markov stream,
through ``repro_torch.launch.train`` on the tuner's device; the tuner
searches learning rate, warmup, weight decay and the remat policy,
dispatched through the thread scheduler with a wall-clock deadline per
batch, so a diverging or hung trial is dropped (the fault-tolerance
contract).  The checkpoint goes to a temporary directory.

    python -m repro_torch.examples.tune_training [--device cpu]
        [--trial-steps 120] [--iterations 5] [--batch 2] [--full-width]
"""
from __future__ import annotations

import argparse
import json
import tempfile
from typing import Optional, Sequence

from scipy.stats import uniform

from repro_torch.core import Tuner, TunerResults, loguniform
from repro_torch.launch import train as train_mod
from repro_torch.scheduler import ThreadScheduler

param_space = {
    "lr": loguniform(-3.7, 2.2),        # 10^-3.7 .. 10^-1.5
    "warmup": range(5, 60),
    "weight_decay": uniform(0.0, 0.3),
    "remat": ["none", "full"],          # system knob: memory/compute trade
}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trial-steps", type=int, default=120)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> TunerResults:
    args = make_parser().parse_args(argv)

    def train_trial(par) -> float:
        targv = [
            "--arch", "smollm-135m",
            "--steps", str(args.trial_steps),
            "--batch", "8", "--seq", "128", "--fp32",
            "--lr", str(par["lr"]),
            "--warmup", str(int(par["warmup"])),
            "--weight-decay", str(par["weight_decay"]),
            "--remat", par["remat"],
            "--device", args.device,
        ]
        if not args.full_width:
            targv.append("--reduced")
        targs = train_mod.make_parser().parse_args(targv)
        targs.verbose = False
        out = train_mod.run(targs)
        # objective: negative mean loss over the last 20 steps (stable tail)
        tail = out["losses"][-20:]
        return -sum(tail) / len(tail)

    sched = ThreadScheduler(n_workers=1, timeout=600)
    with tempfile.TemporaryDirectory() as td:
        tuner = Tuner(param_space, sched.make_objective(train_trial),
                      dict(optimizer="bayesian", batch_size=args.batch,
                           num_iteration=args.iterations, initial_random=2,
                           seed=0, mc_samples=2000, fit_steps=15,
                           checkpoint_path=f"{td}/tune_training_ckpt.json",
                           device=args.device))
        res = tuner.maximize()
    print(json.dumps({
        "best_tail_loss": -res.best_objective,
        "best_params": {k: (float(v) if not isinstance(v, str) else v)
                        for k, v in res.best_params.items()},
        "trials": len(res.objective_values),
    }, indent=2))
    return res


if __name__ == "__main__":
    main()
