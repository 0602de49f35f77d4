#!/usr/bin/env python3
"""Count the CUDA syncs a tree's warm fleet asks pay, by site, on one GPU.

    python3 scripts/sync_survey.py [--tree DIR]

Imports ``repro_torch`` and ``chip_smoke`` from ``DIR`` (default: this
checkout; e.g. ``git archive`` of another commit unpacked under the
git-ignored ``build/``), so two trees can be compared in one chip call,
one process each.  For each family of ``chip_smoke.py`` phase 3's fleet
(64 studies, Hartmann-6, 200 observations, ``ask_all(4)``): GP, TPE with
the pending penalty, clustering, it warms the bank (an ask -> tell round,
then an ask with a batch in flight), then runs one ask after tells and one
ask with a batch in flight under ``torch.cuda.set_sync_debug_mode("warn")``
and prints every sync with the ``repro_torch`` frames that issued it.  A
site whose line reads the device back (``.cpu()``, ``.numpy()``) or
uploads (``torch.as_tensor``, ``torch.tensor``) counts as a designed
crossing, any other as hidden.  The survey sets the mode itself, not
through ``sanitizers.no_transfer``, so crossings through
``sanitizers.to_host`` / ``to_device`` are counted too (as designed), and
both trees' counts compare.  Then it times three asks with a batch in
flight (host clock around synchronized work).

It first prints which single operations sync at all, the basis of lint
rule REPRO-T101's scalar-store check.
"""
from __future__ import annotations

import argparse
import collections
import linecache
import sys
import time
import traceback
import warnings
from pathlib import Path


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="scripts/sync_survey.py")
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    return ap.parse_args(argv)


class Survey:
    """Record every sync warning with its ``repro_torch`` frames."""

    def __init__(self):
        self.sites = collections.Counter()

    def hook(self, message, category, filename, lineno, file=None,
             line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "repro_torch" in f.filename]
        key = (" <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                           for f in frames[-3:][::-1])
               or f"{filename}:{lineno}")
        text = (linecache.getline(frames[-1].filename, frames[-1].lineno)
                if frames else "")
        kind = ("designed" if any(tok in text for tok in (
            ".cpu()", ".numpy()", "as_tensor", "torch.tensor("))
            else "hidden")
        self.sites[(kind, key, text.strip()[:60])] += 1

    def run(self, torch, fn):
        self.sites.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out

    def report(self, tag):
        n = {k: sum(c for (kind, _, _), c in self.sites.items()
                    if kind == k) for k in ("hidden", "designed")}
        print(f"[sync] {tag}: {n['hidden']} hidden syncs, {n['designed']} "
              "designed crossings", flush=True)
        for (kind, key, text), c in self.sites.most_common():
            print(f"[sync]     {c:3d} {kind:8s} {key}  | {text}")
        return n


def primitives(torch, np):
    dev = torch.device("cuda")
    x = torch.ones(8, device=dev)
    idx = torch.tensor([1, 2], device=dev)
    one = torch.ones((), device=dev)
    probes = {
        "torch.as_tensor(numpy array, cuda)":
            lambda: torch.as_tensor(np.ones(3, np.float32), device=dev),
        "x.cpu()": lambda: x.cpu(),
        "torch.nonzero(x > 0)": lambda: torch.nonzero(x > 0),
        "x[idx] (gather)": lambda: x[idx],
        "x[idx] = 1.0 (Python scalar, tensor index)":
            lambda: x.__setitem__(idx, 1.0),
        "x[idx] = one (0-d device tensor)": lambda: x.__setitem__(idx, one),
        "x[2:4] = 1.0 (Python scalar, basic slice)":
            lambda: x.__setitem__(slice(2, 4), 1.0),
        "x[2:4].fill_(1.0)": lambda: x[2:4].fill_(1.0),
        "bool(x.any())": lambda: bool(x.any()),
    }
    s = Survey()
    for tag, fn in probes.items():
        s.run(torch, fn)
        print(f"[sync] primitive {tag}: {sum(s.sites.values())} syncs")


def main(argv=None) -> int:
    args = parse(argv)
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("sync_survey: no CUDA device available", file=sys.stderr)
        return 2
    print(f"[sync] tree {tree}; {cs.card_line()}", flush=True)
    primitives(torch, np)
    dev = torch.device("cuda")
    n = cs.FLEET["batch"]
    s = Survey()
    for fam, kw in (("gp", {}),
                    ("tpe", dict(optimizer="tpe", strategy_kwargs={
                        "pending_penalty": True})),
                    ("cluster", dict(optimizer="clustering"))):
        bank = cs.seeded_fleet(dev, seed=5, **kw)
        cs._tell_all(bank, bank.ask_all(n))
        bank.ask_all(n)                              # left in flight
        cs._tell_all(bank, bank.ask_all(n))          # absorbs them
        for b, v in enumerate(bank.studies):
            for t in v.pending_trials():
                bank.tell(b, t.id, cs.neg_hartmann6(t.params))
        trials = s.run(torch, lambda: bank.ask_all(n))
        s.report(f"{fam} ask after tells")
        cs._tell_all(bank, trials)
        bank.ask_all(n)                              # left in flight
        s.run(torch, lambda: bank.ask_all(n))
        s.report(f"{fam} ask with {n} trials per study in flight")
        walls = []
        for _ in range(3):
            for b, v in enumerate(bank.studies):
                for t in v.pending_trials()[n:]:
                    bank.tell_failed(b, t.id)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bank.ask_all(n)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[sync] {fam} ask_all({n}) with {n} trials per study in "
              "flight, no guard: "
              + ", ".join(f"{w:.2f}" for w in walls) + " ms", flush=True)
        del bank
    return 0


if __name__ == "__main__":
    sys.exit(main())
