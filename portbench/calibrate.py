"""Readings of the correctness check over many seeds, for setting limits.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --seconds 8 [--fault <name>] [--out readings.jsonl]

For every seed: one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the judge), in one process, so the card's set-up
cost is paid once per seed and not once per process.  Each reading of the
program goes out beside the control's on the same asks: the reference in
the precision its ``CONTROL`` names (TF32 where it names none) put in the
program's place (its scores, and the gap of the candidate it puts first at
each slot, judged in float64).  With ``--fault`` the program runs with
that fault of ``faults.py`` planted, at the cell's own size.  One JSON line
per seed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        faults.plant(args.fault)
    bench = harness.load_benchmark(ROOT)
    files = harness.cell_files(bench, args.workload)
    control = getattr(files["reference"], "CONTROL", "tf32")
    t0 = T_START
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = harness.run_cell(
            files, seed, args.seconds, False, "cuda", t0,
            lambda m: print(m, file=sys.stderr, flush=True), bench=bench,
            workload=args.workload,
            judge_precisions=("float64", control))
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault, "correct": res["correct"],
                           "check": res["check"],
                           "readings": res["readings"],
                           "metrics": res["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
