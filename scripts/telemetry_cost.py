#!/usr/bin/env python3
"""What the ask path's recorder (``repro_torch.core.telemetry``) costs an
ask, on one GPU.

    python3 scripts/telemetry_cost.py [--asks 200] [--replays 5000] \
        [--seed N] [--out FILE]

1. The ask loop of the 16-study GP-BUCB fleet at 760-1000 observations,
   half the studies' fits one round behind (``portbench``'s
   ``gp_bucb.long.staggered`` configuration and mix, driven by its
   ``Fleet``): ``ask_all(4)``, evaluate, tell, restore.  Asks alternate
   between the recorder on and off, ``--asks`` each way; each ask is timed
   on the host clock between two synchronizations.  The medians and
   quartiles of both sides are printed: the recorder's cost is far below
   the asks' own spread, so this shows only that nothing larger moved.
   ``--asks 0`` skips the loop.
2. The recorder's own cost: one ask's spans, counters, crossing tally
   and CUDA event pair replayed with no work inside but the ask's
   crossings on host tensors and the pick's wait on the stream,
   ``--replays`` times with the recorder on and as many off, in turns of
   100; the difference of the two per-replay times is the cost an ask
   pays for its record.

Prints one JSON line (also written to ``--out``).  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
            "n": len(v)}


def replay(bank_id, device, n):
    """One ask's record, as ``StudyBank.ask_all`` writes it, ``n`` times;
    nanoseconds per record.  Inside the spans run only the ask's designed
    crossings, which the recorder's off side pays too: the fleet ask's 3
    exits, 17 uploads and 5 entry calls, on host tensors, and at the
    pick's exit a wait on the stream, as the family's ``to_host`` waits."""
    import numpy as np
    import torch
    from repro_torch.analysis import sanitizers
    from repro_torch.core import telemetry as tm
    sync = (torch.cuda.current_stream(device).synchronize
            if device.type == "cuda" else (lambda: None))
    t, a = torch.zeros(4), np.zeros(4, np.float32)
    entry = sanitizers.EntryPoint(lambda x: x)
    to_host, to_device = sanitizers.to_host, sanitizers.to_device
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tm.root(bank_id, "ask"):
            tm.count("na", 1024)
            with tm.span("ask.draw"):
                pass
            with tm.span("ask.obs"):
                with tm.span("ask.obs.gather"):
                    for _ in range(4):
                        to_device(a, "cpu")
                with tm.span("ask.obs.fit"):
                    tm.count("fit_rows", 16)
                    tm.count("due_rows", 8)
                    for _ in range(5):
                        to_device(a, "cpu")
                    entry(t)
                    to_host(t)
                with tm.span("ask.obs.factors"):
                    for _ in range(5):
                        to_device(a, "cpu")
                    entry(t)
                    entry(t)
                    mark = tm.device_mark(device)
                    to_host(t, t, t)
                with tm.span("ask.obs.copy", since=mark):
                    pass
            with tm.span("ask.pick", "gp"):
                for _ in range(3):
                    to_device(a, "cpu")
                entry(t)
                entry(t)
                sync()
                to_host(t)
            with tm.span("ask.register"):
                pass
    sync()
    return (time.perf_counter_ns() - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/telemetry_cost.py")
    ap.add_argument("--asks", type=int, default=200)
    ap.add_argument("--replays", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 29)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from portbench import harness
    from portbench.fleet import Fleet
    from repro_torch.core import telemetry as tm

    walls = {True: [], False: []}
    if args.asks > 0:
        bench = harness.load_benchmark(ROOT)
        files = harness.cell_files(bench, "gp_bucb.long.staggered")
        cfg = harness.bank_config(files["config"])
        bank = harness.make_bank(cfg, files["objective"], args.seed, "cuda")
        fleet = Fleet(bank, files["traffic"], cfg["batch_size"], args.seed,
                      files["objective"])
        fleet.load(args.seed + 1)
        fleet.warm()
    for k in range(2 * args.asks):
        on = k % 2 == 0
        tm.set_enabled(on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials = fleet.ask()
        torch.cuda.synchronize()
        walls[on].append((time.perf_counter() - t0) * 1e3)
        fleet.tell(trials)
        fleet.restore_due()
    tm.set_enabled(True)

    device = torch.device("cuda")
    bank_id = tm.new_bank_id()
    per = {True: [], False: []}
    replay(bank_id, device, 100)
    for k in range(2 * max(1, args.replays // 100)):
        on = k % 2 == 0
        tm.set_enabled(on)
        per[on].append(replay(bank_id, device, 100))
    tm.set_enabled(True)

    on_us = statistics.median(per[True]) * 1e-3
    off_us = statistics.median(per[False]) * 1e-3
    out = {
        "device": torch.cuda.get_device_name(0),
        "ask_ms_on": quartiles(walls[True]) if args.asks > 0 else None,
        "ask_ms_off": quartiles(walls[False]) if args.asks > 0 else None,
        "record_us_on": on_us, "record_us_off": off_us,
        "record_cost_us": on_us - off_us,
        "record_us_on_quartiles": quartiles([x * 1e-3 for x in per[True]]),
        "record_us_off_quartiles": quartiles([x * 1e-3 for x in per[False]]),
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
