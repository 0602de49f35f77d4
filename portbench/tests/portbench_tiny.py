"""A cell of ``BENCHMARK.json`` shrunk to a size the CPU runs in seconds,
for the benchmark's own tests: 4 studies, 300 candidates, histories of
24-40 observations restored at 52 (the 64-row bucket).  The TPE fleet,
whose configuration, limits and reference are in the benchmark but which no
cell of ``BENCHMARK.json`` lists yet, runs here as the cell ``tpe.h6.long``."""
import copy
import json
import sys
import time

from portbench import harness

TINY_CONFIG = {"n_studies": 4, "mc_samples": 300}
TINY_TRAFFIC = {"start_obs": {"low": 24, "high": 40, "multiple": 8},
                "restore_at": 52, "profile_rounds": 2}
TPE_CELL = "tpe.h6.long"
TPE_CONFIG = "portbench/configs/mango-tpe-h6.json"
# the metrics whose readers find something to read on the TPE path
TPE_METRICS = ("trials_per_s", "launches_per_ask", "draw_ms", "pick_ms",
               "device_idle_pct", "ask_mfu_pct", "ask_draw_ms",
               "pick_wall_ms", "register_ms", "ask_self_ms",
               "d2h_mb_per_ask")


def load_bench(root=harness.ROOT) -> dict:
    """``BENCHMARK.json`` with the TPE cell added where it is not listed:
    its configuration from its file, the lock-step mix, the metrics of
    ``TPE_METRICS`` and ``tpe_scores_roofline``."""
    bench = copy.deepcopy(harness.load_benchmark(root))
    if any(w["name"] == TPE_CELL for w in bench["workloads"]):
        return bench
    cfg = json.loads((root / TPE_CONFIG).read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": TPE_CONFIG, "reduced": [],
                             "why": "the TPE fleet"})
    bench["workloads"].append({"name": TPE_CELL, "config": cfg["name"],
                               "traffic": "long.lockstep", "chips": 1,
                               "why": "the TPE fleet"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in TPE_METRICS:
            m["workloads"].append(TPE_CELL)
    bench["per_layer"].append({
        "name": "tpe_scores_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels (kernels/tpe_kde)",
        "moves": "ask_p90_ms", "workloads": [TPE_CELL]})
    return bench


def tiny_files(workload: str, pb=harness.PB, bench=None) -> dict:
    bench = bench or load_bench(pb.parent)
    files = harness.cell_files(bench, workload, pb)
    files["config"].update(TINY_CONFIG)
    files["traffic"].update(TINY_TRAFFIC)
    return files


def tiny_run(workload: str, seconds: float = 2.0, seed: int = 2 ** 31 + 7,
             trace: bool = False, precisions=("float64",), files=None,
             bench=None, pb=harness.PB) -> dict:
    bench = bench or load_bench(pb.parent)
    files = files or tiny_files(workload, pb, bench)
    return harness.run_cell(
        files, seed, seconds, trace, "cpu", time.perf_counter(),
        lambda m: print(m, file=sys.stderr), bench=bench, workload=workload,
        judge_precisions=precisions, pb=pb)
