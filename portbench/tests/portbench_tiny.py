"""A cell of ``BENCHMARK.json`` shrunk to a size the CPU runs in seconds,
for the benchmark's own tests: 4 studies, 300 candidates, histories of
24-40 observations restored at 52 (the 64-row bucket).  The TPE fleet,
whose configuration, limits and reference are in the benchmark but which no
cell of ``BENCHMARK.json`` lists yet, runs here as the cell ``tpe.h6.long``.
The test objective ``mixed_kinds`` (every kind of parameter) runs as the
cells of ``MIXED`` (configurations in ``tests/configs/``) under the limits
of the Hartmann-6 cell of the same optimizer, at ``TINY_MIXED``'s
candidates: a one-hot column of k choices needs sqrt(S) / k above the
``candidate_ks`` limit for a lost choice to show."""
import copy
import json
import sys
import time

from portbench import harness

TINY_CONFIG = {"n_studies": 4, "mc_samples": 300}
TINY_TRAFFIC = {"start_obs": {"low": 24, "high": 40, "multiple": 8},
                "restore_at": 52, "profile_rounds": 2}
TINY_MIXED = {"mc_samples": 2048}
TPE_CELL = "tpe.h6.long"
# test cell: (its configuration's file, the cell whose limits it takes)
MIXED = {"mixed_kinds.gp_bucb": ("mixed-kinds-gp-bucb",
                                 "gp_bucb.long.staggered"),
         "mixed_kinds.clustering": ("mixed-kinds-clustering",
                                    "clustering.long.staggered")}
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


def with_mixed(bench: dict) -> dict:
    """``bench`` with the ``MIXED`` test cells on the staggered mix."""
    bench = copy.deepcopy(bench)
    for cell, (name, _) in MIXED.items():
        bench["configs"].append({
            "name": name, "source": "a test space",
            "file": f"portbench/tests/configs/{name}.json", "reduced": [],
            "why": "every kind of parameter"})
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "long.staggered", "chips": 1,
                                   "why": "every kind of parameter"})
    return bench


def _bench(workload, pb, bench):
    bench = bench or load_bench(pb.parent)
    if workload in MIXED and workload not in {
            w["name"] for w in bench["workloads"]}:
        return with_mixed(bench)
    return bench


def tiny_files(workload: str, pb=harness.PB, bench=None) -> dict:
    bench = _bench(workload, pb, bench)
    files = harness.cell_files(bench, workload, pb)
    files["config"].update(TINY_CONFIG)
    files["traffic"].update(TINY_TRAFFIC)
    if workload in MIXED:
        files["config"].update(TINY_MIXED)
        files["limits"] = harness.cell_files(
            bench, MIXED[workload][1], pb)["limits"]
    return files


def tiny_run(workload: str, seconds: float = 2.0, seed: int = 2 ** 31 + 7,
             trace: bool = False, precisions=("float64",), files=None,
             bench=None, pb=harness.PB) -> dict:
    bench = _bench(workload, pb, bench)
    files = files or tiny_files(workload, pb, bench)
    return harness.run_cell(
        files, seed, seconds, trace, "cpu", time.perf_counter(),
        lambda m: print(m, file=sys.stderr), bench=bench, workload=workload,
        judge_precisions=precisions, pb=pb)
