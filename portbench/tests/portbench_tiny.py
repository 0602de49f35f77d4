"""A cell of ``BENCHMARK.json`` shrunk to a size the CPU runs in seconds,
for the benchmark's own tests: 4 studies, 300 candidates, histories of
24-40 observations restored at 52 (the 64-row bucket)."""
import sys
import time

from portbench import harness

TINY_CONFIG = {"n_studies": 4, "mc_samples": 300}
TINY_TRAFFIC = {"start_obs": {"low": 24, "high": 40, "multiple": 8},
                "restore_at": 52, "profile_rounds": 2}


def tiny_files(workload: str, pb=harness.PB, bench=None) -> dict:
    bench = bench or harness.load_benchmark(pb.parent)
    files = harness.cell_files(bench, workload, pb)
    files["config"].update(TINY_CONFIG)
    files["traffic"].update(TINY_TRAFFIC)
    return files


def tiny_run(workload: str, seconds: float = 2.0, seed: int = 2 ** 31 + 7,
             trace: bool = False, precisions=("float64",), files=None,
             bench=None, pb=harness.PB) -> dict:
    bench = bench or harness.load_benchmark(pb.parent)
    files = files or tiny_files(workload, pb, bench)
    return harness.run_cell(
        files, seed, seconds, trace, "cpu", time.perf_counter(),
        lambda m: print(m, file=sys.stderr), bench=bench, workload=workload,
        judge_precisions=precisions, pb=pb)
