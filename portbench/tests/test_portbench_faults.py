"""A run with the timed path broken underneath comes out not correct, once
for each fault of ``portbench/faults.py`` that the cell can have; a sound
run comes out correct under the cells' limits; and nothing the harness
runs loads JAX or the JAX package.  The runs skip the harness's look for a
card and drive the rest of a run on the CPU at a tiny fleet."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import faults, harness
from portbench_tiny import load_bench, tiny_files, tiny_run

CELLS = ("gp_bucb.long.staggered", "clustering.long.staggered",
         "gp_bucb.long.lockstep", "tpe.h6.long")


@pytest.fixture
def program(monkeypatch):
    from repro_torch.core import gp
    monkeypatch.setattr(gp, "BANK_ENTRY_POINTS", dict(gp.BANK_ENTRY_POINTS))
    return monkeypatch


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = tiny_run(cell, seconds=1.5)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, program):
    """A fault of another family's path (the clustering head in a GP-BUCB
    cell, the GP fit in a TPE cell, the TPE scorer in a GP cell), or of a
    kind of parameter the cell's space lacks (a string or numeric list in
    a Hartmann-6 cell), leaves the cell's path as it was: there the run
    stays correct."""
    kw = {"size": "tiny"} if fault == "candidates_cut" else {}
    faults.plant(fault, program.setattr, **kw)
    res = tiny_run(cell, seconds=1.5)
    files = tiny_files(cell)
    if not faults.breaks(fault, files["config"]["optimizer"],
                         files["objective"].space()):
        assert res["correct"], res["check"]
        return
    assert not res["correct"], res["check"]
    failed = [k for k, c in res["check"].items()
              if c["value"] is None or c["value"] > c["limit"]]
    assert failed


def test_limits_exist_for_every_cell_and_number():
    bench = load_bench()
    for w in bench["workloads"]:
        lim = json.loads((harness.PB / "limits" / f"{w['name']}.json")
                         .read_text())
        files = tiny_files(w["name"])
        common = {"candidate_ks", "candidate_faults", "missing_picks",
                  "na_changes", "invalid_trials"}
        opt = files["config"]["optimizer"]
        if opt == "tpe":
            want = {"tpe_score_gap", "tpe_pick_gap"}
        else:
            want = {"fit_gap", "sig2_gap", "schedule_faults"} | (
                {"picks_outside_top_set", "head_mismatches"}
                if opt == "clustering" else {"pick_gap"})
        assert set(lim["limits"]) == common | want
        assert files["limits"] == lim["limits"]


BLOCK = r'''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "repro"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1],
                sys.argv[1] + "/portbench/tests"]
from portbench import harness
for p in sorted((harness.PB / "metrics").glob("*.py")):
    harness.reader(p.stem)
import portbench.calibrate, portbench.run
from portbench_tiny import tiny_run
for cell in ("gp_bucb.long.staggered", "tpe.h6.long"):
    res = tiny_run(cell, seconds=0.5, trace=True)
bad = harness.forbidden_modules()
print("FORBIDDEN", bad)
assert not bad and "repro_torch" in sys.modules
'''


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", BLOCK, str(harness.ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    """On the card at the cell's own size: the control's readings (the
    reference in the precision its ``CONTROL`` names, TF32 where it names
    none) on the same asks exceed the cell's limits where the program's do
    not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = load_bench()
    for w in CELLS:
        files = harness.cell_files(bench, w)
        control = getattr(files["reference"], "CONTROL", "tf32")
        res = harness.run_cell(files, 2 ** 31 + 123, 6.0, False, "cuda",
                               0.0, lambda m: None, bench=bench, workload=w,
                               judge_precisions=("float64", control))
        assert res["correct"], res["check"]
        r = res["readings"]
        assert any(r[f"control.{k}"]["max"] > v
                   for k, v in files["limits"].items()
                   if f"control.{k}" in r)
