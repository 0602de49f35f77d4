"""``BENCHMARK.json`` against the benchmark contract's rules of form, and
the harness finding a cell, a traffic mix and a metric by name alone."""
import json
import re
import shutil
import string

import numpy as np
import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w


def test_every_name_and_unit_is_well_formed():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
        assert set(n) <= set(string.ascii_letters + string.digits + "_.-")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_and_workloads():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (harness.PB / "traffic" / f"{w['traffic']}.json").exists()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (harness.PB / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert (harness.PB / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        got = harness.metric_entries(BENCH, w["name"])
        assert got, w["name"]
        reported = {e["name"]
                    for e in harness.end_to_end_entries(BENCH, w["name"])}
        assert reported - {"setup_s"}, w["name"]
        # a per-layer metric's cells report the metric it moves
        assert all(e["moves"] in reported for e in got), w["name"]
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_check_budget_fits():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def _copy_benchmark(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(harness.PB, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return pb, json.loads(json.dumps(BENCH))


def _add_config(pb, bench, name, **changes):
    """A configuration file and its entry, copied from the first one with
    ``changes``."""
    src = bench["configs"][0]
    cfg = json.loads((ROOT / src["file"]).read_text())
    cfg.update(name=name, **changes)
    (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(src, name=name,
                                 file=f"portbench/configs/{name}.json"))


def test_a_new_cell_is_found_by_name_alone(tmp_path):
    """A configuration, an objective, a cell, a traffic mix and a per-layer
    metric added as files and entries, with no file of the harness edited,
    run on the CPU: the new objective is the one that runs."""
    pb, bench = _copy_benchmark(tmp_path)
    traffic = json.loads((pb / "traffic" / "long.staggered.json")
                         .read_text())
    traffic["staggered_share"] = 0.25
    (pb / "traffic" / "tmp.quarter.json").write_text(json.dumps(traffic))
    h6 = (pb / "objectives" / "neg_hartmann6.py").read_text()
    (pb / "objectives" / "tmp_flipped.py").write_text(
        h6 + "\n\n_h6 = evaluate\n\n\ndef evaluate(X):\n"
        "    return -_h6(X)\n")
    _add_config(pb, bench, "tmp-config", objective="tmp_flipped",
                optimizer="clustering", top_frac=0.25)
    (pb / "metrics" / "tmp_asks.py").write_text(
        "def read(ctx):\n    return float(len(ctx['asks']))\n")
    bench["workloads"].append({
        "name": "tmp.cell", "config": "tmp-config",
        "traffic": "tmp.quarter", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "tmp_asks", "unit": "asks",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tmp.cell"]})
    shutil.copy(pb / "limits" / "clustering.long.staggered.json",
                pb / "limits" / "tmp.cell.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench_tiny import tiny_files, tiny_run
    files = tiny_files("tmp.cell", pb=pb, bench=bench)
    assert files["traffic"]["staggered_share"] == 0.25
    assert files["config"]["top_frac"] == 0.25
    assert files["objective"].evaluate(np.full(6, 0.2)) < 0
    res = tiny_run("tmp.cell", seconds=1.0, files=files, bench=bench, pb=pb)
    assert res["correct"], res["check"]
    assert res["metrics"]["tmp_asks"]["value"] >= 1
    assert {"ask_p90_ms", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("change", [
    {"objective": "no_such_objective"}, {"dim": 5},
    {"precision": "float64"}, {"optimizer": "random"},
    {"reference": "portbench/no_such_reference.py"}])
def test_a_config_the_harness_cannot_honour_is_refused(tmp_path, change):
    pb, bench = _copy_benchmark(tmp_path)
    _add_config(pb, bench, "tmp-bad", **change)
    bench["workloads"].append({
        "name": "tmp.bad", "config": "tmp-bad",
        "traffic": "long.staggered", "chips": 1, "why": "a test's cell"})
    with pytest.raises((ValueError, FileNotFoundError)):
        harness.cell_files(bench, "tmp.bad", pb)


def test_every_per_layer_metric_lists_its_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (harness.PB / "metrics").glob("*.py")))
def test_every_metric_reader_loads(name):
    assert callable(harness.reader(name))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    for n in ("repro_torch_probe_x", "jaxfoo", "repro_torch.core"):
        monkeypatch.setitem(sys.modules, n, types.ModuleType(n))
    base = set(harness.forbidden_modules())
    assert not {"repro_torch_probe_x", "jaxfoo", "repro_torch.core"} & base
    monkeypatch.setitem(sys.modules, "repro.fake_sub",
                        types.ModuleType("repro.fake_sub"))
    assert "repro.fake_sub" in harness.forbidden_modules()


def test_without_the_program_the_command_prints_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the files
    under ``paths``, the command exits with another code than 0 and prints
    nothing on standard output."""
    import subprocess
    import sys
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns(
            "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    w = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, *BENCH["command"][1:],
                          "--workload", w, "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
