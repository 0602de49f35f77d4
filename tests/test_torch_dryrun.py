"""The port's dry run (``repro_torch.launch.dryrun``): the analytic pass over
every applicable (arch x shape) cell on both production meshes, and the
traced sharded steps (train, prefill, decode) of reduced dense decoders on
fake 256- and 512-rank process groups: collectives issued, traced resident
bytes equal to the analytic ones.  The reference lowers and compiles the
same cells (``repro.launch.dryrun``); its rules and the port's are held
leaf by leaf in ``test_torch_sharding.py``."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import cells as ref_cells
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.launch import cost, dryrun

ROOT = Path(__file__).resolve().parents[1]


def test_analytic_pass_covers_every_cell(tmp_path):
    """64 cells (32 applicable x 2 meshes), each OK, with resident bytes,
    fallbacks and estimate_plan's terms for its own plan."""
    assert dryrun.main(["--all", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    files = sorted(tmp_path.glob("*.json"))
    want = {(a, s) for a, s, _, _ in ref_cells(include_skips=False)}
    assert len(want) == 32 and len(files) == 64
    assert not list(tmp_path.glob("*.err"))
    seen = set()
    for f in files:
        meta = json.loads(f.read_text())
        seen.add((meta["arch"], meta["shape"]))
        assert meta["n_devices"] == (512 if meta["mesh"] == "multi" else 256)
        res = meta["resident_bytes"]
        assert meta["resident_bytes_total"] == sum(res.values()) > 0
        keys = {"train": {"params", "m", "v", "batch"},
                "prefill": {"params", "batch", "cache"},
                "decode": {"params", "batch", "cache"}}
        assert set(res) == keys[get_shape(meta["shape"]).kind]
        est = cost.estimate_plan(get_config(meta["arch"]),
                                 get_shape(meta["shape"]), meta["estimate"]
                                 ["plan"], meta["n_devices"])
        assert meta["estimate"] == json.loads(json.dumps(est))
        assert meta["fits"] == est["fits"]
    assert seen == want


@pytest.mark.parametrize("flag", [["--banded"], ["--attn-q-chunk", "256"],
                                  ["--attn-fallback", "qseq"],
                                  ["--save-hlo"]])
def test_flags_without_counterpart_are_refused(flag, tmp_path):
    with pytest.raises(ValueError, match="no counterpart"):
        dryrun.main(["--arch", "yi-34b", "--shape", "train_4k", "--out",
                     str(tmp_path)] + flag)


_TRACE = textwrap.dedent('''
    import dataclasses, json, sys
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, mesh

    args = dryrun.make_parser().parse_args(["--trace", "--tag", "t"])
    smollm = get_config("smollm-135m", reduced=True)
    configs = {
        # heads and key heads split over the 16-wide model axis
        "smollm-135m": dataclasses.replace(smollm, n_heads=16,
                                           n_kv_heads=16, d_model=256,
                                           d_ff=512, vocab_size=1024),
        # 7 heads, 1 key head: heads replicated, cache split over S
        "yi-34b": get_config("yi-34b", reduced=True),
    }
    # every step with heads split, the decode with the cache split over
    # positions; the 3-axis mesh traces ~3x slower: a serving step each
    cells = [("single", "smollm-135m", s)
             for s in ("train_4k", "prefill_32k", "decode_32k")]
    cells += [("single", "yi-34b", "decode_32k"),
              ("multi", "smollm-135m", "decode_32k"),
              ("multi", "yi-34b", "prefill_32k")]
    out = {}
    for kind, arch, shape in cells:
        cfg = configs[arch]
        meta = dryrun.run_cell(arch, shape, kind, args, {}, cfg)
        tr = meta["trace"]
        out[f"{arch}/{shape}/{kind}"] = {
            "counts": tr["collective_counts"],
            "traced": tr["traced_resident_bytes"],
            "analytic": meta["resident_bytes_total"],
            "flops": tr["traced_flops_global"],
            "world": dist.get_world_size()}
    try:
        mesh.device_mesh(mesh.make_test_mesh((2, 2)), "cpu")
        out["mismatch"] = "accepted"
    except RuntimeError as e:
        out["mismatch"] = str(e)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
''')


def test_traced_steps_on_fake_process_groups():
    """Reduced dense decoders' train, prefill and decode steps traced on
    the 16 x 16 fake mesh and serving steps on the 2 x 16 x 16 one (heads
    split over the model axis, and heads replicated with the cache split
    over positions): collectives issued, traced
    FLOPs counted, traced resident bytes equal to the analytic pass's;
    a mesh of another size than the process group is refused."""
    out = subprocess.run(
        [sys.executable, "-c", _TRACE], capture_output=True, text=True,
        timeout=600, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    res = json.loads(line[-1][len("RESULT "):])
    assert "needs 4 ranks; the process group has 512" in res.pop("mismatch")
    assert len(res) == 6
    for cell, r in res.items():
        assert sum(r["counts"].values()) > 0, cell
        assert r["traced"] == r["analytic"] > 0, cell
        assert r["flops"] > 0, cell
        assert r["world"] == (512 if cell.endswith("multi") else 256)
