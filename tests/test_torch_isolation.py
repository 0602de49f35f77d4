"""PyTorch port isolation: the port and ``chip_smoke.py`` import nothing of JAX
or of the JAX package (the tuner, the single-study strategies, the
examples, serving and training entry points, the sanitizer smoke, the
port's lint and the launch layer run in a process that blocks both), and entry points never
fall back to the CPU."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from scipy import stats

import repro_torch.core as T
from repro_torch.scheduler import SerialScheduler

ROOT = Path(__file__).resolve().parents[1]
SPACE = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}

_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, sys
    sys.path[:0] = [{src!r}, {root!r}]

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError("blocked import of " + name)
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch, repro_torch.core, repro_torch.convert
    import repro_torch.scheduler, repro_torch.device
    import repro_torch.kernels.gp_acquisition.ops
    import repro_torch.kernels.tpe_kde.ops
    import repro_torch.core.tpe, repro_torch.core.async_tuner
    import repro_torch.configs, repro_torch.models, repro_torch.launch.serve
    import repro_torch.kernels.flash_attention.ops, repro_torch.train.step
    import repro_torch.kernels.mlstm_chunk.ops, repro_torch.models.xlstm
    import repro_torch.launch.train, repro_torch.train.checkpoint
    import repro_torch.optim.adamw, repro_torch.optim.compression
    import repro_torch.data.pipeline, repro_torch.tree
    import repro_torch.kernels.ssm_scan.ops, repro_torch.kernels.ssm_scan.ref
    import repro_torch.models.mamba, repro_torch.models.moe
    import repro_torch.scheduler.local, repro_torch.scheduler.distributed
    import repro_torch.scheduler.service, repro_torch.service
    import repro_torch.service.wal, repro_torch.service.recovery
    import repro_torch.service.client, repro_torch.service.server
    import repro_torch.service.chaos
    import repro_torch.core.strategies, repro_torch.core.acquisition
    import repro_torch.core.kmeans, repro_torch.core.gp
    import repro_torch.examples, repro_torch.examples.quickstart
    import repro_torch.examples.distributed_tuning
    import repro_torch.examples.serve_batched
    import repro_torch.examples.tune_training
    import repro_torch.analysis, repro_torch.analysis.rules
    import repro_torch.analysis.sanitizers, repro_torch.analysis.smoke
    import repro_torch.analysis.__main__
    import repro_torch.launch.mesh, repro_torch.launch.sharding
    import repro_torch.launch.inputs, repro_torch.launch.roofline
    import repro_torch.launch.cost, repro_torch.launch.dryrun
    import chip_smoke
    from repro_torch.core import StudyBank
    for opt in ("bayesian", "tpe", ["bayesian", "tpe"]):
        bank = StudyBank(chip_smoke.hartmann_space(), 2, seed=1,
                         mc_samples=50, optimizer=opt, device="cpu")
        for b in range(2):
            for i in range(4):
                p = {{f"x{{j}}": (i + j + b) / 10 for j in range(6)}}
                bank.study(b).observe_params(p, chip_smoke.neg_hartmann6(p))
        assert all(len(t) == 2 for t in bank.ask_all(2))
    # the single-study strategies and the reference loop
    import numpy as np
    from repro_torch.core.strategies import STRATEGIES
    from repro_torch.core.tpe import TPEStrategy
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(12, 2)).astype(np.float32)
    y = -((X - 0.5) ** 2).sum(1).astype(np.float32)
    C = rng.uniform(size=(64, 2)).astype(np.float32)
    for name, kw in (("hallucination_ref", {{"scorer": "kinv_pallas"}}),
                     ("bayesian", {{"scorer": "kinv_jnp"}}),
                     ("clustering", {{}})):
        s = STRATEGIES[name](2, 1e4, fit_steps=3, device="cpu", **kw)
        assert len(set(s.propose(X, y, C, 3, pending=C[:2]))) == 3
    assert len(TPEStrategy(2, 1e4, device="cpu").propose(X, y, C, 3)) == 3
    # the analysis package: rules, the sanitizer smoke, the lint CLI
    from repro_torch.analysis.rules import all_rules
    assert len(all_rules()) == 11
    from repro_torch.analysis import smoke
    assert smoke.run(device="cpu", verbose=False) == 0
    from repro_torch.analysis.__main__ import main as lint_main
    assert lint_main([{src!r} + "/repro_torch", "--baseline",
                      {root!r} + "/.repro-torch-lint-baseline"]) == 0
    from repro_torch.launch import serve
    r = serve.run(serve.make_parser().parse_args(
        ["--device", "cpu", "--reduced", "--batch", "2", "--gen", "3"]))
    assert r["generated_shape"] == [2, 3] and r["logits_finite"]
    from repro_torch.launch import train
    r = train.run(train.make_parser().parse_args(
        ["--device", "cpu", "--reduced", "--steps", "1", "--batch", "2",
         "--seq", "8"]))
    assert r["losses"][0] == r["losses"][0]
    r = train.run(train.make_parser().parse_args(
        ["--device", "cpu", "--reduced", "--arch", "jamba-v0.1-52b",
         "--steps", "1", "--batch", "2", "--seq", "8"]))
    assert r["losses"][0] == r["losses"][0]
    r = serve.run(serve.make_parser().parse_args(
        ["--device", "cpu", "--reduced", "--arch", "qwen2-moe-a2.7b",
         "--batch", "2", "--gen", "2"]))
    assert r["logits_finite"]
    # the service's lazy imports: spaces, the bank, the optimizer's
    # helpers, TunerResults, all reached through HTTP
    import tempfile, threading
    from repro_torch.service import RemoteOptimizer, ServiceClient, serve
    with tempfile.TemporaryDirectory() as d:
        httpd, svc = serve(d, port=0, device="cpu", config={{
            "space": {{"x": {{"uniform": [0.0, 1.0]}},
                      "n": {{"int": [1, 4]}}}},
            "max_studies": 2, "mc_samples": 16, "fit_steps": 2}})
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        ro = RemoteOptimizer(ServiceClient(
            f"http://127.0.0.1:{{httpd.server_address[1]}}"), "iso")
        ro.sign = 1.0
        ro.observe_params({{"x": 0.5, "n": 2}}, 0.25)
        for _ in range(2):
            for t in ro.ask(2):
                ro.tell(t.id, t.params["x"])
        res = ro.results()
        assert len(res.objective_values) == 5, res
        assert type(res).__module__ == "repro_torch.core.tuner"
        httpd.shutdown()
        svc.close()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    print("isolated ok")
""")


def test_port_and_smoke_import_no_jax_or_repro():
    code = _BLOCKED_RUN.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated ok" in out.stdout


@pytest.mark.parametrize("make", [
    lambda: T.StudyBank(SPACE, 2),
    lambda: T.AskTellOptimizer(SPACE),
    lambda: T.Tuner(SPACE, lambda ps: [0.0] * len(ps)),
    lambda: T.AsyncTuner(SPACE, lambda p: 0.0, SerialScheduler(),
                         optimizer="tpe"),
], ids=["StudyBank", "AskTellOptimizer", "Tuner", "AsyncTuner"])
def test_entry_points_default_to_cuda_and_never_fall_back(make):
    """With no ``device`` an entry point runs on the card; without a card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        obj = make()
        opt = getattr(obj, "opt", obj)
        assert opt.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_serve_defaults_to_cuda_and_never_falls_back():
    """``launch.serve.run`` with the default device serves on the card, and
    raises without one."""
    from repro_torch.launch import serve
    args = serve.make_parser().parse_args(["--reduced", "--gen", "2"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        assert serve.run(args)["device"].startswith("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.run(args)


def test_cpu_is_used_only_when_asked():
    bank = T.StudyBank(SPACE, 2, device="cpu")
    assert bank.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in bank.studies)


@pytest.mark.parametrize("suite", ["gp_acquisition", "tpe_kde",
                                   "flash_attention", "mlstm_chunk",
                                   "ssm_scan"])
def test_kernel_wrappers_have_no_fallback(suite):
    """A CUDA tensor reaches the kernel or an exception: the dispatch code
    holds no ``try`` around a launch."""
    src = (ROOT / f"src/repro_torch/kernels/{suite}/ops.py").read_text()
    assert "try:" not in src and "except" not in src
