"""The port's dry run (``repro_torch.launch.dryrun``): the analytic pass over
every applicable (arch x shape) cell on both production meshes, and the
traced sharded steps (train, prefill, decode) of reduced dense decoders and
of the MoE, Mamba, xLSTM and whisper families on fake 256- and 512-rank
process groups: collectives issued, traced resident bytes equal to the
analytic ones.  The reference lowers and compiles the
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
                                  ["--save-hlo"]])
def test_flags_without_counterpart_are_refused(flag, tmp_path):
    with pytest.raises(ValueError, match="no counterpart"):
        dryrun.main(["--arch", "yi-34b", "--shape", "train_4k", "--out",
                     str(tmp_path)] + flag)


@pytest.mark.parametrize("fallback", [None, "kvseq", "qseq"])
def test_attn_fallback_is_accepted_and_recorded(fallback, tmp_path):
    """``--attn-fallback kvseq|qseq`` (kvseq by default, as the
    reference's) reaches the cell's runtime and its ``config`` record."""
    flag = [] if fallback is None else ["--attn-fallback", fallback]
    argv = ["--arch", "yi-34b", "--shape", "train_4k", "--out",
            str(tmp_path)] + flag
    assert dryrun.main(argv) == 0
    meta = json.loads(next(tmp_path.glob("*.json")).read_text())
    want = fallback or "kvseq"
    assert meta["config"]["attn_fallback"] == want
    args = dryrun.make_parser().parse_args(argv)
    rt = dryrun.make_runtime(get_config("yi-34b"), None, args)
    assert rt.attn_fallback == want
    with pytest.raises(SystemExit):
        dryrun.make_parser().parse_args(argv[:4] + ["--attn-fallback",
                                                    "heads"])


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


_TRACE_FALLBACK = textwrap.dedent('''
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import attention
    from repro_torch.models.common import Runtime

    # reduced smollm: 3 query heads over 1 key head, which do not divide a
    # model axis of 2; B 8 x S 64 (a causal self-attention layer)
    cfg = get_config("smollm-135m", reduced=True)
    B, S = 8, 64
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    dryrun.fake_process_group(4)
    dm = mesh.device_mesh(mesh.make_test_mesh((2, 2)), "cpu")

    def trace(rt, world, grad):
        """Traced FLOPs and collectives of one attention layer's forward
        (and backward) at fake B x S, placed on the mesh when ``rt`` has
        one."""
        with FakeTensorMode():
            p = attention.attn_init(torch.Generator(), cfg, rt)
            x = torch.zeros(B, S, cfg.d_model)
            if rt.sc.mesh is not None:
                pl = rt.sc.placements((None, None))
                p = {k: distribute_tensor(w, dm, pl) for k, w in p.items()}
                x = distribute_tensor(x, dm, rt.sc.placements(
                    ("data", None, None)))
            for t in [x, *p.values()]:
                t.requires_grad_(grad)
            flops = dryrun.TracedFlops(world)
            # the RoPE tables are plain tensors, as the steps place them
            with implicit_replication(), dryrun.CollectiveLog() as log, \\
                    flops:
                out = attention.attention(p, x, cfg, rt)
                if grad:
                    torch.autograd.grad(out.sum(), [x] + list(p.values()))
        return {"flops": flops.total,
                "attention": flops.local_flops * world,
                "counts": {k: v["count"] for k, v in log.summary().items()}}

    out = {}
    for grad in (False, True):
        key = "train" if grad else "prefill"
        out[key] = {"one": trace(Runtime(**f32), 1, grad)}
        for fb in ("kvseq", "qseq"):
            rt = Runtime(sc=mesh.make_shard_ctx(dm), attn_fallback=fb, **f32)
            out[key][fb] = trace(rt, 4, grad)
    print("RESULT " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def fallback_trace():
    out = subprocess.run(
        [sys.executable, "-c", _TRACE_FALLBACK], capture_output=True,
        text=True, timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                                     "PATH": "/usr/bin:/bin",
                                     "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("fallback", ["kvseq", "qseq"])
@pytest.mark.parametrize("step", ["prefill", "train"])
def test_traced_fallback_counts_attention_once(fallback_trace, fallback,
                                               step):
    """A reduced smollm attention layer (3 heads over 1, which do not
    divide the model axis of a (2, 2) mesh) traced on a fake 4-rank group:
    the per-rank kernel calls, counted at rank 0's shapes times the ranks,
    add up to the attention's products once, and the layer's FLOPs to
    those of the same layer in one process, where
    the replicated layout counted them once per model rank.  Under either
    fallback the backward kernel's decomposition recomputes the scores (one
    product of the 2 B H S^2 hd more than autograd of the plain version
    takes), and kvseq's forward adds the combine's 3 all-reduces."""
    one, got = fallback_trace[step]["one"], fallback_trace[step][fallback]
    cfg = get_config("smollm-135m", reduced=True)
    product = 2 * 8 * cfg.n_heads * 64 * 64 * cfg.hd   # one B H S^2 hd
    # the scores and P.V; autograd adds 4 products, the backward kernel's
    # decomposition 5
    n = 2 if step == "prefill" else 7
    extra = product if step == "train" else 0
    assert got["attention"] == n * product
    assert got["flops"] == one["flops"] + extra
    ar = got["counts"].get("all-reduce", 0)
    if fallback == "kvseq":
        assert ar >= 3
    elif step == "prefill":
        assert ar == 0


_TRACE_FAMILIES = textwrap.dedent('''
    import dataclasses, json
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun

    def r(arch, **kw):
        return dataclasses.replace(get_config(arch, reduced=True), **kw)

    # widths the rules split on the 16-wide axes: 16 heads, 16 experts,
    # d_inner 512, FSDP over d 256
    wide = dict(n_heads=16, n_kv_heads=16, d_model=256, vocab_size=1024)
    configs = {
        "olmoe-1b-7b": r("olmoe-1b-7b", d_ff=256, moe_d_ff=256,
                         n_experts=16, **wide),
        "qwen2-moe-a2.7b": r("qwen2-moe-a2.7b", moe_d_ff=256, n_experts=16,
                             **wide),
        "jamba-v0.1-52b": r("jamba-v0.1-52b", d_ff=512, moe_d_ff=256,
                            n_experts=16, **wide),
        "xlstm-1.3b": r("xlstm-1.3b", d_model=256, n_heads=4,
                        vocab_size=1024),
        "whisper-large-v3": r("whisper-large-v3", d_ff=512, **wide),
    }
    out = {}
    for cell in CELLS:
        kind, arch, shape, flags = cell.split("/")
        args = dryrun.make_parser().parse_args(
            ["--trace", "--tag", "t"] + flags.split())
        meta = dryrun.run_cell(arch, shape, kind, args, {}, configs[arch])
        tr = meta["trace"]
        out[cell] = {"counts": tr["collective_counts"],
                     "traced": tr["traced_resident_bytes"],
                     "analytic": meta["resident_bytes_total"],
                     "flops": tr["traced_flops_global"],
                     "fallbacks": meta["n_fallbacks"],
                     "world": dist.get_world_size()}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
''')
# (mesh, arch, shape, flags): expert parallelism with 16 experts over the
# model axis, qwen2-moe's shared experts, jamba's Mamba scan over d_inner
# shards and its MoE, the xLSTM blocks with the sLSTM weights FSDP-sharded,
# whisper's encoder and cross-attention, and a 3-axis serving cell
FAMILY_CELLS = ["single/olmoe-1b-7b/train_4k/--ep",
                "single/qwen2-moe-a2.7b/decode_32k/",
                "single/jamba-v0.1-52b/train_4k/",
                "single/xlstm-1.3b/prefill_32k/--shard-r",
                "single/whisper-large-v3/prefill_32k/",
                "multi/jamba-v0.1-52b/decode_32k/"]


@pytest.fixture(scope="module")
def family_traces():
    script = f"CELLS = {FAMILY_CELLS!r}\n" + _TRACE_FAMILIES
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=600, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("cell", FAMILY_CELLS)
def test_traced_family_steps(family_traces, cell):
    """Reduced MoE, Mamba, xLSTM and whisper cells with widths the rules
    split, traced on the fake 256- and 512-rank groups (``--ep`` and
    ``--shard-r`` reach the traced step): collectives issued, no fallback
    to replication, traced FLOPs counted and traced resident bytes equal to
    the analytic pass's."""
    r = family_traces[cell]
    assert sum(r["counts"].values()) > 0
    assert r["traced"] == r["analytic"] > 0
    assert r["flops"] > 0
    assert r["world"] == (512 if cell.startswith("multi") else 256)
    assert r["fallbacks"] == 0


def _traced(fn, args, kwargs, grad):
    """(FLOPs counted by the trace's counter, output shapes) of one call,
    with its backward from every output when ``grad``."""
    import torch
    args = [a.clone().requires_grad_(grad) for a in args]
    with dryrun.TracedFlops(world=1) as fc:
        out = fn(*args, **kwargs)
        flat = []
        for o in (out if isinstance(out, tuple) else (out,)):
            flat += list(o) if isinstance(o, tuple) else [o]
        if grad:
            sum(o.float().sum() for o in flat if o.requires_grad).backward()
    return fc.total, [tuple(o.shape) for o in flat]


def _randn(*shapes, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) for s in shapes]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_scan_stand_in_counts_like_the_plain_scan(grad, return_state):
    """The trace's scan stand-in: the plain scan's FLOPs (forward, and with
    ``grad`` backward) and output shapes."""
    from repro_torch.kernels.ssm_scan import ref
    B, S, di, N = 2, 128, 16, 4
    args = _randn((B, S, di, N), (B, S, di, N), (B, S, N))
    kw = {"return_state": return_state}
    assert (_traced(dryrun._scan_stand_in, args, kw, grad)
            == _traced(ref.ssm_scan_ref, args, kw, grad))


@pytest.mark.parametrize("S", [128, 160, 40])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_mlstm_stand_in_counts_like_the_plain_chunkwise(S, grad,
                                                        return_state):
    """The trace's mLSTM stand-in: the plain chunkwise mLSTM's FLOPs and
    output shapes at 64-token chunks, for whole chunks, a ragged tail and
    one short chunk."""
    from repro_torch.kernels.mlstm_chunk import ref
    B, NH, dh = 2, 2, 16
    args = _randn((B, NH, S, dh), (B, NH, S, dh), (B, NH, S, dh),
                  (B, NH, S), (B, NH, S))
    args[4] = -args[4].abs()
    kw = {"chunk": ref.CHUNK, "return_state": return_state}
    assert (_traced(dryrun._mlstm_stand_in, args, kw, grad)
            == _traced(ref.mlstm_chunkwise, args, kw, grad))


@pytest.mark.parametrize("grad", [False, True])
def test_slstm_stand_in_counts_like_the_plain_loop(grad):
    """The trace's sLSTM stand-in: the plain loop's FLOPs and output
    shapes."""
    import torch
    from repro_torch.models import xlstm
    cfg = get_config("xlstm-1.3b", reduced=True)
    d, nh = cfg.d_model, cfg.lstm_heads
    B, S = 2, 32
    args = _randn((B, S, 4 * d), (nh, d // nh, 4 * d // nh), (4 * d,))
    kw = {"cfg": cfg, "stash": torch.float32}
    assert (_traced(dryrun._slstm_stand_in, args, kw, grad)
            == _traced(xlstm._slstm_loop, args, kw, grad))


def test_whisper_decode_model_flops_counts_parameters_decode_skips():
    """whisper's decode `useful` above 1 (1.222 traced at full size) is the
    reference's ``model_flops`` formula (``repro/launch/hlo_analysis.py``,
    copied in ``launch.roofline``): 2 * active * B counts parameters that
    a decode step never multiplies, the encoder's layers, the cross
    attention's k and v projections (their outputs are cached) and the
    input embedding (a lookup).  At a reduced shape the traced FLOPs of a
    plain decode step are exactly that much below."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_shape
    from repro_torch.launch import roofline
    from repro_torch.models.common import Runtime
    from repro_torch.train.step import (init_train_state, make_decode_step,
                                        make_prefill_step)
    cfg = get_config("whisper-large-v3", reduced=True)
    B, S = 2, 32
    shape = dataclasses.replace(get_shape("decode_32k"), global_batch=B,
                                seq_len=S)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    params = init_train_state(torch.Generator().manual_seed(0), cfg,
                              rt)["params"]
    g = torch.Generator().manual_seed(1)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - 1),
                                      generator=g, dtype=torch.int32),
              "frames": torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                    generator=g)}
    tok, cache, _ = make_prefill_step(cfg, rt, cache_size=S)(params, prompt)
    flops = dryrun.TracedFlops(world=1)
    with flops:
        make_decode_step(cfg, rt)(params, tok[:, None], cache, S - 1)
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.hd
    attn = 2 * d * cfg.n_heads * cfg.hd + 2 * d * kv
    encoder = cfg.encoder_layers * (attn + 2 * d * cfg.d_ff)
    cross_kv = cfg.n_layers * 2 * d * kv
    embedding = cfg.padded_vocab() * d
    assert not cfg.tie_embeddings and cfg.act == "gelu"
    skipped = 2 * B * (encoder + cross_kv + embedding)
    assert roofline.model_flops(cfg, shape) == flops.total + skipped
