"""The sharded step of the MoE, Mamba, xLSTM and whisper paths on four gloo
ranks against the single-process port: olmoe with expert parallelism,
qwen2-moe's shared experts, jamba, xLSTM with and without FSDP-sharded
sLSTM weights, and whisper with its heads split, with 3 heads (attention
split over its keys or its query rows, the cross cache over positions),
and under ``seq_parallel``.

One spawned run on a (data=2, model=2) mesh holds every case: each
family's reduced config in fp32, placed by ``launch.sharding``, takes two
train steps beside the plain port from the same state, then a prefill and
four greedy tokens with a DTensor cache beside the plain path on the same
(gathered) parameters.  The kernels' wrappers refuse a
DTensor, so every recurrence and attention call on the mesh reaches them
with a rank's local shard (``local_map``); the run counts those calls.
The layout rules themselves are held against the JAX package leaf by leaf
in ``test_torch_sharding.py``.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# phase 11's tolerances (chip_smoke.TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL): the
# loss and the MoE auxiliaries to the first, the grad norm to the second
LOSS_RTOL, GNORM_RTOL = 2e-5, 1e-4
# phase 11's per-leaf tolerance (chip_smoke.LEAF_RTOL): each leaf's
# gradient within this of the leaf's largest value
LEAF_RTOL = 1e-4
# fp32 logits of the mesh and the plain path: the same products, summed in
# another order where the mesh splits a contraction
LOGITS_ATOL = 1e-4

_RUN = textwrap.dedent('''
    import dataclasses, functools, json, sys
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    B, S, MICRO, STEPS, GEN = 8, 32, 2, 2, 4
    METRICS = ("loss", "grad_norm", "moe_lb_loss", "moe_router_z",
               "moe_drop_frac")

    def cases():
        from repro_torch.configs.registry import get_config
        r = lambda a: get_config(a, reduced=True)
        w3 = dataclasses.replace(r("whisper-large-v3"), n_heads=3,
                                 n_kv_heads=3, d_model=48)
        return {
            # 8 experts over the model axis
            "olmoe-ep": (r("olmoe-1b-7b"), dict(moe_expert_parallel=True), {}),
            "qwen2-moe": (r("qwen2-moe-a2.7b"), {}, {}),
            "jamba": (r("jamba-v0.1-52b"), {}, {}),
            "xlstm": (r("xlstm-1.3b"), {}, {}),
            "xlstm-shard-r": (r("xlstm-1.3b"), {}, dict(shard_lstm_r=True)),
            # 4 heads over 2; 3 heads: attention split over its keys
            # (kvseq) or its query rows (qseq), the caches over positions
            "whisper": (r("whisper-large-v3"), {}, {}),
            "whisper-h3": (w3, {}, {}),
            "whisper-h3-qseq": (w3, dict(attn_fallback="qseq"), {}),
        }

    def counting(mod, name, calls, shapes=None):
        """Counts the calls of mod.name; with ``shapes``, records each
        attention call's (name, Sq, Sk) on this rank."""
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def wrapped(*a, **k):
            calls[name] += 1
            if shapes is not None:
                shapes.add((name, a[0].shape[1], a[1].shape[1]))
            return fn(*a, **k)
        setattr(mod, name, wrapped)

    def batches(cfg, seed=1):
        rng = torch.Generator().manual_seed(seed)
        out = []
        for _ in range(STEPS):
            b = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=rng,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
            if cfg.encoder_layers:
                b["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                          generator=rng)
            out.append(b)
        return out

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def leaf_err(state, plain):
        """After the first step, AdamW's first moment is a fixed multiple
        of the gradient: the worst leaf's largest difference, relative to
        its largest value, and its path."""
        from repro_torch.tree import tree_items
        ref = dict(tree_items(plain["opt"]["m"]))
        worst = (0.0, "")
        for p, t in tree_items(state["opt"]["m"]):
            scale = ref[p].abs().max().item()
            if scale > 0:
                e = (full(t) - ref[p]).abs().max().item() / scale
                worst = max(worst, (e, "/".join(map(str, p))))
        return worst

    def run_case(cfg, rt_kw, sc_kw, dm, calls, shapes, with_serve=True):
        from repro_torch.launch import mesh as M, sharding as SH
        from repro_torch.launch.dryrun import CollectiveLog
        from repro_torch.models.common import Runtime
        from repro_torch.train.step import (TrainHyper, init_train_state,
                                            make_decode_step,
                                            make_prefill_step,
                                            make_train_step)
        from repro_torch.tree import tree_items, tree_map
        f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
                   ce_chunk=16, **rt_kw)
        rt = Runtime(sc=M.make_shard_ctx(dm, **sc_kw), **f32)
        rt0 = Runtime(**f32)
        ep = rt.moe_expert_parallel
        plain = init_train_state(torch.Generator().manual_seed(0), cfg, rt0)
        state = SH.distribute_tree(
            init_train_state(torch.Generator().manual_seed(0), cfg, rt),
            SH.train_state_specs(plain["params"], cfg, rt.sc, ep), dm)
        step = make_train_step(cfg, rt, TrainHyper(), MICRO)
        step0 = make_train_step(cfg, rt0, TrainHyper(), MICRO)
        res = {k: [] for k in METRICS}
        res["collectives"], res["calls"] = [], []
        data = batches(cfg)
        for i, b in enumerate(data if with_serve else data[:1]):
            placed = SH.distribute_tree(b, SH.batch_specs(b, rt.sc, B), dm)
            for k in calls:
                calls[k] = 0
            shapes.clear()
            with CollectiveLog() as log:
                state, m = step(state, placed)
            res["calls"].append(dict(calls))
            res["sdpa_shapes"] = sorted(shapes)
            plain, m0 = step0(plain, b)
            for k in METRICS:
                res[k].append((float(full(m[k])), float(m0[k])))
            res["collectives"].append(
                {k: v["count"] for k, v in log.summary().items()})
            if i == 0:
                res["grad_leaf_err"] = leaf_err(state, plain)
        if ep:
            ffn = state["params"]["blocks"][0]["ffn"]
            res["expert_placements"] = {
                k: str(ffn[k].placements) for k in ("wg", "wu", "wd")}
        if not with_serve:
            return res
        prompt = {k: data[0][k] for k in ("tokens", "frames") if k in data[0]}
        pre = make_prefill_step(cfg, rt, cache_size=S + GEN)
        pre0 = make_prefill_step(cfg, rt0, cache_size=S + GEN)
        dec, dec0 = make_decode_step(cfg, rt), make_decode_step(cfg, rt0)
        tok, cache, lg = pre(state["params"], SH.distribute_tree(
            prompt, SH.batch_specs(prompt, rt.sc, B), dm))
        # the plain path serves the mesh's trained parameters, gathered:
        # the training drift is held above, the serving path here
        params0 = tree_map(full, state["params"])
        tok0, cache0, lg0 = pre0(params0, prompt)
        toks, toks0 = [full(tok)], [tok0]
        err = (full(lg) - lg0).abs().max().item()
        for i in range(GEN):
            tok, cache, lg = dec(state["params"], tok[:, None], cache, S + i)
            tok0, cache0, lg0 = dec0(params0, tok0[:, None], cache0, S + i)
            toks.append(full(tok))
            toks0.append(tok0)
            err = max(err, (full(lg) - lg0).abs().max().item())
        want = dict(SH._spec_items(SH.cache_specs(cache0, cfg, rt.sc, B)))
        res["cache_misplaced"] = [
            ("/".join(map(str, p)), str(t.placements))
            for p, t in tree_items(cache)
            if tuple(t.placements) != tuple(SH.to_placements(want[p], dm))]
        res["cache_placements"] = sorted({
            f"{p[-1]}: {t.placements}" for p, t in tree_items(cache)})
        res["tokens"] = torch.stack(toks).tolist()
        res["tokens_plain"] = torch.stack(toks0).tolist()
        res["logits_err"] = err
        return res

    def rank_main(rank, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
        from repro_torch.kernels.ssm_scan import ops as ssm_ops
        from repro_torch.launch import mesh as M
        calls = {"sdpa": 0, "sdpa_lse": 0, "selective_scan": 0,
                 "mlstm_mixer": 0}
        shapes = set()
        counting(flash_ops, "sdpa", calls, shapes)
        counting(flash_ops, "sdpa_lse", calls, shapes)
        counting(ssm_ops, "selective_scan", calls)
        counting(mlstm_ops, "mlstm_mixer", calls)
        dm = M.device_mesh(M.make_test_mesh((2, 2)), "cpu")
        out = {}
        for name, (cfg, rt_kw, sc_kw) in cases().items():
            out[name] = run_case(cfg, rt_kw, sc_kw, dm, calls, shapes)
        # Megatron-SP: the residual stream split over the sequence, the
        # cross-attention sublayer among them; with heads split, and with
        # attention split over its keys
        for name, case in (("whisper-seq-parallel", "whisper"),
                           ("whisper-h3-seq-parallel", "whisper-h3")):
            cfg = cases()[case][0]
            out[name] = run_case(cfg, {}, dict(seq_parallel=True), dm,
                                 calls, shapes, with_serve=False)
        if rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(int(sys.argv[1]),), nprocs=4)
''')

# each mixer's wrapper calls per DTensor train step and rank: one a layer
# of its kind a microbatch, twice under the default remat ("full": the
# backward recomputes the forward); attention split over a sequence (kvseq
# or qseq) reaches the forward kernel through ``sdpa_lse`` (its gradient is
# ``sdpa_bwd``'s, uncounted here), the head split through ``sdpa``
_MICRO, _REMAT = 2, 2
_CALLS = {
    "olmoe-ep": {"sdpa": 2},                     # 2 attention layers
    "qwen2-moe": {"sdpa": 2},
    "jamba": {"sdpa": 1, "selective_scan": 7},   # 1 attention, 7 Mamba
    "xlstm": {"mlstm_mixer": 7},                 # 7 mLSTM, 1 sLSTM
    "xlstm-shard-r": {"mlstm_mixer": 7},
    # 2 encoder, 2 decoder self-attention and 2 cross-attention layers
    "whisper": {"sdpa": 6},
    "whisper-h3": {"sdpa_lse": 6},
    "whisper-h3-qseq": {"sdpa_lse": 6},
    "whisper-seq-parallel": {"sdpa": 6},
    "whisper-h3-seq-parallel": {"sdpa_lse": 6},
}
CASES = list(_CALLS)
SERVED = [c for c in CASES if not c.endswith("seq-parallel")]
MOE = ("olmoe-ep", "qwen2-moe", "jamba")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """The spawned run's result per case (one run for the whole module)."""
    tmp = tmp_path_factory.mktemp("families")
    script = tmp / "families_run.py"
    script.write_text(_RUN)
    out = subprocess.run(
        [sys.executable, str(script), str(_free_port())],
        capture_output=True, text=True, timeout=900, cwd=tmp,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT "):])


def _within(pairs, rtol, what):
    for i, (got, want) in enumerate(pairs):
        assert abs(got - want) <= rtol * abs(want), (what, i, got, want)


@pytest.mark.parametrize("case", CASES)
def test_train_steps_match_one_process(gloo_run, case):
    """Two fp32 train steps (one under ``seq_parallel``) of the DTensor
    state within phase 11's tolerances of the single-process port's: the
    loss and the MoE auxiliaries (global means over the whole batch, not
    per shard) to 2e-5, the grad norm (every weight's gradient reduced
    over the data axes) to 1e-4, and after the first step each leaf's
    gradient (AdamW's first moment) to 1e-4 of the leaf's largest value;
    collectives issued every step."""
    res = gloo_run[case]
    _within(res["loss"], LOSS_RTOL, "loss")
    _within(res["grad_norm"], GNORM_RTOL, "grad_norm")
    err, leaf = res["grad_leaf_err"]
    assert err <= LEAF_RTOL, (leaf, err)
    for k in ("moe_lb_loss", "moe_router_z", "moe_drop_frac"):
        if case in MOE:
            if k != "moe_drop_frac":   # capacity may drop no slot
                assert all(want > 0 for _, want in res[k]), k
            _within(res[k], LOSS_RTOL, k)
        else:
            assert all(got == want == 0 for got, want in res[k]), k
    for counts in res["collectives"]:
        assert sum(counts.values()) > 0


@pytest.mark.parametrize("case", CASES)
def test_kernels_run_on_each_ranks_shard(gloo_run, case):
    """Each mixer reaches its kernel's wrapper (which refuses a DTensor)
    once a layer a microbatch, twice with the backward's recomputation,
    on every DTensor step: no recurrence or attention runs as DTensor ops
    around the kernel."""
    want = {k: 0 for k in ("sdpa", "sdpa_lse", "selective_scan",
                           "mlstm_mixer")}
    want.update({k: n * _MICRO * _REMAT for k, n in _CALLS[case].items()})
    for calls in gloo_run[case]["calls"]:
        assert calls == want


@pytest.mark.parametrize("case", SERVED)
def test_greedy_tokens_and_cache_placements(gloo_run, case):
    """A prefill and four greedy tokens with a DTensor cache: tokens equal
    to the plain path's, logits within ``LOGITS_ATOL``, and after decode
    every cache leaf in ``cache_specs``' placements: Mamba's conv and state
    over d_inner, xLSTM's states over the batch only, whisper's cross cache
    over its heads (4 over 2) or its 16 positions (3 heads)."""
    res = gloo_run[case]
    assert res["tokens"] == res["tokens_plain"]
    assert res["logits_err"] <= LOGITS_ATOL, res["logits_err"]
    assert res["cache_misplaced"] == []
    pl = set(res["cache_placements"])
    if case == "jamba":
        assert {"conv: (Shard(dim=0), Shard(dim=2))",
                "h: (Shard(dim=0), Shard(dim=1))"} <= pl
    if case == "whisper":
        assert "cross_k: (Shard(dim=0), Shard(dim=2))" in pl
    if case.startswith("whisper-h3"):
        assert "cross_k: (Shard(dim=0), Shard(dim=1))" in pl
    if case.startswith("xlstm"):
        assert all(p.endswith("(Shard(dim=0), Replicate())") for p in pl)


def test_expert_parallel_places_the_experts_over_model(gloo_run):
    """With ``moe_expert_parallel`` the experts' axis of wg, wu and wd lies
    over the model axis and their d_model over the data axis."""
    assert gloo_run["olmoe-ep"]["expert_placements"] == {
        "wg": "(Shard(dim=1), Shard(dim=0))",
        "wu": "(Shard(dim=1), Shard(dim=0))",
        "wd": "(Shard(dim=2), Shard(dim=0))"}


# each attention call's (wrapper, Sq, Sk) on a rank of the (2, 2) mesh,
# B 8 x S 32 over 16 encoder frames: kvseq halves the keys, qseq the rows
# (the encoder, the decoder's self-attention, its cross-attention)
_SPLIT_SHAPES = {
    "whisper-h3": [("sdpa_lse", 16, 8), ("sdpa_lse", 32, 8),
                   ("sdpa_lse", 32, 16)],
    "whisper-h3-qseq": [("sdpa_lse", 8, 16), ("sdpa_lse", 16, 16),
                        ("sdpa_lse", 16, 32)],
    "whisper-h3-seq-parallel": [("sdpa_lse", 16, 8), ("sdpa_lse", 32, 8),
                                ("sdpa_lse", 32, 16)],
    "whisper": [("sdpa", 16, 16), ("sdpa", 32, 16), ("sdpa", 32, 32)],
}


@pytest.mark.parametrize("case", list(_SPLIT_SHAPES))
def test_attention_split_shapes(gloo_run, case):
    """whisper with 3 heads, which do not divide the model axis: each
    rank's kernel call holds half the keys (kvseq, the default, also under
    ``seq_parallel``) or half the query rows (qseq) of the encoder's
    self-attention, the decoder's and its cross-attention; with 4 heads
    (split over the axis) every call holds the whole sequences."""
    got = [tuple(c) for c in gloo_run[case]["sdpa_shapes"]]
    assert got == _SPLIT_SHAPES[case]
