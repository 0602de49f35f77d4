"""The port's launch layer against the JAX package: the layout rules
(``param_specs``, ``cache_specs``, ``batch_specs``) leaf by leaf for every
config at full size on the production and test meshes under every layout
flag, the local shard shapes, the meshes' ``ShardCtx`` fields and the
``meta`` input stand-ins; then the sharded step executed with DTensor on
four gloo ranks (train, prefill + decode, the elastic restore and the int8
all-reduce) against the single-process port and the reference's
``compressed_psum``.

The reference's rules read only ``mesh.axis_names`` and ``mesh.shape``, so
a stand-in with those two takes the place of its mesh (no forced host
devices); its local shard shapes come from a ``jax.sharding.AbstractMesh``.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import functools
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

import repro.launch.mesh as jmesh
from repro.configs import cells, get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.launch import inputs as jinputs
from repro.launch import sharding as jsharding
from repro.models.common import Runtime as JRuntime
from repro.train.step import init_train_state as j_init_train_state

from repro_torch import convert
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.launch import inputs, mesh, sharding
from repro_torch.models.common import Runtime, ShardCtx
from repro_torch.tree import tree_items

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "test": ((2, 4), ("data", "model"))}
CTX_FLAGS = {"default": {}, "flat_dp": {"flat_dp": True},
             "seq_parallel": {"seq_parallel": True},
             "shard_lstm_r": {"shard_lstm_r": True}}
# phase 11's tolerances (chip_smoke.TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL)
LOSS_RTOL, GNORM_RTOL = 2e-5, 1e-4
PSUM_RTOL = 0.02                       # the reference test's bound
# fp32 logits of the mesh and the plain path: the same products, summed in
# another order where the mesh splits a contraction
LOGITS_ATOL = 1e-4


class _Mesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _ctx_pair(kind, flags):
    shape, names = MESHES[kind]
    return (jmesh.make_shard_ctx(_Mesh(shape, names), **flags),
            mesh.make_shard_ctx(mesh.make_test_mesh(shape, names), **flags))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: j_init_train_state(
        jax.random.PRNGKey(0), cfg, JRuntime()))["params"]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return inputs.abstract_params(get_config(arch), Runtime())


class _Spec:
    """A reference spec as one leaf (a ``PartitionSpec`` is a tuple, which
    the port's tree walk would enter)."""

    def __init__(self, p, stacked):
        self.p = tuple(p)[1:] if stacked else tuple(p)


def _ref_in_port_layout(ref_specs, cfg):
    """The reference's spec tree in the port's per-layer layout
    (``convert.from_jax_layout``), the stacked leading ``None`` dropped."""
    def holder(path, p):
        stacked = path[0].key in ("blocks", "enc_blocks")
        h = _Spec(p, stacked)
        if not stacked:
            return h
        n = (cfg.encoder_layers if path[0].key == "enc_blocks"
             else cfg.n_periods)
        arr = np.empty(n, dtype=object)
        arr[:] = [h] * n
        return arr

    tree = jax.tree_util.tree_map_with_path(
        holder, ref_specs, is_leaf=lambda x: isinstance(x, P))
    return convert.from_jax_layout(tree, cfg, lambda path, h: h)


def _norm(spec, ndim):
    """One entry per dim; a one-axis tuple as its name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _compare(port_specs, ref_tree, template, what):
    ref = dict(tree_items(ref_tree))
    spec = dict(sharding._spec_items(port_specs))
    bad = []
    for path, leaf in tree_items(template):
        got, want = (_norm(spec[path], leaf.dim()),
                     _norm(ref[path].p, leaf.dim()))
        if got != want:
            bad.append((path, got, want))
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}"
    return len(spec)


def _local_shapes_match(template, port_specs, kind):
    shape, names = MESHES[kind]
    am = AbstractMesh(shape, names)
    spec_of = dict(sharding._spec_items(port_specs))
    ms = mesh.make_test_mesh(shape, names)
    for path, leaf in tree_items(template):
        s = spec_of[path]
        want = NamedSharding(am, P(*s)).shard_shape(tuple(leaf.shape))
        assert sharding.local_shape(leaf.shape, s, ms) == tuple(want), path
        # the placements split each dim by the product of its axes' sizes
        pl = sharding.to_placements(s, ms)
        n = list(leaf.shape)
        for axis, p in zip(names, pl):
            if p.is_shard():
                n[p.dim] //= ms.shape[axis]
        assert tuple(n) == tuple(want), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    """param_specs leaf by leaf for every layout flag on the production and
    test meshes, the ZeRO-1 / serve_tp layouts and expert parallelism
    included, and the local shard shapes on the production meshes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    ref, port = _ref_params(arch), _port_params(arch)
    n = 0
    for kind in MESHES:
        for name, flags in CTX_FLAGS.items():
            jsc, sc = _ctx_pair(kind, flags)
            for ep in (False, True):
                got = sharding.param_specs(port, cfg, sc, expert_parallel=ep)
                want = _ref_in_port_layout(jsharding.param_specs(
                    ref, jcfg, jsc, expert_parallel=ep), cfg)
                n += _compare(got, want, port, f"{kind}/{name}/ep={ep}")
                if kind != "test" and name == "default":
                    _local_shapes_match(port, got, kind)
            # ZeRO-1 parameters and the serving layout: fsdp_axis None
            want = _ref_in_port_layout(jsharding.param_specs(
                ref, jcfg, dataclasses.replace(jsc, fsdp_axis=None)), cfg)
            z1 = sharding.train_state_specs(port, cfg, sc, zero1=True)
            _compare(z1["params"], want, port, f"{kind}/{name}/zero1")
            _compare(sharding.serve_param_specs(port, cfg, sc,
                                                serve_tp=True),
                     want, port, f"{kind}/{name}/serve_tp")
            # ZeRO-1's moments keep the FSDP layout
            want = _ref_in_port_layout(jsharding.param_specs(
                ref, jcfg, jsc), cfg)
            _compare(z1["opt"]["m"], want, port, f"{kind}/{name}/zero1 m")
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_the_reference(arch):
    """cache_specs over the decode cache and batch_specs over the train
    batch, for each cell's batch size, on every mesh and flag set."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    for shape_id in ("decode_32k", "train_4k"):
        shape, jshape = get_shape(shape_id), jget_shape(shape_id)
        B = shape.global_batch
        ins = inputs.input_specs(cfg, shape, Runtime())
        jins = jinputs.input_specs(jcfg, jshape, JRuntime())
        for kind in MESHES:
            for name, flags in CTX_FLAGS.items():
                jsc, sc = _ctx_pair(kind, flags)
                if shape.kind == "decode":
                    got = sharding.cache_specs(ins["cache"], cfg, sc, B)
                    want = jsharding.cache_specs(jins["cache"], jcfg, jsc, B)
                    for l, layer in enumerate(ins["cache"]):
                        for key, leaf in layer.items():
                            ref = want[f"pos{l % len(cfg.period)}"][key]
                            assert _norm(got[l][key], leaf.dim()) == _norm(
                                tuple(ref)[1:], leaf.dim()), (kind, name, l,
                                                               key)
                else:
                    got = sharding.batch_specs(ins["batch"], sc, B)
                    want = jsharding.batch_specs(jins["batch"], jsc, B)
                    for key, leaf in ins["batch"].items():
                        assert _norm(got[key], leaf.dim()) == _norm(
                            want[key], leaf.dim()), (kind, name, key)


def test_meshes_and_shard_ctx_match_the_reference(monkeypatch):
    """The production and test meshes' axes and sizes, and make_shard_ctx's
    fields and axis sizes for every flag set (the reference's mesh built by
    a stand-in ``make_mesh``, no devices)."""
    monkeypatch.setattr(jmesh, "make_mesh", lambda s, a: _Mesh(s, a))
    for multi in (False, True):
        ref = jmesh.make_production_mesh(multi_pod=multi)
        got = mesh.make_production_mesh(multi_pod=multi)
        assert got.axis_names == ref.axis_names and got.shape == ref.shape
        assert got.size == (512 if multi else 256)
    ref, got = jmesh.make_test_mesh(), mesh.make_test_mesh()
    assert got.axis_names == ref.axis_names and got.shape == ref.shape
    for kind in MESHES:
        for flags in CTX_FLAGS.values():
            jsc, sc = _ctx_pair(kind, flags)
            for f in ("dp_axes", "tp_axis", "fsdp_axis", "seq_parallel",
                      "shard_lstm_r"):
                assert getattr(sc, f) == getattr(jsc, f), (kind, flags, f)
            assert (sc.tp, sc.dp, sc.fsdp) == (jsc.tp, jsc.dp, jsc.fsdp)
            for n in (1, 3, 8, 256):
                for axis in (sc.tp_axis, sc.dp_axes, sc.fsdp_axis):
                    assert sc.div(n, axis) == jsc.div(n, axis)
    assert mesh.make_shard_ctx(None) == ShardCtx.null()
    assert Runtime().sc == ShardCtx.null() and not Runtime().sc.tp_axis


def test_placements_order_and_mesh_checks():
    """A dim split over several axes names them in mesh order; the device
    mesh needs an initialised group of exactly its size."""
    ms = mesh.make_production_mesh(multi_pod=True)
    pl = sharding.to_placements((("pod", "data"), "model"), ms)
    assert [p.dim for p in pl] == [0, 0, 1]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.to_placements((("data", "pod"), None), ms)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.device_mesh(ms, "cpu")


@pytest.mark.parametrize("arch,shape_id", [
    (a, s) for a, s, _, _ in cells(include_skips=False)])
def test_meta_inputs_match_the_reference(arch, shape_id):
    """The meta stand-ins have the reference's shapes and dtypes, the
    decode cache per layer as the reference's per period position."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = inputs.input_specs(cfg, get_shape(shape_id), Runtime())
    want = jinputs.input_specs(jcfg, jget_shape(shape_id), JRuntime())
    dt = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}

    def same(t, s):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape) and t.dtype == dt[s.dtype]

    if "batch" in want:
        assert set(got["batch"]) == set(want["batch"])
        for k in want["batch"]:
            same(got["batch"][k], want["batch"][k])
        return
    same(got["tokens"], want["tokens"])
    same(got["cache_len"], want["cache_len"])
    assert len(got["cache"]) == cfg.n_layers
    for l, layer in enumerate(got["cache"]):
        ref = want["cache"][f"pos{l % len(cfg.period)}"]
        assert set(layer) == set(ref)
        for k, t in layer.items():
            s = ref[k]
            same(t, jax.ShapeDtypeStruct(s.shape[1:], s.dtype))


# --------------------------------------------------------------------------- #
# the sharded step on four gloo ranks
# --------------------------------------------------------------------------- #
_GLOO_RUN = textwrap.dedent('''
    import dataclasses, json, sys, tempfile
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    B, S, MICRO, STEPS, GEN = 8, 32, 2, 2, 4

    def serve(cfg, rt, rt0, params, params0, prompt, dm):
        """Prefill + GEN greedy tokens on the mesh and plain: the tokens,
        the largest logit difference and the cache's placements."""
        from repro_torch.launch import sharding as SH
        from repro_torch.train.step import make_decode_step, make_prefill_step
        pre = make_prefill_step(cfg, rt, cache_size=S + GEN)
        pre0 = make_prefill_step(cfg, rt0, cache_size=S + GEN)
        dec, dec0 = make_decode_step(cfg, rt), make_decode_step(cfg, rt0)
        tok, cache, lg = pre(params, SH.distribute_tree(
            prompt, SH.batch_specs(prompt, rt.sc, B), dm))
        tok0, cache0, lg0 = pre0(params0, prompt)
        toks, toks0 = [tok.full_tensor()], [tok0]
        err = (lg.full_tensor() - lg0).abs().max().item()
        for i in range(GEN):
            tok, cache, lg = dec(params, tok[:, None], cache, S + i)
            tok0, cache0, lg0 = dec0(params0, tok0[:, None], cache0, S + i)
            toks.append(tok.full_tensor())
            toks0.append(tok0)
            err = max(err, (lg.full_tensor() - lg0).abs().max().item())
        return {"tokens": torch.stack(toks).tolist(),
                "tokens_plain": torch.stack(toks0).tolist(),
                "logits_err": err,
                "cache_placements": str(cache[0]["k"].placements)}

    def rank_main(rank, port, out_dir, x_rows):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from repro_torch.configs.registry import get_config
        from repro_torch.launch import mesh as M, sharding as SH
        from repro_torch.launch.dryrun import CollectiveLog
        from repro_torch.models.common import Runtime
        from repro_torch.optim.compression import compressed_psum
        from repro_torch.train.checkpoint import Checkpointer
        from repro_torch.train.step import (TrainHyper, init_train_state,
                                            make_train_step)
        from repro_torch.tree import tree_items
        cfg = dataclasses.replace(get_config("smollm-135m", reduced=True),
                                  n_heads=4, n_kv_heads=4, d_model=64,
                                  d_ff=128, vocab_size=512)
        dm = M.device_mesh(M.make_test_mesh((2, 2)), "cpu")
        f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
                   ce_chunk=16)
        rt, rt0 = Runtime(sc=M.make_shard_ctx(dm), **f32), Runtime(**f32)
        plain = init_train_state(torch.Generator().manual_seed(0), cfg, rt0)
        specs = SH.train_state_specs(plain["params"], cfg, rt.sc)
        state = SH.distribute_tree(
            init_train_state(torch.Generator().manual_seed(0), cfg, rt),
            specs, dm)
        rng = torch.Generator().manual_seed(1)
        batches = [{k: torch.randint(0, 512, (B, S), generator=rng,
                                     dtype=torch.int32)
                    for k in ("tokens", "labels")} for _ in range(STEPS)]
        step = make_train_step(cfg, rt, TrainHyper(), MICRO)
        step0 = make_train_step(cfg, rt0, TrainHyper(), MICRO)
        res = {"loss": [], "grad_norm": [], "collectives": []}
        for b in batches:
            placed = SH.distribute_tree(b, SH.batch_specs(b, rt.sc, B), dm)
            with CollectiveLog() as log:
                state, m = step(state, placed)
            plain, m0 = step0(plain, b)
            for k in ("loss", "grad_norm"):
                res[k].append((m[k].full_tensor().item(), m0[k].item()))
            res["collectives"].append(
                {k: v["count"] for k, v in log.summary().items()})
        # Megatron-SP: the residual stream split over the sequence
        rt_sp = Runtime(sc=M.make_shard_ctx(dm, seq_parallel=True), **f32)
        st_sp = SH.distribute_tree(
            init_train_state(torch.Generator().manual_seed(0), cfg, rt_sp),
            specs, dm)
        _, m = make_train_step(cfg, rt_sp, TrainHyper(), MICRO)(
            st_sp, SH.distribute_tree(batches[0], SH.batch_specs(
                batches[0], rt.sc, B), dm))
        res["seq_parallel"] = [m[k].full_tensor().item()
                               for k in ("loss", "grad_norm")]
        # prefill + greedy decode, DTensor cache placed by cache_specs
        prompt = {"tokens": batches[0]["tokens"]}
        res["serve"] = {"4/4": serve(cfg, rt, rt0, state["params"],
                                     plain["params"], prompt, dm)}
        # heads that do not divide the model axis, attention split over
        # its keys (kvseq) or its query rows (qseq), the cache split over
        # its positions: smollm's 3 over 1 and yi's reduced 7 over 1; key
        # and value heads that do not (k and v expanded to the query
        # heads; the cache split over positions)
        c3 = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1, d_model=48)
        c6 = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3, d_model=48)
        yi = get_config("yi-34b", reduced=True)
        for name, c, fb in (("3/1/kvseq", c3, "kvseq"),
                            ("3/1/qseq", c3, "qseq"), ("6/3", c6, "kvseq"),
                            ("7/1/kvseq", yi, "kvseq"),
                            ("7/1/qseq", yi, "qseq")):
            rt_c = dataclasses.replace(rt, attn_fallback=fb)
            p0 = init_train_state(torch.Generator().manual_seed(2), c, rt0)
            specs_c = SH.train_state_specs(p0["params"], c, rt.sc)
            st = SH.distribute_tree(
                init_train_state(torch.Generator().manual_seed(2), c, rt),
                specs_c, dm)
            placed = SH.distribute_tree(batches[1], SH.batch_specs(
                batches[1], rt.sc, B), dm)
            with CollectiveLog() as log:
                st, m = make_train_step(c, rt_c, TrainHyper(), MICRO)(
                    st, placed)
            p0, m0 = make_train_step(c, rt0, TrainHyper(), MICRO)(
                p0, batches[1])
            out = serve(c, rt_c, rt0, st["params"], p0["params"], prompt,
                        dm)
            out["train"] = [(m[k].full_tensor().item(), m0[k].item())
                            for k in ("loss", "grad_norm")]
            out["collectives"] = {k: v["count"]
                                  for k, v in log.summary().items()}
            if name.startswith("3/1"):
                # the same first step with the residual stream split over
                # the sequence (Megatron-SP)
                rt_sp = Runtime(sc=M.make_shard_ctx(dm, seq_parallel=True),
                                attn_fallback=fb, **f32)
                st_sp = SH.distribute_tree(init_train_state(
                    torch.Generator().manual_seed(2), c, rt_sp), specs_c, dm)
                _, m = make_train_step(c, rt_sp, TrainHyper(), MICRO)(
                    st_sp, placed)
                out["seq_parallel"] = [m[k].full_tensor().item()
                                       for k in ("loss", "grad_norm")]
            res["serve"][name] = out
        # elastic restore: saved from the (2, 2) layout, onto (4, 1)
        ck = Checkpointer(out_dir, cfg, async_save=False)
        ck.save(7, state)
        dist.barrier()
        dm2 = M.device_mesh(M.make_test_mesh((4, 1)), "cpu")
        lay = SH.to_shardings(SH.train_state_specs(
            plain["params"], cfg, M.make_shard_ctx(dm2)), dm2)
        got, meta = ck.restore(None, plain, placements=lay)
        saved = dict(tree_items(state))
        res["restore_placements"] = str(
            got["params"]["blocks"][0]["mixer"]["wq"].placements)
        res["restore_exact"] = meta["step"] == 7 and all(
            torch.equal(t.full_tensor(), saved[p].full_tensor())
            for p, t in tree_items(got) if torch.is_tensor(t))
        # int8 all-reduce over the four ranks, rank r holding row r
        res["psum"] = compressed_psum(torch.tensor(x_rows[rank]),
                                      dist.group.WORLD).tolist()
        if rank == 0:
            print("RESULT " + json.dumps(res), flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        port, x_rows = int(sys.argv[1]), json.loads(sys.argv[2])
        mp.spawn(rank_main, args=(port, tempfile.mkdtemp(), x_rows),
                 nprocs=4)
''')

_REF_PSUM = textwrap.dedent('''
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.launch.mesh import make_test_mesh
    from repro.optim.compression import compressed_psum
    mesh = make_test_mesh((4,), ("pod",))
    x = jnp.asarray(np.asarray(json.loads(sys.argv[1]), np.float32))

    @partial(shard_map, mesh=mesh, in_specs=P("pod"), out_specs=P("pod"))
    def f(xs):
        return compressed_psum(xs[0], "pod")[None]

    print("RESULT " + json.dumps(np.asarray(f(x))[0].tolist()))
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _result(out) -> dict:
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT "):])


def test_sharded_step_on_four_gloo_ranks(tmp_path):
    """The reference test's smollm (4 heads, d 64, ff 128, vocab 512; B 8,
    S 32, 2 microbatches) in fp32 on a (2, 2) mesh: two train steps within
    phase 11's tolerances of the single-process port with collectives
    issued, a ``seq_parallel`` step likewise, prefill + 4 greedy tokens
    equal with logits within ``LOGITS_ATOL``; the same train step, prefill
    and decode for 3 query heads over 1 key/value head and yi's reduced 7
    over 1 (heads that do not divide the model axis: attention split over
    its keys, with the combine's all-reduces, and over its query rows; for
    3 over 1 also a ``seq_parallel`` step) and 6 over 3 (k and v
    expanded), their caches split over positions;
    the state saved on (2, 2) and restored onto (4, 1) bitwise, and compressed_psum within the
    reference's 0.02 of the fp32 sum and equal to the reference's
    compressed_psum on the same inputs (run as its own test runs it)."""
    x = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    script = tmp_path / "gloo_run.py"
    script.write_text(_GLOO_RUN)
    port = subprocess.run(
        [sys.executable, str(script), str(_free_port()),
         json.dumps(x.tolist())], capture_output=True, text=True,
        timeout=600, env=env, cwd=tmp_path)
    ref = subprocess.run(
        [sys.executable, "-c", _REF_PSUM, json.dumps(x.tolist())],
        capture_output=True, text=True, timeout=300,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    res, ref_psum = _result(port), np.asarray(_result(ref), np.float32)
    for (got, want) in res["loss"]:
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    for (got, want) in res["grad_norm"]:
        assert abs(got - want) <= GNORM_RTOL * abs(want)
    for counts in res["collectives"]:
        assert sum(counts.values()) > 0
    for got, (_, want) in zip(res["seq_parallel"], (res["loss"][0],
                                                    res["grad_norm"][0])):
        assert abs(got - want) <= GNORM_RTOL * abs(want)
    for heads, out in res["serve"].items():
        assert out["tokens"] == out["tokens_plain"], heads
        assert out["logits_err"] <= LOGITS_ATOL, (heads, out["logits_err"])
    split = ("3/1/kvseq", "3/1/qseq", "6/3", "7/1/kvseq", "7/1/qseq")
    assert set(res["serve"]) == {"4/4", *split}
    for heads in split:
        out = res["serve"][heads]
        for (got, want), tol in zip(out["train"], (LOSS_RTOL, GNORM_RTOL)):
            assert abs(got - want) <= tol * abs(want), heads
        for got, (_, want) in zip(out.get("seq_parallel", ()),
                                  out["train"]):
            assert abs(got - want) <= GNORM_RTOL * abs(want), heads
    for heads in ("3/1/kvseq", "3/1/qseq"):
        assert len(res["serve"][heads]["seq_parallel"]) == 2
    # kvseq's combine: 3 all-reduces an attention call, more than qseq's
    for H in ("3/1", "7/1"):
        kv, qs = (res["serve"][f"{H}/{fb}"]["collectives"]
                  for fb in ("kvseq", "qseq"))
        assert kv["all-reduce"] > qs.get("all-reduce", 0), H
    # key/value heads over the model axis where they divide it, else the
    # cache's positions
    assert res["serve"]["4/4"]["cache_placements"] == \
        "(Shard(dim=0), Shard(dim=2))"
    for heads in split:
        assert res["serve"][heads]["cache_placements"] == \
            "(Shard(dim=0), Shard(dim=1))"
    assert res["restore_exact"]
    assert res["restore_placements"] == "(Shard(dim=0), Shard(dim=1))"
    psum, want = np.asarray(res["psum"], np.float32), x.sum(0)
    assert np.abs(psum - want).max() / np.abs(want).max() < PSUM_RTOL
    np.testing.assert_allclose(psum, ref_psum, rtol=1e-6, atol=1e-6)
