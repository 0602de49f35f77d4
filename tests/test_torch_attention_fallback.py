"""The reference's attention fallbacks for heads that do not divide the model
axis (``repro.models.attention._shard_plan``: the score tensor split over
its keys, "kvseq", or its query rows, "qseq") against the port's
(``repro_torch.models.attention``).

First the plain version with a causal diagonal offset (rows that see no
key, Sq > Sk) against a float64 oracle written here, and the per-rank
pieces of each fallback, run side by side in one process with the same
functions the mesh path calls, combined and held against the whole
attention: output, log-sum-exp and gradients, uneven shards and an empty
key shard and row shard included.  Then the port's fallback on 4 gloo
ranks of a (2, 2) mesh against the reference's ``_sdpa_dense`` under
``Runtime(attn_fallback=...)`` on a forced 4-device mesh, on the same numpy
inputs, for both fallbacks, causal and not, at smollm's reduced width (3
query heads over 1 key/value head, which do not divide a model axis of 2).
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.mesh as jmesh
from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models.common import Runtime as JRuntime

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import mesh
from repro_torch.models import attention
from repro_torch.models.common import Runtime

ROOT = Path(__file__).resolve().parents[1]
# fp32: the pieces and the whole call compute the same sums in another
# order (the combine's rescaling, dq summed over ranks)
RTOL = 2e-5
# the port against the reference on the mesh: fp32 both sides, the
# reference's einsum softmax against the port's pieces
MESH_ATOL = 2e-5


def _inputs(B, Sq, Sk, H, KV, hd, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                      (B, Sq, H, hd))]


def _oracle(q, k, v, causal, off):
    """float64 attention with the mask j <= i + off written out row by
    row: (out, lse), out 0 and lse +inf for a row that sees no key."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    out = np.zeros_like(q)
    lse = np.full((B, H, Sq), np.inf)
    for i in range(Sq):
        keys = np.arange(k.shape[1])
        if causal:
            keys = keys[keys <= i + off]
        if not len(keys):
            continue
        for h in range(H):
            s = np.einsum("bd,bsd->bs", q[:, i, h],
                          k[:, keys, h // G]) * hd ** -0.5
            m = s.max(-1, keepdims=True)
            p = np.exp(s - m)
            out[:, i, h] = np.einsum("bs,bsd->bd",
                                     p / p.sum(-1, keepdims=True),
                                     v[:, keys, h // G])
            lse[:, h, i] = (m + np.log(p.sum(-1, keepdims=True)))[:, 0]
    return out, lse


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    assert np.array_equal(np.isinf(got), np.isinf(want)), what
    fin = np.isfinite(want)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0))
    assert err <= rtol * scale, (what, err)


# (causal, Sq, Sk, offset): the default diagonal, negative offsets (the
# first -offset rows see no key), Sq > Sk, and an offset past every key
OFFSETS = [(True, 12, 12, None), (True, 9, 20, None), (True, 12, 12, -5),
           (True, 20, 7, 3), (True, 20, 7, -4), (True, 6, 30, 40),
           (False, 11, 5, -3)]


@pytest.mark.parametrize("causal,Sq,Sk,off", OFFSETS)
def test_plain_version_with_offset(causal, Sq, Sk, off):
    """``ref.attention_lse_ref`` with a diagonal offset against the float64
    oracle: output and log-sum-exp, +inf (not NaN) for the rows that see
    no key, whose output is 0; the wrapper refuses Sq > Sk under a causal
    mask only when no offset is given."""
    q, k, v, _ = _inputs(2, Sq, Sk, 6, 2, 16)
    out, lse = ref.attention_lse_ref(q, k, v, causal=causal, offset=off)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    want_out, want_lse = _oracle(q, k, v, causal,
                                 ref.diagonal(Sq, Sk, off))
    _close(out, want_out, "out")
    _close(lse, want_lse, "lse")
    assert torch.equal(flash_ops.sdpa(q, k, v, causal=causal,
                                      causal_offset=off), out)
    if causal and Sq > Sk and off is not None:
        with pytest.raises(ValueError, match="Sq <= Sk"):
            flash_ops.sdpa(q, k, v, causal=True)


@pytest.mark.parametrize("causal,Sq,Sk,off", OFFSETS)
def test_plain_backward_with_offset(causal, Sq, Sk, off):
    """``ref.attention_bwd_ref`` (the backward kernel's decomposition) with
    an offset against autograd of the plain forward: finite everywhere,
    zero gradient through the rows that see no key."""
    q, k, v, g = _inputs(2, Sq, Sk, 6, 2, 16, seed=1)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.attention_ref(*xs, causal=causal, offset=off)
    want = torch.autograd.grad(out, xs, g)
    _, lse = ref.attention_lse_ref(q, k, v, causal=causal, offset=off)
    got = flash_ops.sdpa_bwd(q, k, v, out.detach(), lse, g, causal=causal,
                             causal_offset=off)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        _close(a, b, name)
    n_empty = min(Sq, max(0, -ref.diagonal(Sq, Sk, off))) if causal else 0
    assert not got[0][:, :n_empty].any()


@pytest.mark.parametrize("n,ranks", [(16, 2), (37, 4), (100, 16),
                                     (17, 16), (1500, 16), (3, 8)])
def test_spans_are_dtensors_split(n, ranks):
    """``attention.spans`` gives each rank the rows that DTensor's
    ``Shard`` gives it (``torch.chunk``'s ceil-sized chunks, the ranks past
    the last chunk empty), in order and covering n."""
    got = attention.spans(n, ranks)
    chunks = torch.arange(n).chunk(ranks)
    sizes = [len(c) for c in chunks] + [0] * (ranks - len(chunks))
    assert [b - a for a, b in got] == sizes
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a1 == b0 for (_, b0), (a1, _) in zip(got, got[1:]))


# (causal, Sq, Sk, ranks): even and uneven splits, a key shard left empty
# (20 keys over 8: 3, 3, 3, 3, 3, 3, 2, 0), more query rows than keys in a
# shard (whole rows of a shard see no key), cross-attention
SPLITS = [(True, 16, 16, 2), (True, 37, 37, 4), (True, 20, 20, 8),
          (True, 9, 24, 3), (False, 20, 33, 4), (False, 64, 15, 16)]


@pytest.mark.parametrize("causal,Sq,Sk,R", SPLITS)
def test_kvseq_pieces_combine_to_the_whole(causal, Sq, Sk, R):
    """kvseq: each rank's ``kvseq_piece`` on its keys with
    ``shard_offset``, merged by ``kvseq_combine`` (a stacked reduction in
    place of the all-reduces), equals the whole attention: output and
    log-sum-exp; each rank's ``piece_bwd`` given the merged output
    and log-sum-exp gives exact dk, dv for its keys and dq summed over the
    ranks, against autograd of the whole."""
    q, k, v, g = _inputs(2, Sq, Sk, 3, 1, 24, seed=2)
    spans = attention.spans(Sk, R)
    pieces = [attention.kvseq_piece(
        q, k[:, a:b].contiguous(), v[:, a:b].contiguous(), causal,
        attention.shard_offset("kvseq", a, Sq, Sk)) for a, b in spans]
    out, lse = attention.kvseq_combine(torch.stack([p[0] for p in pieces]),
                                       torch.stack([p[1] for p in pieces]),
                                       attention.stacked_reduce)
    out, lse = out[0], lse[0]
    want_out, want_lse = ref.attention_lse_ref(q, k, v, causal=causal)
    _close(out, want_out, "out")
    _close(lse, want_lse, "lse")
    dq = torch.zeros_like(q)
    dk, dv = [], []
    for a, b in spans:
        pq, pk, pv = attention.piece_bwd(
            q, k[:, a:b].contiguous(), v[:, a:b].contiguous(), out, lse, g,
            causal,
            attention.shard_offset("kvseq", a, Sq, Sk))
        dq += pq
        dk.append(pk)
        dv.append(pv)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*xs, causal=causal), xs, g)
    for name, a, b in zip(("dq", "dk", "dv"),
                          (dq, torch.cat(dk, 1), torch.cat(dv, 1)), want):
        _close(a, b, name)


@pytest.mark.parametrize("causal,Sq,Sk,R", SPLITS)
def test_qseq_pieces_concatenate_to_the_whole(causal, Sq, Sk, R):
    """qseq: each rank's ``qseq_piece`` on its rows against the whole k
    and v with ``shard_offset``, concatenated, equals the whole attention,
    output and log-sum-exp; each rank's ``piece_bwd`` on its rows gives
    their exact dq and its share of dk, dv, which sum over the ranks to
    autograd of the whole; a rank left no rows adds zero."""
    q, k, v, g = _inputs(2, Sq, Sk, 3, 1, 24, seed=3)
    spans = attention.spans(Sq, R)
    offs = [attention.shard_offset("qseq", a, Sq, Sk) for a, _ in spans]
    pieces = [attention.qseq_piece(q[:, a:b].contiguous(), k, v, causal, o)
              for (a, b), o in zip(spans, offs)]
    out = torch.cat([p[0] for p in pieces], 1)
    want_out, want_lse = ref.attention_lse_ref(q, k, v, causal=causal)
    _close(out, want_out, "out")
    _close(torch.cat([p[1] for p in pieces], 2), want_lse, "lse")
    dq, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    for (a, b), o, (po, pl) in zip(spans, offs, pieces):
        pq, pk, pv = attention.piece_bwd(
            q[:, a:b].contiguous(), k, v, po, pl, g[:, a:b].contiguous(),
            causal, o)
        if a == b:
            assert not pk.any() and not pv.any()
        dq.append(pq)
        dk += pk
        dv += pv
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*xs, causal=causal), xs, g)
    for name, a, b in zip(("dq", "dk", "dv"), (torch.cat(dq, 1), dk, dv),
                          want):
        _close(a, b, name)


class _Mesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("fallback", ["kvseq", "qseq"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_plan_matches_the_reference(arch, fallback):
    """``_shard_plan`` against the reference's for every config at full
    size and reduced, on the production meshes and the (2, 4) test mesh,
    and without a mesh: the head axis where the heads divide the model
    axis, else the fallback's sequence axis."""
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), jget_config(arch, reduced)
        for shape, names in (((16, 16), ("data", "model")),
                             ((2, 16, 16), ("pod", "data", "model")),
                             ((2, 4), ("data", "model")), (None, None)):
            if shape is None:
                jsc, sc = jmesh.make_shard_ctx(None), mesh.make_shard_ctx(None)
            else:
                jsc = jmesh.make_shard_ctx(_Mesh(shape, names))
                sc = mesh.make_shard_ctx(mesh.make_test_mesh(shape, names))
            want = jattention._shard_plan(
                jcfg, JRuntime(sc=jsc, attn_fallback=fallback))
            got = attention._shard_plan(
                cfg, Runtime(sc=sc, attn_fallback=fallback))
            assert got == want, (reduced, shape)


def test_unknown_fallback_is_refused():
    with pytest.raises(ValueError, match="attn_fallback"):
        attention._shard_plan(get_config("yi-34b"),
                              Runtime(attn_fallback="heads"))


# --------------------------------------------------------------------------- #
# the port on 4 gloo ranks against the reference on a forced 4-device mesh
# --------------------------------------------------------------------------- #
# (name, causal, B, Sq, Sk): causal self-attention and non-causal
# cross-attention with Sq != Sk, both lengths even over the model axis (the
# reference's ``sc.div`` keeps a length the axis does not divide whole)
MESH_CASES = [("causal", True, 4, 16, 16), ("cross", False, 4, 8, 24)]

_REF = textwrap.dedent('''
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_shard_ctx, make_test_mesh
    from repro.models import attention as A
    from repro.models.common import Runtime

    cfg = get_config("smollm-135m", reduced=True)
    mesh = make_test_mesh((2, 2))
    data = np.load(sys.argv[1])
    out = {}
    for fb in ("kvseq", "qseq"):
        rt = Runtime(sc=make_shard_ctx(mesh), attn_fallback=fb,
                     param_dtype=jnp.float32, compute_dtype=jnp.float32)
        plan = A._shard_plan(cfg, rt)
        for name, causal in (("causal", True), ("cross", False)):
            q, k, v, g = (jnp.asarray(data[f"{name}_{x}"])
                          for x in "qkvg")

            def f(q, k, v):
                return A._sdpa_dense(q, A._expand_kv(k, cfg),
                                     A._expand_kv(v, cfg), causal=causal,
                                     cfg=cfg, rt=rt, B=q.shape[0])

            o, vjp = jax.vjp(jax.jit(f), q, k, v)
            out[f"{fb}/{name}"] = {
                "plan": list(plan), "out": np.asarray(o).tolist(),
                "grads": [np.asarray(t).tolist() for t in vjp(g)]}
    print("RESULT " + json.dumps(out))
''')

_PORT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port, path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs.registry import get_config
        from repro_torch.launch import mesh as M
        from repro_torch.launch.dryrun import CollectiveLog
        from repro_torch.models import attention as A
        from repro_torch.models.common import Runtime
        cfg = get_config("smollm-135m", reduced=True)
        dm = M.device_mesh(M.make_test_mesh((2, 2)), "cpu")
        data = np.load(path)
        out = {}
        for fb in ("kvseq", "qseq"):
            rt = Runtime(sc=M.make_shard_ctx(dm), attn_fallback=fb,
                         param_dtype=torch.float32,
                         compute_dtype=torch.float32)
            pl = rt.sc.placements(("data", None, None, None))
            for name, causal in (("causal", True), ("cross", False)):
                q, k, v, g = (distribute_tensor(torch.from_numpy(
                    data[f"{name}_{x}"]), dm, pl) for x in "qkvg")
                xs = [t.requires_grad_() for t in (q, k, v)]
                with CollectiveLog() as log:
                    o = A._sdpa(*xs, cfg, rt, causal)
                o = o.reshape(g.shape)
                grads = torch.autograd.grad(o, xs, g)
                out[f"{fb}/{name}"] = {
                    "plan": list(A._shard_plan(cfg, rt)),
                    "out": o.full_tensor().tolist(),
                    "grads": [t.full_tensor().tolist() for t in grads],
                    "collectives": {k: v["count"]
                                    for k, v in log.summary().items()}}
        if rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _result(out) -> dict:
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(port, reference) results on the same numpy inputs."""
    tmp = tmp_path_factory.mktemp("fallback")
    cfg = get_config("smollm-135m", reduced=True)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    arrays = {}
    for i, (name, _, B, Sq, Sk) in enumerate(MESH_CASES):
        for x, t in zip("qkvg", _inputs(B, Sq, Sk, H, KV, hd, seed=10 + i)):
            arrays[f"{name}_{x}"] = t.numpy()
    path = tmp / "inputs.npz"
    np.savez(path, **arrays)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    script = tmp / "port_run.py"
    script.write_text(_PORT)
    port = subprocess.run(
        [sys.executable, str(script), str(_free_port()), str(path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
    jref = subprocess.run(
        [sys.executable, "-c", _REF, str(path)], capture_output=True,
        text=True, timeout=300,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    return _result(port), _result(jref)


@pytest.mark.parametrize("name", [c[0] for c in MESH_CASES])
@pytest.mark.parametrize("fallback", ["kvseq", "qseq"])
def test_mesh_fallback_matches_the_reference(mesh_runs, fallback, name):
    """On a (2, 2) mesh, 3 query heads over 1 key/value head: the port's
    split attention on 4 gloo ranks against the reference's
    ``_sdpa_dense`` on a forced 4-device mesh, the same inputs: the same
    plan (the sequence axis, not the heads), the output and the gradients
    of q, k and v (the reference's through its expanded k and v) within
    ``MESH_ATOL``; kvseq issues the combine's all-reduces."""
    port, jref = (r[f"{fallback}/{name}"] for r in mesh_runs)
    assert port["plan"] == jref["plan"]
    assert port["plan"] == ([None, "model", None] if fallback == "kvseq"
                            else [None, None, "model"])
    np.testing.assert_allclose(port["out"], jref["out"], rtol=0,
                               atol=MESH_ATOL)
    for got, want in zip(port["grads"], jref["grads"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=MESH_ATOL)
    ar = port["collectives"].get("all-reduce", 0)
    assert ar == 3 if fallback == "kvseq" else ar == 0
