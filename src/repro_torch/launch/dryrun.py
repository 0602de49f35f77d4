"""Dry run of every (arch x shape x mesh) cell on the production meshes, with
no card.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step under its 16x16 / 2x16x16 TPU mesh and reads
XLA's memory and cost analyses.  The port does, per cell:

  (a) always, analytically: the state, cache and inputs on ``meta`` at full
      size, the layout rules applied (every fallback to replication
      recorded), the per-rank resident bytes of parameters, moments, batch
      and cache from the local shard shapes (the counterpart of
      ``memory_analysis``'s argument bytes), ``model_flops`` and
      ``cost.estimate_plan``'s terms and ``fits`` on an H100;
  (b) with ``--trace``, for every arch: the sharded train, prefill or
      decode step run under ``FakeTensorMode`` on a fake process group of
      the mesh's size (the counterpart of lower + compile): collectives
      by kind with their bytes and ring wire bytes (``CollectiveLog``),
      the traced FLOPs (DTensor ops at their global shapes, the per-rank
      regions inside ``local_map`` at rank 0's shapes times the ranks) and
      the traced resident bytes, which must equal (a)'s.  XLA's per-chip
      HLO FLOPs and bytes have no counterpart.  The plain versions that a
      CPU trace reaches walk the Mamba scan and the sLSTM recurrence one
      step at a time and the mLSTM one chunk at a time, which would make a
      trace's wall grow with the sequence (the reference lowers a
      ``lax.scan`` once): under the trace they are replaced by shape
      stand-ins (``_recurrence_stand_ins``) with the same outputs' shapes
      and the same counted FLOPs, forward and backward, their products
      batched over the steps or chunks (``tests/test_torch_dryrun.py``
      holds each against its plain version).  All three run inside
      ``local_map`` regions, which issue no collective.  Attention whose
      heads do not divide the model axis is split over its keys
      (``--attn-fallback kvseq``, the default) or its query rows
      (``qseq``), as the reference splits it: kvseq adds three functional
      all-reduces a layer (the combine in ``models.attention``), which
      the trace counts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k --mesh single [--seq-parallel] [--remat full] \\
      [--micro 0] [--ep] [--flat-dp] [--zero1] [--serve-tp] \\
      [--attn-fallback kvseq|qseq] [--trace]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Writes one JSON per cell to ``build/dryrun/`` and exits 1 on any failed
cell.  Each ``--trace`` mesh size needs its own default process group, so
the traces of one mesh run together and the group is remade between
meshes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
from collections import defaultdict
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import cells, get_config, get_shape
from repro_torch.launch import cost, roofline
from repro_torch.launch.inputs import abstract_state, input_specs
from repro_torch.launch.mesh import (device_mesh, make_production_mesh,
                                     make_shard_ctx)
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         distribute_tree, local_bytes,
                                         resident_bytes,
                                         serve_param_specs, train_state_specs)
from repro_torch.models.common import MeshSpec, Runtime
from repro_torch.models.transformer import init_cache
from repro_torch.tree import tree_map
from repro_torch.train.step import (TrainHyper, auto_microbatches,
                                    init_train_state, make_decode_step,
                                    make_prefill_step, make_train_step)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# reference flags with no counterpart here, and why
_NO_COUNTERPART = {
    "banded": "the flash kernel masks causally on its own; there is no "
              "banded jnp attention",
    "attn_q_chunk": "attention runs in the flash kernel, not in q chunks",
    "save_hlo": "there is no HLO: the step runs as DTensor ops",
}


def make_runtime(cfg, mesh, args) -> Runtime:
    """The cell's runtime over ``mesh`` (a ``MeshSpec``, or the
    ``DeviceMesh`` a trace places on)."""
    sc = make_shard_ctx(mesh, seq_parallel=args.seq_parallel,
                        flat_dp=args.flat_dp, shard_lstm_r=args.shard_r)
    return Runtime(sc=sc, attn_fallback=args.attn_fallback,
                   lstm_bf16_states=args.lstm_bf16,
                   remat_policy=args.remat, moe_expert_parallel=args.ep,
                   moe_capacity_factor=args.capacity_factor,
                   ssm_chunk=args.ssm_chunk, ce_chunk=args.ce_chunk)


def _prefill_len(cfg, shape) -> int:
    """Positions of the cache a prefill writes: a VLM's patches and the
    prompt."""
    return shape.seq_len + cfg.vision_tokens


def _layout(cfg, shape, rt: Runtime, args, params, misses=None) -> Dict:
    """The cell's specs: the state's for training, the parameters' (and
    the cache's) for serving."""
    sc, B = rt.sc, shape.global_batch
    ins = input_specs(cfg, shape, rt)
    if shape.kind == "train":
        return {"state": train_state_specs(params, cfg, sc, args.ep,
                                           args.zero1, misses),
                "batch": batch_specs(ins["batch"], sc, B)}
    out = {"params": serve_param_specs(params, cfg, sc, args.ep,
                                       args.serve_tp, misses)}
    if shape.kind == "prefill":
        out["batch"] = batch_specs(ins["batch"], sc, B)
        cache = init_cache(cfg, rt, B, _prefill_len(cfg, shape), "meta")
    else:
        out["tokens"] = batch_specs({"t": ins["tokens"]}, sc, B)["t"]
        cache = ins["cache"]
    out["cache"] = cache_specs(cache, cfg, sc, B, misses)
    return out


def _resident(cfg, shape, rt: Runtime, args, state, mesh) -> Dict[str, int]:
    """Per-rank resident bytes from the local shard shapes of the abstract
    state, batch and cache."""
    lay = _layout(cfg, shape, rt, args, state["params"])
    ins = input_specs(cfg, shape, rt)
    B = shape.global_batch
    if shape.kind == "train":
        sp = lay["state"]
        return {"params": resident_bytes(state["params"], sp["params"],
                                         mesh),
                "m": resident_bytes(state["opt"]["m"], sp["opt"]["m"], mesh),
                "v": resident_bytes(state["opt"]["v"], sp["opt"]["v"], mesh),
                "batch": resident_bytes(ins["batch"], lay["batch"], mesh)}
    out = {"params": resident_bytes(state["params"], lay["params"], mesh)}
    if shape.kind == "prefill":
        out["batch"] = resident_bytes(ins["batch"], lay["batch"], mesh)
        cache = init_cache(cfg, rt, B, _prefill_len(cfg, shape), "meta")
    else:
        out["batch"] = resident_bytes(ins["tokens"], lay["tokens"], mesh)
        cache = ins["cache"]
    out["cache"] = resident_bytes(cache, lay["cache"], mesh)
    return out


def analyze_cell(arch: str, shape_id: str, mesh_kind: str, args,
                 states: Optional[dict] = None, cfg=None) -> Dict:
    """(a): layout, fallbacks, resident bytes, model FLOPs and the plan
    estimate of one cell.  ``states`` caches the abstract state per arch;
    ``cfg`` overrides the config (a reduced one in tests)."""
    cfg, shape = cfg or get_config(arch), get_shape(shape_id)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rt = make_runtime(cfg, mesh, args)
    states = {} if states is None else states
    if arch not in states:
        states[arch] = abstract_state(cfg, rt)
    state = states[arch]
    misses: list = []
    _layout(cfg, shape, rt, args, state["params"], misses)
    resident = _resident(cfg, shape, rt, args, state, mesh)
    n_dev = mesh.size
    n_micro = (args.micro or auto_microbatches(cfg, shape, rt)
               if shape.kind == "train" else 1)
    plan = {"tp": rt.sc.tp, "zero": "zero1" if args.zero1 else "zero3",
            "remat": args.remat, "micro": n_micro,
            "seq_parallel": args.seq_parallel, "ep": args.ep,
            "capacity_factor": args.capacity_factor}
    est = cost.estimate_plan(cfg, shape, plan, n_dev)
    fallbacks: Dict[str, int] = {}
    for leaf, _, axis in misses:
        key = f"{leaf.split('/')[-1]}:{axis}"
        fallbacks[key] = fallbacks.get(key, 0) + 1
    return {
        "arch": arch, "shape": shape_id, "mesh": mesh_kind,
        "n_devices": n_dev, "hardware": roofline.H100.name,
        "config": {k: getattr(args, k) for k in (
            "seq_parallel", "remat", "micro", "ep", "capacity_factor",
            "ssm_chunk", "ce_chunk", "tag", "flat_dp", "attn_fallback",
            "lstm_bf16", "serve_tp", "zero1", "shard_r")},
        "n_microbatches": n_micro,
        "fallbacks": fallbacks, "n_fallbacks": len(misses),
        "resident_bytes": resident,
        "resident_bytes_total": sum(resident.values()),
        "fits_resident": sum(resident.values()) <= roofline.H100.hbm_bytes,
        "model_flops": roofline.model_flops(cfg, shape),
        "estimate": est, "fits": est["fits"],
    }


# --------------------------------------------------------------------------- #
# (b) the traced step
# --------------------------------------------------------------------------- #
# functional-collective ops (as DTensor issues them) -> collective kind
_FUNCOL_KINDS = {"all_gather_into_tensor": "all-gather",
                 "reduce_scatter_tensor": "reduce-scatter",
                 "all_reduce": "all-reduce",
                 "all_to_all_single": "all-to-all"}


def _group_ranks(group_name: str) -> list:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


class CollectiveLog(CommDebugMode):
    """``CommDebugMode`` that also records, per collective kind, this
    rank's output bytes and ring wire bytes, split by whether the group lies
    in one node of a ``roofline.H100`` fleet."""

    def __init__(self):
        super().__init__()
        self.stats = defaultdict(lambda: {"count": 0, "out_bytes": 0.0,
                                          "wire_bytes": 0.0,
                                          "cross_node_wire_bytes": 0.0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func,
                                               torch._ops.HigherOrderOperator):
            return out
        kind = _FUNCOL_KINDS.get(func._overloadpacket.__name__)
        if kind is not None:
            ranks = _group_ranks(args[-1])
            ob = float(out.numel() * out.element_size())
            w = roofline.wire_bytes(kind, ob, len(ranks))
            s = self.stats[kind]
            s["count"] += 1
            s["out_bytes"] += ob
            span = max(ranks) - min(ranks) + 1
            key = ("wire_bytes" if roofline.within_node(span, roofline.H100)
                   else "cross_node_wire_bytes")
            s[key] += w
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.stats.items()}


class TracedFlops(TorchDispatchMode):
    """FLOPs of the ops it sees, by ``flop_counter``'s formulas: DTensor ops
    at their global shapes; plain-tensor ops (the per-rank regions inside
    ``local_map``) at rank 0's shapes, counted ``world`` times."""

    def __init__(self, world: int):
        super().__init__()
        self.world = world
        self.global_flops = 0
        self.local_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        count = flop_registry.get(packet)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            if any(issubclass(t, DTensor) for t in types):
                self.global_flops += n
            else:
                self.local_flops += n
        return out

    @property
    def total(self) -> int:
        return self.global_flops + self.local_flops * self.world


def _scan_stand_in(Abar, Bx, Cc, return_state: bool = False):
    """The plain scan's outputs (y (B, S, di), h_S (B, di, N)) and its
    counted product (the states times C), without its per-step loop: the
    states taken as Abar * Bx."""
    hs = Abar * Bx
    y = torch.einsum("bsin,bsn->bsi", hs, Cc)
    return (y, hs[:, -1].contiguous()) if return_state else y


def _slstm_stand_in(xp, r, bias, *, cfg, stash):
    """The sLSTM loop's outputs (h (B, S, d) in ``stash`` and the final
    (c, n, h, m) (B, d)) and its recurrent products (step t's h_{t-1}
    (B, nh, dh) times r (nh, dh, 4dh), h_0 zero), steps 1..S-1 at once,
    without the loop."""
    B, S, _ = xp.shape
    d, nh = cfg.d_model, cfg.lstm_heads
    dh = d // nh
    h = torch.tanh(xp.float() + bias)[..., :d].reshape(B, S, nh, dh)
    rec = torch.cat([torch.einsum("bnd,ndk->bnk", h.new_zeros(B, nh, dh),
                                  r)[:, None],
                     torch.einsum("bsnd,ndk->bsnk", h[:, :-1], r)], dim=1)
    rec = rec[..., :dh].reshape(B, S, d)
    return (rec.to(stash),) + tuple(rec[:, -1].clone() for _ in range(4))


def _mlstm_stand_in(q, k, v, logi, logf, *, chunk: int = 64, state=None,
                    return_state: bool = False):
    """The chunkwise mLSTM's outputs (h (B, NH, S, dh), with
    ``return_state`` the carry (C, n, m)) and its products: each chunk's
    scores and their product with v, q times the carry (C, n) it starts
    from, and its update of the carry, without the per-chunk loop.  Chunks
    whose products the gradient treats alike run at once: the first (from
    the initial carry), the other full ones, the ragged tail, and apart
    the last chunk's update (with a gradient only when returned)."""
    B, NH, S, dh = q.shape
    if state is None:
        C0, n0 = q.new_zeros(B, NH, dh, dh), q.new_zeros(B, NH, dh)
    else:
        C0, n0 = state[0], state[1]
    L = min(chunk, S)
    nf, tail = divmod(S, L)
    w = torch.exp(logi + logf)

    def chunks(t, lo, c, l):
        return t[:, :, lo:lo + c * l].reshape(B, NH, c, l, *t.shape[3:])

    def update(lo, c, l):
        wc, kc, vc = (chunks(t, lo, c, l) for t in (w, k, v))
        return (torch.einsum("bncl,bncld,bnclv->bncdv", wc, kc, vc),
                torch.einsum("bncl,bncld->bncd", wc, kc))

    def attend(lo, c, l, C, n):
        qc, kc, vc = (chunks(t, lo, c, l) for t in (q, k, v))
        scores = torch.einsum("bncld,bncsd->bncls", qc, kc)
        num = (torch.einsum("bncls,bncsv->bnclv", scores, vc)
               + torch.einsum("bncld,bncdv->bnclv", qc, C))
        den = scores.sum(-1) + torch.einsum("bncld,bncd->bncl", qc, n)
        return (num + den[..., None]).reshape(B, NH, c * l, dh)

    last_full = update((nf - 1) * L, 1, L)
    hs = [attend(0, 1, L, C0[:, :, None], n0[:, :, None])]
    if nf > 1:
        hs.append(attend(L, nf - 1, L, *update(0, nf - 1, L)))
    if tail:
        hs.append(attend(nf * L, 1, tail, *last_full))
    h = torch.cat(hs, dim=2)
    if return_state:
        C, n = update(nf * L, 1, tail) if tail else last_full
        return h, (C[:, :, 0], n[:, :, 0], logi[..., -1].contiguous())
    if tail:
        update(nf * L, 1, tail)
    return h


@contextlib.contextmanager
def _recurrence_stand_ins():
    """The scan's, the mLSTM's and the sLSTM's plain recurrences replaced by
    their stand-ins for the duration of a trace."""
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.mlstm_chunk import ref as mlstm_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models import xlstm
    sites = ((ssm_ops, "selective_scan", _scan_stand_in),
             (mlstm_ops, "mlstm_mixer", _mlstm_stand_in),
             (mlstm_ref, "mlstm_chunkwise", _mlstm_stand_in),
             (xlstm, "_slstm_loop", _slstm_stand_in))
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for mod, name, fn in sites:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def fake_process_group(world: int) -> None:
    """A default process group of ``world`` fake ranks (this process is
    rank 0; collectives move nothing), remade if one of another size is
    up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=t.dtype)


def trace_cell(arch: str, shape_id: str, mesh_kind: str, args,
               cfg=None) -> Dict:
    """(b): run the cell's sharded step on fake tensors on a fake process
    group of the mesh's size.  ``cfg`` overrides the config (a reduced one
    in tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_id)
    spec: MeshSpec = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    fake_process_group(spec.size)
    dm = device_mesh(spec, "cpu")
    rt = make_runtime(cfg, dm, args)
    B = shape.global_batch
    ins = input_specs(cfg, shape, rt)
    t0 = time.perf_counter()
    with FakeTensorMode():
        state = init_train_state(torch.Generator(), cfg, rt)
        lay = _layout(cfg, shape, rt, args, state["params"])
        if shape.kind == "train":
            batch = distribute_tree(tree_map(_fake_like, ins["batch"]),
                                    lay["batch"], dm)
            n_micro = args.micro or auto_microbatches(cfg, shape, rt)
            step = make_train_step(cfg, rt, TrainHyper(), n_micro)
            call = (distribute_tree(state, lay["state"], dm), batch)
        else:
            params = distribute_tree(state["params"], lay["params"], dm)
            if shape.kind == "prefill":
                step = make_prefill_step(cfg, rt, cache_size=shape.seq_len)
                call = (params, distribute_tree(
                    tree_map(_fake_like, ins["batch"]), lay["batch"], dm))
            else:
                step = make_decode_step(cfg, rt)
                call = (params,
                        distribute_tree(_fake_like(ins["tokens"]),
                                        lay["tokens"], dm),
                        distribute_tree(tree_map(_fake_like, ins["cache"]),
                                        lay["cache"], dm),
                        shape.seq_len - 1)
        flops = TracedFlops(spec.size)
        with CollectiveLog() as log, flops, _recurrence_stand_ins():
            out = step(*call)
        # what the rank holds: the step's inputs and a prefill's new cache
        traced_resident = local_bytes(
            [a for a in call if not isinstance(a, int)]
            + ([out[1]] if shape.kind == "prefill" else []))
    coll = log.summary()
    return {
        "t_trace_s": time.perf_counter() - t0,
        "collectives": coll,
        "collective_counts": {k: v["count"] for k, v in coll.items()},
        "wire_bytes_per_rank": sum(v["wire_bytes"] for v in coll.values()),
        "cross_node_wire_bytes_per_rank": sum(
            v["cross_node_wire_bytes"] for v in coll.values()),
        "traced_flops_global": flops.total,
        "traced_flops_dtensor_ops": flops.global_flops,
        "traced_flops_local_regions_rank0": flops.local_flops,
        "traced_resident_bytes": traced_resident,
    }


def run_cell(arch, shape_id, mesh_kind, args, states, cfg=None) -> Dict:
    meta = analyze_cell(arch, shape_id, mesh_kind, args, states, cfg)
    if args.trace:
        tr = trace_cell(arch, shape_id, mesh_kind, args, cfg)
        if tr["traced_resident_bytes"] != meta["resident_bytes_total"]:
            raise AssertionError(
                f"traced resident bytes {tr['traced_resident_bytes']} != "
                f"analytic {meta['resident_bytes_total']}")
        if not sum(tr["collective_counts"].values()):
            raise AssertionError("the sharded step issued no collective")
        tr["useful_flops_ratio"] = (meta["model_flops"]
                                    / tr["traced_flops_global"])
        meta["trace"] = tr
    return meta


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="also run the cell's sharded step on a fake "
                         "process group")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["none", "dots", "full"])
    ap.add_argument("--micro", type=int, default=0)
    ap.add_argument("--ep", action="store_true")
    ap.add_argument("--flat-dp", action="store_true",
                    help="model axis becomes extra DP + ZeRO (small archs)")
    ap.add_argument("--lstm-bf16", action="store_true",
                    help="stash xLSTM scan outputs in bf16")
    ap.add_argument("--serve-tp", action="store_true",
                    help="serving layout: replicate params over data axes")
    ap.add_argument("--zero1", action="store_true",
                    help="replicate bf16 params over data; shard only moments")
    ap.add_argument("--shard-r", action="store_true",
                    help="FSDP-shard sLSTM recurrent weights")
    ap.add_argument("--attn-fallback", default="kvseq",
                    choices=["kvseq", "qseq"],
                    help="heads that do not divide the model axis: split "
                         "attention over its keys or its query rows")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--ssm-chunk", type=int, default=256)
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    # the reference's flags with no counterpart: refused with the reason
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--attn-q-chunk", type=int)
    ap.add_argument("--save-hlo", action="store_true")
    return ap


def check_args(args) -> None:
    for flag, why in _NO_COUNTERPART.items():
        if getattr(args, flag) not in (None, False):
            raise ValueError(f"--{flag.replace('_', '-')} has no "
                             f"counterpart in the port: {why}")
    if not args.all and not (args.arch and args.shape):
        raise ValueError("give --arch and --shape, or --all")


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    check_args(args)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s) for a, s, _, _ in cells(include_skips=False)]
    else:
        todo = [(args.arch, args.shape)]
    failures = 0
    states: dict = {}
    try:
        for mesh_kind in meshes:
            for arch, shape_id in todo:
                name = f"{arch}__{shape_id}__{mesh_kind}__{args.tag}"
                path = outdir / f"{name}.json"
                try:
                    t0 = time.perf_counter()
                    meta = run_cell(arch, shape_id, mesh_kind, args, states)
                    meta["t_total_s"] = time.perf_counter() - t0
                    path.write_text(json.dumps(meta, indent=2, default=str))
                    e = meta["estimate"]
                    line = (f"OK   {name}: step={e['t_step_s']:.4f}s "
                            f"compute={e['t_compute_s']:.4f}s "
                            f"mem={e['t_memory_s']:.4f}s "
                            f"coll={e['t_collective_s']:.4f}s "
                            f"dominant={e['dominant']} "
                            f"hbm={e['hbm_gb']:.2f}GB fits={e['fits']} "
                            f"resident={meta['resident_bytes_total'] / 1e9:.3f}GB "
                            f"fallbacks={meta['n_fallbacks']}")
                    if "trace" in meta:
                        tr = meta["trace"]
                        line += (f" | traced in {tr['t_trace_s']:.1f}s: "
                                 f"collectives {tr['collective_counts']} "
                                 f"flops {tr['traced_flops_global']:.4g} "
                                 f"useful {tr['useful_flops_ratio']:.3f}")
                    print(line, flush=True)
                except Exception as e:  # a failed cell is reported, not fatal
                    failures += 1
                    path.with_suffix(".err").write_text(
                        f"{e}\n{traceback.format_exc()}")
                    print(f"FAIL {name}: {type(e).__name__}: {e}",
                          flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"{len(todo) * len(meshes) - failures} of "
          f"{len(todo) * len(meshes)} cells OK", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
