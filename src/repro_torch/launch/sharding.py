"""Best-effort parameter / cache / batch layout rules, and the placement of a
state on a ``DeviceMesh``.

The counterpart of ``repro.launch.sharding``.  A spec is a tuple with one
entry per tensor dim: a mesh axis name, a tuple of names (one dim split
over several axes, in mesh order), or None.  Every rule checks
divisibility against the mesh (via ``ShardCtx.div``) and falls back to
replication on that tensor dim, so every (arch x mesh) cell has a layout;
pass ``misses`` (a list) to record each fallback as (leaf path, dim size,
axis), as the dry run does.

The rules are the reference's over the port's per-layer trees:
``blocks[l]`` takes its mixer kind from ``transformer.layer_specs(cfg)``,
and there is no stacked leading axis (the reference's leading ``None``).
Naming convention: rules dispatch on the leaf's key name (wq, w_up, ...)
and the mixer kind of the enclosing layer (attention wq is (d, H*hd) while
mLSTM wq is (nh, dh, dh)).

``to_placements`` turns a spec into one DTensor placement per mesh axis;
``distribute_tree`` places a tree by its specs.  ``train_state_specs`` and
``serve_param_specs`` build the ZeRO-1 and ``serve_tp`` layouts as the
reference's dry run builds them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import mesh_spec
from repro_torch.models.common import (MeshSpec, Runtime, ShardCtx,
                                       mesh_placements)
from repro_torch.models.transformer import layer_specs
from repro_torch.tree import tree_items, tree_map

Spec = tuple


def _divider(sc: ShardCtx, names: Sequence, misses: Optional[list]
             ) -> Callable:
    """``sc.div`` that records each fallback in ``misses``."""
    def d(n: int, axis):
        got = sc.div(n, axis)
        if got is None and axis is not None and sc.mesh is not None \
                and misses is not None:
            misses.append(("/".join(map(str, names)), n, axis))
        return got
    return d


def _mixer_kind(names: Sequence, cfg: ArchConfig) -> str:
    if names[0] == "blocks":
        return layer_specs(cfg)[int(names[1])].mixer
    return "attn"


def _leaf_spec(names: Sequence, shape: tuple, cfg: ArchConfig,
               sc: ShardCtx, misses: Optional[list] = None) -> Spec:
    tp, fs = sc.tp_axis, sc.fsdp_axis
    d = _divider(sc, names, misses)  # axis if divisible else None
    name = names[-1]
    base = tuple(shape)
    lstm_like = (_mixer_kind(names, cfg) in ("mlstm", "slstm")
                 and "mixer" in names)

    def out(*spec):
        return tuple(spec[i] if i < len(spec) else None
                     for i in range(len(base)))

    H, KV = cfg.n_heads, cfg.n_kv_heads

    if name == "embed":
        return (d(base[0], tp), d(base[1], fs))
    if name == "lm_head":
        return (d(base[0], fs), d(base[1], tp))
    if len(base) == 0 or all(s == 1 for s in base):
        return out()

    if lstm_like:
        # xLSTM blocks: FSDP-only (activations replicated over TP)
        if name in ("wq", "wk", "wv"):          # (nh, dh, dh)
            return out(None, d(base[1], fs), None)
        if name == "r":                          # (nh, dh, 4dh)
            # sLSTM recurrent weights live inside the sequential time
            # loop: replicated unless shard_lstm_r
            if sc.shard_lstm_r:
                return out(None, d(base[1], fs), None)
            return out(None, None, None)
        if name in ("w_up", "w_in"):             # (d, k)
            return out(d(base[0], fs), None)
        if name == "w_down":                     # (di, d)
            return out(None, d(base[1], fs))
        if name == "w_gate":                     # (di, 2nh)
            return out(d(base[0], fs), None)
        return out()

    if name == "wq":                             # (d, H*hd)
        return out(d(base[0], fs), tp if d(H, tp) else None)
    if name in ("wk", "wv"):                     # (d, KV*hd)
        return out(d(base[0], fs), tp if d(KV, tp) else None)
    if name == "wo":                             # (H*hd, d)
        return out(tp if d(H, tp) else None, d(base[1], fs))
    if name in ("w_gate", "w_up"):               # (d, ff)
        return out(d(base[0], fs), d(base[1], tp))
    if name == "w_down":                         # (ff, d)
        return out(d(base[0], tp), d(base[1], fs))
    if name == "router":                         # (d, E)
        return out(d(base[0], fs), None)
    if name in ("wg", "wu"):                     # (E, d, f) MoE experts
        return out(None, d(base[1], fs), d(base[2], tp))
    if name == "wd":                             # (E, f, d)
        return out(None, d(base[1], tp), d(base[2], fs))
    if name == "shared_gate":                    # (d, 1)
        return out(d(base[0], fs), None)
    # --- mamba ---
    if name == "w_in":                           # (d, 2di)
        return out(d(base[0], fs), d(base[1], tp))
    if name == "conv_w":                         # (Kc, di)
        return out(None, d(base[1], tp))
    if name == "w_x":                            # (di, r+2N)
        return out(d(base[0], tp), None)
    if name == "w_dt":                           # (r, di)
        return out(None, d(base[1], tp))
    if name == "A_log":                          # (di, N)
        return out(d(base[0], tp), None)
    if name in ("dt_bias", "D"):                 # (di,)
        return out(d(base[0], tp))
    if name == "w_out":                          # (di, d)
        return out(d(base[0], tp), d(base[1], fs))
    # norms / biases / gates: replicate
    return out()


def expert_parallel_overrides(specs, cfg: ArchConfig, sc: ShardCtx):
    """EP mode: shard the expert axis of MoE weights over TP instead of ff."""
    tp = sc.tp_axis

    def fix(path, spec):
        names = [str(k) for k in path]
        if names and names[-1] in ("wg", "wu", "wd") and len(names) > 1 \
                and names[0] == "blocks":
            if sc.div(cfg.n_experts, tp):
                if names[-1] in ("wg", "wu"):
                    return (tp, sc.div(cfg.d_model, sc.fsdp_axis), None)
                return (tp, None, sc.div(cfg.d_model, sc.fsdp_axis))
        return spec

    return _map_specs(fix, specs)


def _map_specs(fn: Callable, specs):
    """fn(path, spec) over a tree whose leaves are spec tuples (which
    ``tree_map`` would walk into)."""
    if isinstance(specs, dict):
        return {k: _map_specs(lambda p, s, k=k: fn((k,) + p, s), v)
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(lambda p, s, i=i: fn((i,) + p, s), v)
                for i, v in enumerate(specs)]
    return fn((), specs)


def param_specs(params_tree, cfg: ArchConfig, sc: ShardCtx,
                expert_parallel: bool = False,
                misses: Optional[list] = None):
    specs = tree_map(
        lambda path, leaf: _leaf_spec([str(k) for k in path],
                                      tuple(leaf.shape), cfg, sc, misses),
        params_tree, with_path=True)
    if expert_parallel:
        specs = expert_parallel_overrides(specs, cfg, sc)
    return specs


def cache_specs(cache_tree, cfg: ArchConfig, sc: ShardCtx, batch: int,
                misses: Optional[list] = None):
    """Decode-cache specs: batch over DP; KV heads or S of attention caches
    over TP."""
    tp = sc.tp_axis
    kinds = layer_specs(cfg)

    def spec_for(path, leaf):
        d = _divider(sc, path, misses)
        bspec = d(batch, sc.dp_axes)
        layer, name = path[0], path[-1]
        shape = tuple(leaf.shape)
        rest = (None,) * (len(shape) - 1)
        if kinds[layer].mixer in ("mlstm", "slstm"):
            return (bspec,) + rest
        if name in ("k", "v", "cross_k", "cross_v"):  # (B, S, KV, hd)
            if d(cfg.n_kv_heads, tp):
                return (bspec, None, tp, None)
            return (bspec, d(shape[1], tp), None, None)
        if name == "conv":                            # (B, Kc-1, di)
            return (bspec, None, d(shape[2], tp))
        if name == "h" and len(shape) == 3:           # mamba (B, di, N)
            return (bspec, d(shape[1], tp), None)
        # xLSTM states & misc: batch-sharded only
        return (bspec,) + rest

    return tree_map(spec_for, cache_tree, with_path=True)


def batch_specs(batch_tree, sc: ShardCtx, batch: int):
    bspec = sc.div(batch, sc.dp_axes)
    return tree_map(lambda leaf: (bspec,) + (None,) * (leaf.dim() - 1),
                    batch_tree)


def train_state_specs(params_tree, cfg: ArchConfig, sc: ShardCtx,
                      expert_parallel: bool = False, zero1: bool = False,
                      misses: Optional[list] = None):
    """Specs of a train state {"params", "opt": {"m", "v", "step"}}: the
    moments as the parameters, or with ``zero1`` the parameters replicated
    over the data axes (no per-microbatch regathers) and only the fp32
    moments FSDP-sharded."""
    m_specs = param_specs(params_tree, cfg, sc, expert_parallel, misses)
    p_specs = m_specs
    if zero1:
        p_specs = param_specs(params_tree, cfg,
                              dataclasses.replace(sc, fsdp_axis=None),
                              expert_parallel)
    return {"params": p_specs, "opt": {"m": m_specs, "v": m_specs,
                                       "step": None}}


def serve_param_specs(params_tree, cfg: ArchConfig, sc: ShardCtx,
                      expert_parallel: bool = False, serve_tp: bool = False,
                      misses: Optional[list] = None):
    """Parameter specs for prefill and decode: with ``serve_tp`` the weights
    are TP-sharded and replicated over the data axes (no per-step FSDP
    gathers: there is no optimizer state to shard)."""
    if serve_tp:
        sc = dataclasses.replace(sc, fsdp_axis=None)
    return param_specs(params_tree, cfg, sc, expert_parallel, misses)


# --------------------------------------------------------------------------- #
# Placement
# --------------------------------------------------------------------------- #
def to_placements(spec: Spec, mesh: Union[MeshSpec, DeviceMesh]) -> list:
    """One placement per mesh axis: ``Shard(i)`` where dim i names the
    axis, ``Replicate()`` elsewhere (the reference's ``NamedSharding``)."""
    return mesh_placements(spec, mesh_spec(mesh).axis_names)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a leaf lives: a ``DeviceMesh`` and one placement per mesh
    axis (a leaf of a placement tree, the reference's ``NamedSharding``)."""

    mesh: DeviceMesh
    placements: tuple


def to_shardings(spec_tree, mesh: DeviceMesh):
    """A tree of ``Layout``s from a tree of specs (None leaves stay None)."""
    return _map_specs(
        lambda _, s: None if s is None else Layout(
            mesh, tuple(to_placements(s, mesh))), spec_tree)


def distribute_tree(tree, specs, mesh: DeviceMesh):
    """``tree``'s tensors as DTensors placed by ``specs`` (a tree of the
    same structure; non-tensor leaves such as the step count pass
    through)."""
    flat = dict(_spec_items(specs))

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, to_placements(flat[path], mesh))

    return tree_map(place, tree, with_path=True)


def _spec_items(specs, path=()):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_items(v, path + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_items(v, path + (i,))
    else:
        yield path, specs


def place_cache(cache, cfg: ArchConfig, rt: Runtime, B: int):
    """A decode cache of B sequences placed by ``cache_specs`` on
    ``rt.sc.device_mesh`` (``forward_prefill``'s cache on a mesh)."""
    return distribute_tree(cache, cache_specs(cache, cfg, rt.sc, B),
                           rt.sc.device_mesh)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh: Union[MeshSpec, DeviceMesh]) -> tuple:
    """The shape of the first rank's shard (the largest, as DTensor splits
    a dim: ceil at each axis, major axis first)."""
    sizes = mesh_spec(mesh).shape
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in names:
            n = -(-n // sizes[a])
        out.append(n)
    return tuple(out)


def resident_bytes(tree, specs, mesh: Union[MeshSpec, DeviceMesh]) -> int:
    """Bytes of the first rank's shards of every tensor in ``tree``."""
    flat = dict(_spec_items(specs))
    total = 0
    for path, leaf in tree_items(tree):
        if isinstance(leaf, torch.Tensor):
            total += math.prod(local_shape(leaf.shape, flat[path], mesh)) \
                * leaf.element_size()
    return total


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of the DTensors in ``tree``."""
    total = 0
    for _, leaf in tree_items(tree):
        if isinstance(leaf, torch.Tensor):
            loc = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            total += loc.numel() * loc.element_size()
    return total

