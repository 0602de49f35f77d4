"""Production and test meshes, ``ShardCtx`` wiring, and the ``DeviceMesh``
a sharded step runs on.

The counterpart of ``repro.launch.mesh``.  ``make_production_mesh`` and
``make_test_mesh`` return ``MeshSpec``s, axis names and sizes only, so the
layout rules and the analytic dry run need no process group.  The
single-pod mesh is (data=16, model=16) = 256 devices; the multi-pod mesh
adds a leading pod axis: (pod=2, data=16, model=16) = 512 devices, where
"pod" is pure data parallelism (parameters replicated across pods, the
batch sharded over pod x data).  ``device_mesh`` makes the
``torch.distributed`` ``DeviceMesh`` of a spec over an initialised process
group of exactly its size; it never shrinks the mesh and never falls back
to one device.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.models.common import MeshSpec, ShardCtx


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")) -> MeshSpec:
    """Small mesh for CI-scale sharding tests."""
    return MeshSpec(tuple(axes), tuple(shape))


def device_mesh(spec: MeshSpec, device_type: str) -> DeviceMesh:
    """The ``DeviceMesh`` of ``spec`` (same axis names and sizes) on
    ``device_type`` ("cuda", or "cpu" with gloo or the fake process group).
    Raises unless a process group is initialised with exactly
    ``spec.size`` ranks."""
    if not dist.is_initialized():
        raise RuntimeError(f"a {spec.size}-rank mesh needs an initialised "
                           "process group")
    world = dist.get_world_size()
    if world != spec.size:
        raise RuntimeError(f"mesh {dict(spec.shape)} needs {spec.size} "
                           f"ranks; the process group has {world}")
    return init_device_mesh(device_type, spec.sizes,
                            mesh_dim_names=spec.axis_names)


def mesh_spec(mesh: Union[MeshSpec, DeviceMesh]) -> MeshSpec:
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def make_shard_ctx(mesh: Optional[Union[MeshSpec, DeviceMesh]],
                   seq_parallel: bool = False,
                   flat_dp: bool = False,
                   shard_lstm_r: bool = False) -> ShardCtx:
    """The reference's axis resolution over ``mesh`` (a ``MeshSpec``, or a
    ``DeviceMesh``, which ``constrain`` then places on).

    flat_dp: treat the model axis as extra data parallelism (and ZeRO-shard
    parameters over data x model).  The right layout for models too small
    to tensor-parallelize (e.g. xlstm-1.3b on a 256-device mesh), where TP
    would replicate all attention-free compute 16x."""
    if mesh is None:
        return ShardCtx.null()
    dm = None if isinstance(mesh, MeshSpec) else mesh
    spec = mesh_spec(mesh)
    axes = spec.axis_names
    if flat_dp:
        return ShardCtx(
            mesh=spec,
            dp_axes=tuple(a for a in ("pod", "data", "model") if a in axes),
            tp_axis=None,
            fsdp_axis=tuple(a for a in ("data", "model") if a in axes),
            seq_parallel=False,
            shard_lstm_r=shard_lstm_r,
            device_mesh=dm,
        )
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return ShardCtx(
        mesh=spec,
        dp_axes=dp,
        tp_axis="model" if "model" in axes else None,
        fsdp_axis="data" if "data" in axes else None,
        seq_parallel=seq_parallel,
        shard_lstm_r=shard_lstm_r,
        device_mesh=dm,
    )
