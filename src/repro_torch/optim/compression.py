"""Gradient compression: int8 quantization with error feedback, and an int8
all-reduce.

The counterpart of ``repro.optim.compression``.  Two layers:
  * ``ef_quantize`` / ``ef_compress_tree``: per-tensor int8 quantization
    whose residual is carried into the next step (error feedback), the
    numerics transform the train step applies with ``int8_ef``;
  * ``compressed_psum``: an explicit int8 all-reduce over one process
    group (a mesh axis's: ``DeviceMesh.get_group(axis)``), the counterpart
    of the reference's ``shard_map`` one over a named axis.  The wire
    carries one byte an element instead of four.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def ef_quantize(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dequantized int8 approximation, new error-feedback buffer)."""
    target = g.float() + err
    scale = torch.clamp(target.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, target - deq


def ef_compress_tree(grads, ef_state):
    out = tree_map(ef_quantize, grads, ef_state)
    return (tree_map(lambda _, t: t[0], grads, out),
            tree_map(lambda _, t: t[1], grads, out))


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8-on-the-wire sum of ``x`` over the ranks of ``group``.

    Quantize locally, all-gather the int8 payloads and the fp32 scales, and
    sum after dequantization: exact to within each rank's quantization
    error (half its scale an element)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    g = dist.get_world_size(group)
    # gathered along dim 0 of flat buffers (the layout gloo and NCCL take)
    qs = q.new_empty((g * q.numel(),))
    ss = scale.new_empty((g,))
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    return torch.tensordot(ss, qs.view((g,) + tuple(q.shape)).float(),
                           dims=([0], [0]))
