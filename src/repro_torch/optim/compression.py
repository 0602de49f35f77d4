"""Gradient compression: int8 quantization with error feedback.

The counterpart of ``repro.optim.compression.ef_quantize`` and
``ef_compress_tree``: per-tensor int8 quantization whose residual is carried
into the next step (error feedback).  ``compressed_psum``, the int8
all-reduce over a mesh axis, is multi-device and comes with the sharding
work (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Tuple

import torch

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
