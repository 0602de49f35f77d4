"""Stand-ins on the ``meta`` device for every model input and state (no
allocation).

The counterpart of ``repro.launch.inputs``: the same shapes and dtypes as
the reference's ``ShapeDtypeStruct``s for the train, prefill and decode
inputs, the cache included, plus ``abstract_params`` / ``abstract_state``
for the parameters and the AdamW state.  ``init_params`` draws on its
generator's device, so the parameter tree is made under
``FakeTensorMode`` (no memory, no arithmetic) and given back on ``meta``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.tree import tree_map

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ArchConfig, rt: Runtime) -> dict:
    """``init_params``'s tree, every leaf an empty ``meta`` tensor of its
    shape and dtype."""
    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg, rt)
    return tree_map(lambda t: _meta(t.shape, t.dtype), fake)


def abstract_state(cfg: ArchConfig, rt: Runtime) -> dict:
    """``init_train_state``'s tree on ``meta``: parameters, fp32 moments,
    step 0."""
    params = abstract_params(cfg, rt)
    f32 = lambda t: _meta(t.shape, torch.float32)  # noqa: E731
    return {"params": params, "opt": {"m": tree_map(f32, params),
                                      "v": tree_map(f32, params),
                                      "step": 0}}


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      rt: Runtime) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    if cfg.vision_tokens:
        batch["patches"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                                 rt.compute_dtype)
    if cfg.encoder_layers:
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                rt.compute_dtype)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                        rt: Runtime) -> Dict[str, torch.Tensor]:
    batch = train_batch_specs(cfg, shape, rt)
    del batch["labels"]
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime
                       ) -> Tuple[torch.Tensor, list, torch.Tensor]:
    """(tokens, cache, cache_len) stand-ins for one decode step."""
    B, S = shape.global_batch, shape.seq_len
    return (_meta((B, 1), torch.int32), init_cache(cfg, rt, B, S, META),
            _meta((), torch.int32))


def input_specs(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime):
    """Public entry: the abstract inputs of the step this shape runs."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, rt)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape, rt)}
    tokens, cache, cache_len = decode_input_specs(cfg, shape, rt)
    return {"tokens": tokens, "cache": cache, "cache_len": cache_len}
