"""Carry state from the JAX package into the port.

The tuner's state is the study ledger (carried by the shared ``.npz``
checkpoint format, see ``StudyBank.load``) and the GP observation stage.
``bank_state_from_numpy`` takes the observation-stage arrays as
``repro.core.StudyBank._obs_stage`` caches them, fetched to numpy, and
returns the port's tensors under the same names, ready for
``gp.bank_pick`` / ``gp.bank_absorb``.

The model stack's state is its parameters: ``model_params_from_numpy``
takes the JAX package's ``init_params`` pytree, fetched to numpy, and
returns the port's per-layer parameters, so that both packages compute on
the same weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import check_supported

BANK_STATE_KEYS = ("Xs", "z", "mask", "L", "Linv", "ls", "var", "noise")


def bank_state_from_numpy(arrays: Dict[str, np.ndarray],
                          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """float32, contiguous tensors on ``device`` for every key of
    ``BANK_STATE_KEYS``: Xs (B, na, dp), z and mask (B, na), L and Linv
    (B, na, na), ls (B, d), var and noise (B,)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(arrays[k], np.float32),
                               device=dev).contiguous()
            for k in BANK_STATE_KEYS}


def model_params_from_numpy(params_np: Dict[str, Any], cfg: ArchConfig,
                            rt: Runtime,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's ``init_params`` pytree
    with numpy leaves (float32, or the bfloat16 that JAX fetches; either is
    cast to ``rt.param_dtype``).  The leading ``n_periods`` axis of
    ``params_np["blocks"]["pos0"]`` becomes the list ``params["blocks"]``,
    one dict per layer."""
    check_supported(cfg)
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32),
                            device=dev).to(rt.param_dtype)

    def tree(node, i=None):
        if isinstance(node, dict):
            return {k: tree(v, i) for k, v in node.items()}
        return tensor(node if i is None else np.asarray(node)[i])

    out = {k: tree(v) for k, v in params_np.items() if k != "blocks"}
    out["blocks"] = [tree(params_np["blocks"]["pos0"], i)
                     for i in range(cfg.n_periods)]
    return out
