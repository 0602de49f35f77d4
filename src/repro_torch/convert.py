"""Carry state from the JAX package into the port.

This system has no weights: its state is the study ledger (carried by the
shared ``.npz`` checkpoint format, see ``StudyBank.load``) and the GP
observation stage.  ``bank_state_from_numpy`` takes the observation-stage
arrays as ``repro.core.StudyBank._obs_stage`` caches them, fetched to numpy,
and returns the port's tensors under the same names, ready for
``gp.bank_pick`` / ``gp.bank_absorb``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

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
