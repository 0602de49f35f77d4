"""Argument checks shared by the kernel wrappers: a wrapper validates every
tensor on the host before it hands a pointer to a kernel.  A kernel takes
one rank's local tensor: a mesh path hands it each rank's shard through
``local_map``, and a DTensor given to a wrapper raises."""
from __future__ import annotations

import sys

import torch

MAX_DP = 128


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  ``torch.distributed.tensor`` loads the
    compiler stack (seconds), so it is imported only by code that builds
    DTensors: until then none exists, and the plain path never pays."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def check_tensor(name: str, t: torch.Tensor, shape, device: torch.device,
                 dtype=torch.float32) -> None:
    if is_dtensor(t):
        raise TypeError(f"{name} is a DTensor: the kernels take one rank's "
                        "local shard (call them through local_map)")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_dp(dp: int) -> None:
    if dp % 8 or not 0 < dp <= MAX_DP:
        raise ValueError(f"padded dim {dp} must be a multiple of 8 in "
                         f"[8, {MAX_DP}]")


def check_aligned(**tensors) -> None:
    """Raise unless each tensor starts on a 16-byte boundary: kernels that
    copy their inputs in 16-byte pieces need it (a contiguous view that
    starts inside its storage may not)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
