"""Dispatch for the flash-attention kernel.

``sdpa`` is the counterpart of ``repro.kernels.flash_attention.ops.sdpa`` in
the model layout, q (B, Sq, H, hd) and k/v (B, Sk, KV, hd).  A CUDA tensor
launches the hand-written kernel in ``csrc/flash_attention.cu`` (built at
first use, see ``repro_torch.kernels.build``); a CPU tensor runs the plain
version in ``ref``.  Nothing falls back: a CUDA call that cannot build or
launch raises.  ``launches`` counts kernel launches (CPU calls leave it
alone), so a run can show that its prefill went through the kernel.

The kernel has no backward yet (ROADMAP queue 1 item 13c), and its output
carries no ``grad_fn``: on a CUDA tensor, a call under grad with an input
that requires grad raises ``NotImplementedError`` rather than drop the
gradient.  On the CPU autograd differentiates the plain version.

Unlike the Pallas kernel, which needs Sq and Sk to be multiples of its
tiles, the kernel takes any lengths: it masks its ragged last tiles.  Head
sizes are multiples of 8 up to 128 (the kernel's widest tile), on both
devices, so the reduced test configs run the same checks as the full ones.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check_tensor
from repro_torch.kernels.flash_attention import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)

launches = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = build.load("flash_attention", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = ([_P] * 4 + [_I] * 6
                                            + [ctypes.c_float, _I, _I, _P])
        lib.flash_attention_fwd.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I]
        lib.flash_attention_smem_bytes.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(q, k, v, causal: bool):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, Sq, H, hd) and k, v (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        "float32 or bfloat16")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    check_tensor("q", q, (B, Sq, H, hd), dev, q.dtype)
    check_tensor("k", k, (B, Sk, KV, hd), dev, q.dtype)
    check_tensor("v", v, (B, Sk, KV, hd), dev, q.dtype)
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if Sk == 0:
        raise ValueError("no keys to attend to")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got Sq={Sq} "
                         f"Sk={Sk}")
    return B, Sq, Sk, H, KV, hd


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, hd) attention output in q's dtype; q (B, Sq, H, hd),
    k and v (B, Sk, KV, hd), one dtype (float32 or bfloat16), contiguous,
    on one device.  The causal mask is k <= q + (Sk - Sq)."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v, causal)
    if not _on_card(q):
        return ref.attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet (ROADMAP queue 1 "
            "item 13c): the kernel's output would carry no gradient")
    lib = library()
    out = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, hd, hd ** -0.5, int(q.dtype == torch.bfloat16), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           f"{lib.flash_error_string(err).decode()}")
    launches["flash_attention"] += 1
    return out
