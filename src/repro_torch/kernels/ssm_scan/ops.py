"""Dispatch for the selective-scan kernels, forward and backward.

``selective_scan`` is the counterpart of ``repro.kernels.ssm_scan.ops.
selective_scan`` (Abar, Bx (B, S, di, N) and Cc (B, S, N), all fp32 ->
y (B, S, di) fp32), with the final state h_S (B, di, N) as a second output
on request (``return_state``):
  * a CUDA tensor runs the kernel in ``csrc/ssm_scan.cu``; under grad it
    runs through ``SelectiveScan``, a ``torch.autograd.Function`` whose
    backward is the kernel in ``csrc/ssm_scan_bwd.cu`` (built at first use,
    see ``repro_torch.kernels.build``);
  * a CPU tensor runs the plain version ``ref.ssm_scan_ref``, which
    autograd differentiates;
  * anything else raises.
Nothing falls back: a CUDA call that cannot build or launch raises.
``launches`` counts the calls of each kernel entry point (CPU calls leave it
alone), so a run can show that its training steps went through both.

Unlike the Pallas kernel, which needs S a multiple of its chunk and di of
its channel block, the kernels take any S and di.  The state size N is a
power of two up to 32 (one channel's states on N lanes of a warp), on both
devices.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check_tensor
from repro_torch.kernels.ssm_scan import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "ssm_scan.cu", _CSRC / "ssm_scan_bwd.cu")
MAX_STATE = 32

launches = {"ssm_scan": 0, "ssm_scan_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = build.load("ssm_scan", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.ssm_scan_fwd.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.ssm_scan_fwd.restype = _I
        lib.ssm_scan_bwd.argtypes = [_P] * 10 + [_I] * 4 + [_P]
        lib.ssm_scan_bwd.restype = _I
        lib.ssm_scan_partial_floats.argtypes = [_I] * 4
        lib.ssm_scan_partial_floats.restype = ctypes.c_longlong
        lib.ssm_scan_bwd_smem_bytes.argtypes = [_I]
        lib.ssm_scan_bwd_smem_bytes.restype = _I
        lib.ssm_scan_chunk.argtypes = []
        lib.ssm_scan_chunk.restype = _I
        lib.ssm_error_string.argtypes = [_I]
        lib.ssm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check_inputs(Abar, Bx, Cc):
    """Raise on what the kernels do not take; returns (B, S, di, N)."""
    if Abar.dim() != 4 or Cc.dim() != 3:
        raise ValueError("Abar and Bx must be (B, S, di, N), Cc (B, S, N)")
    B, S, di, N = Abar.shape
    dev = Abar.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the scan kernels run on cuda or cpu, not {dev}")
    check_tensor("Abar", Abar, (B, S, di, N), dev)
    check_tensor("Bx", Bx, (B, S, di, N), dev)
    check_tensor("Cc", Cc, (B, S, N), dev)
    if N > MAX_STATE or N & (N - 1) or N == 0:
        raise ValueError(f"state size {N} must be a power of two in "
                         f"[1, {MAX_STATE}]")
    if B * S * di == 0:
        raise ValueError("empty batch, sequence or channels")
    return B, S, di, N


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ssm_error_string(err).decode()}")


def _on_card(Abar, what: str) -> None:
    if Abar.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def forward(Abar, Bx, Cc, return_state: bool = False, keep: bool = False):
    """The forward kernel on CUDA tensors: (y, h_S, chunk states); the final
    state h_S (B, di, N) only with ``return_state`` (prefill), the
    chunk-boundary states (B, ceil(S / 64), di, N) that the backward reads
    only with ``keep`` (training); None otherwise."""
    B, S, di, N = check_inputs(Abar, Bx, Cc)
    _on_card(Abar, "the scan kernel")
    lib = library()
    y = Abar.new_empty(B, S, di)
    hS = Abar.new_empty(B, di, N) if return_state else None
    nK = -(-S // lib.ssm_scan_chunk())
    hck = Abar.new_empty(B, nK, di, N) if keep else None
    err = lib.ssm_scan_fwd(
        Abar.data_ptr(), Bx.data_ptr(), Cc.data_ptr(), y.data_ptr(),
        _ptr(hS), _ptr(hck), B, S, di, N, _stream(Abar))
    _raise(lib, err, "ssm_scan")
    launches["ssm_scan"] += 1
    return y, hS, hck


def backward(Abar, Bx, Cc, hck, dy, dhS=None):
    """The backward kernel on CUDA tensors: (dAbar, dBx, dCc) for dy (B, S,
    di) and an optional dh_S (B, di, N), from the forward's inputs and
    chunk states."""
    B, S, di, N = check_inputs(Abar, Bx, Cc)
    _on_card(Abar, "the scan kernel")
    lib = library()
    dev = Abar.device
    check_tensor("dy", dy, (B, S, di), dev)
    check_tensor("chunk states", hck, (B, -(-S // lib.ssm_scan_chunk()), di,
                                       N), dev)
    if dhS is not None:
        check_tensor("dh_S", dhS, (B, di, N), dev)
    dA, dX = torch.empty_like(Abar), torch.empty_like(Bx)
    dC = torch.empty_like(Cc)
    part = Abar.new_empty(lib.ssm_scan_partial_floats(B, S, di, N))
    err = lib.ssm_scan_bwd(
        Abar.data_ptr(), Bx.data_ptr(), Cc.data_ptr(), dy.data_ptr(),
        _ptr(dhS), hck.data_ptr(),
        dA.data_ptr(), dX.data_ptr(), dC.data_ptr(), part.data_ptr(), B, S,
        di, N, _stream(Abar))
    _raise(lib, err, "ssm_scan_bwd")
    launches["ssm_scan_bwd"] += 1
    return dA, dX, dC


class SelectiveScan(torch.autograd.Function):
    """y (and h_S with ``return_state``) of the recurrence by the forward
    kernel, their gradient by the backward kernel (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, Abar, Bx, Cc, return_state):
        y, hS, hck = forward(Abar, Bx, Cc, return_state, keep=True)
        ctx.save_for_backward(Abar, Bx, Cc, hck)
        ctx.set_materialize_grads(False)
        return (y, hS) if return_state else y

    @staticmethod
    def backward(ctx, dy, dhS=None):
        Abar, Bx, Cc, hck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(Abar.shape[:3], dtype=torch.float32,
                             device=Abar.device)
        if dhS is not None:
            dhS = dhS.to(torch.float32).contiguous()
        grads = backward(Abar, Bx, Cc, hck,
                         dy.to(torch.float32).contiguous(), dhS)
        return (*grads, None)


def selective_scan(Abar, Bx, Cc, return_state: bool = False):
    """y (B, S, di) fp32 of the scan, and h_S (B, di, N) with
    ``return_state``; differentiable on both devices."""
    check_inputs(Abar, Bx, Cc)
    if Abar.device.type == "cpu":
        return ref.ssm_scan_ref(Abar, Bx, Cc, return_state=return_state)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (Abar, Bx, Cc)):
        return SelectiveScan.apply(Abar, Bx, Cc, return_state)
    y, hS, _ = forward(Abar, Bx, Cc, return_state)
    return (y, hS) if return_state else y
