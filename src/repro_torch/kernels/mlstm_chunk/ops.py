"""Dispatch for the chunkwise mLSTM kernels, forward and backward.

``mlstm_mixer`` is the counterpart of ``repro.kernels.mlstm_chunk.ops.
mlstm_mixer`` (q, k, v (B, NH, S, dh), logi, logf (B, NH, S), all fp32):
  * a CUDA tensor runs ``MlstmChunk``, a ``torch.autograd.Function`` whose
    forward is the kernel in ``csrc/mlstm_chunk.cu`` and whose backward is
    the kernel in ``csrc/mlstm_chunk_bwd.cu`` (built at first use, see
    ``repro_torch.kernels.build``);
  * a CPU tensor runs the plain chunkwise version ``ref.mlstm_chunkwise``,
    which autograd differentiates;
  * anything else raises.
Nothing falls back: a CUDA call that cannot build or launch raises.  Both
kernels run their products of two tiles on the tensor cores (mma.sync in
split TF32: three TF32 products for each fp32 one, near fp32 accuracy) with
tiles copied by cp.async into a two-stage ring; ``kernel_attrs`` reports
each stage kernel's registers and shared memory.
``launches`` counts the calls of each kernel entry point (one forward or
backward call enqueues that direction's stages; CPU calls leave it alone),
so a run can show that its training steps went through both kernels.

The chunk is 64 tokens, as the Pallas kernel takes it (``min(64, S)``); any
length is taken, the last chunk masked where the reference needs S a
multiple of the chunk.  Head sizes are multiples of 64 on both devices.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check_aligned, check_tensor
from repro_torch.kernels.mlstm_chunk import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "mlstm_chunk.cu", _CSRC / "mlstm_chunk_bwd.cu")
HEAD_TILE = 64

launches = {"mlstm_chunk": 0, "mlstm_chunk_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def library() -> ctypes.CDLL:
    lib = build.load("mlstm_chunk", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.mlstm_chunk_fwd.argtypes = [_P] * 8 + [_I] * 3 + [_P]
        lib.mlstm_chunk_fwd.restype = _I
        lib.mlstm_chunk_bwd.argtypes = [_P] * 13 + [_I] * 3 + [_P]
        lib.mlstm_chunk_bwd.restype = _I
        lib.mlstm_chunk_workspace_floats.argtypes = [_I] * 4
        lib.mlstm_chunk_workspace_floats.restype = _LL
        lib.mlstm_chunk_gates_floats.argtypes = [_I] * 2
        lib.mlstm_chunk_gates_floats.restype = _LL
        lib.mlstm_chunk_attrs.argtypes = [_I, _P]
        lib.mlstm_chunk_attrs.restype = _I
        lib.mlstm_error_string.argtypes = [_I]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


STAGE_KERNELS = ("scan", "scan reverse", "intra", "intra backward", "out",
                 "dqk", "dv")


def kernel_attrs() -> dict:
    """What each tensor-core stage kernel takes on the card: {kernel:
    (registers per thread, local-memory bytes per thread (spills), static +
    dynamic shared memory per block)}, from ``cudaFuncGetAttributes``."""
    lib = library()
    out = (ctypes.c_int * 3)()
    attrs = {}
    for which, name in enumerate(STAGE_KERNELS):
        _raise(lib, lib.mlstm_chunk_attrs(which, out),
               f"mlstm {name} attributes")
        attrs[name] = tuple(out)
    return attrs


def check_inputs(q, k, v, logi, logf):
    """Raise on what the kernels do not take; returns (B, NH, S, dh)."""
    if q.dim() != 4:
        raise ValueError("q, k, v must be (B, NH, S, dh)")
    B, NH, S, dh = q.shape
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the mLSTM kernels run on cuda or cpu, not {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, (B, NH, S, dh), dev)
    for name, t in (("logi", logi), ("logf", logf)):
        check_tensor(name, t, (B, NH, S), dev)
    if dh % HEAD_TILE or dh == 0:
        raise ValueError(f"head dim {dh} must be a positive multiple of "
                         f"{HEAD_TILE}")
    if S == 0 or B * NH == 0:
        raise ValueError("empty sequence or batch")
    return B, NH, S, dh


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.mlstm_error_string(err).decode()}")


def forward(q, k, v, logi, logf):
    """The forward kernel on CUDA tensors: (h, gates), gates being the
    per-token and per-chunk gate terms the backward reads."""
    B, NH, S, dh = check_inputs(q, k, v, logi, logf)
    check_aligned(q=q, k=k, v=v)
    if q.device.type != "cuda":
        raise ValueError("the mLSTM kernels take CUDA tensors")
    lib = library()
    BH = B * NH
    h = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    gates = torch.empty(lib.mlstm_chunk_gates_floats(BH, S), **f32)
    ws = torch.empty(lib.mlstm_chunk_workspace_floats(BH, S, dh, 0), **f32)
    err = lib.mlstm_chunk_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              logi.data_ptr(), logf.data_ptr(), h.data_ptr(),
                              gates.data_ptr(), ws.data_ptr(), BH, S, dh,
                              _stream(q))
    _raise(lib, err, "mlstm_chunk")
    launches["mlstm_chunk"] += 1
    return h, gates


def backward(q, k, v, logi, h, gates, g):
    """The backward kernel on CUDA tensors: (dq, dk, dv, dlogi, dlogf) for
    the upstream gradient g = dL/dh, from the forward's inputs, output h and
    gates."""
    B, NH, S, dh = check_inputs(q, k, v, logi, logi)
    check_tensor("h", h, q.shape, q.device)
    check_tensor("dh", g, q.shape, q.device)
    check_aligned(q=q, k=k, v=v, h=h, dh=g)
    if q.device.type != "cuda":
        raise ValueError("the mLSTM kernels take CUDA tensors")
    lib = library()
    BH = B * NH
    check_tensor("gates", gates, (lib.mlstm_chunk_gates_floats(BH, S),),
                 q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dli, dlf = torch.empty_like(logi), torch.empty_like(logi)
    ws = torch.empty(lib.mlstm_chunk_workspace_floats(BH, S, dh, 1),
                     dtype=torch.float32, device=q.device)
    err = lib.mlstm_chunk_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
        h.data_ptr(), g.data_ptr(), gates.data_ptr(), ws.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
        dlf.data_ptr(), BH, S, dh, _stream(q))
    _raise(lib, err, "mlstm_chunk_bwd")
    launches["mlstm_chunk_bwd"] += 1
    return dq, dk, dv, dli, dlf


class MlstmChunk(torch.autograd.Function):
    """h = mlstm_chunkwise(q, k, v, logi, logf) by the forward kernel, its
    gradient by the backward kernel (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf):
        h, gates = forward(q, k, v, logi, logf)
        ctx.save_for_backward(q, k, v, logi, h, gates)
        return h

    @staticmethod
    def backward(ctx, g):
        q, k, v, logi, h, gates = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if g.data_ptr() % 16:       # a view inside its storage: copy it
            g = g.clone()
        return backward(q, k, v, logi, h, gates, g)


def mlstm_mixer(q, k, v, logi, logf):
    """h (B, NH, S, dh) fp32 of the chunkwise mLSTM with 64-token chunks;
    differentiable on both devices."""
    check_inputs(q, k, v, logi, logf)
    if q.device.type == "cpu":
        return ref.mlstm_chunkwise(q, k, v, logi, logf, chunk=ref.CHUNK)
    return MlstmChunk.apply(q, k, v, logi, logf)
