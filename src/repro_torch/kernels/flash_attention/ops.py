"""Dispatch for the flash-attention kernels, forward and backward.

``sdpa`` is the counterpart of ``repro.kernels.flash_attention.ops.sdpa`` in
the model layout, q (B, Sq, H, hd) and k/v (B, Sk, KV, hd):
  * a CUDA tensor launches the hand-written kernel in
    ``csrc/flash_attention.cu`` (bf16 inputs: on tensor cores; fp32: on
    FMAs, the parity runs' path); under grad with an input that requires
    grad it runs through ``FlashAttention``, a ``torch.autograd.Function``
    whose forward also keeps the row log-sum-exp and whose backward is the
    kernel in ``csrc/flash_attention_bwd.cu`` (both built at first use, see
    ``repro_torch.kernels.build``);
  * a CPU tensor runs the plain version in ``ref``, which autograd
    differentiates.
Nothing falls back: a CUDA call that cannot build or launch raises.
``launches`` counts the calls of each kernel entry point (CPU calls leave
it alone), so a run can show that its prefill and its training steps went
through the kernels.  ``sdpa_lse`` and ``sdpa_bwd`` are the two kernels
without autograd, on either device (the plain versions on the CPU): the
pieces that the sharded attention of ``models.attention`` combines.

Every entry point takes ``causal_offset``, the causal mask's diagonal: key
j is seen by query i where j <= i + causal_offset.  None means Sk - Sq (the
mask aligned bottom-right), which every unsharded call uses; a rank's shard
of the query rows or of the keys moves it by the shard's start, and may
make it negative (rows that see no key: output 0, log-sum-exp +inf) or let
Sq exceed Sk.

A call with no query row (B or Sq 0, as an uneven split of the rows can
leave a rank) launches nothing: the forward returns its empty output, the
backward zero dk and dv.

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

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_bwd.cu")
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)

launches = {"flash_attention": 0, "flash_attention_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = build.load("flash_attention", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = ([_P] * 5 + [_I] * 6
                                            + [ctypes.c_float, _I, _I, _I,
                                               _P])
        lib.flash_attention_fwd.restype = _I
        lib.flash_attention_bwd.argtypes = ([_P] * 10 + [_I] * 6
                                            + [ctypes.c_float, _I, _I, _I,
                                               _P])
        lib.flash_attention_bwd.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I, _I]
        lib.flash_attention_bwd_smem_bytes.argtypes = [_I] * 3
        lib.flash_attention_fwd_attrs.argtypes = [_I, _I, _P]
        lib.flash_attention_bwd_attrs.argtypes = [_I, _I, _I, _P]
        for fn in (lib.flash_attention_smem_bytes,
                   lib.flash_attention_bwd_smem_bytes,
                   lib.flash_attention_fwd_attrs,
                   lib.flash_attention_bwd_attrs):
            fn.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(q, k, v, causal: bool, causal_offset=None):
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
    if causal and causal_offset is None and Sq > Sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got Sq={Sq} "
                         f"Sk={Sk}, unless a causal_offset is given")
    return B, Sq, Sk, H, KV, hd


def kernel_attrs(hd: int) -> dict:
    """What each kernel of the suite takes on the card at head size hd:
    {kernel: (registers per thread, local-memory bytes per thread (spills),
    static + dynamic shared memory per block)}, from
    ``cudaFuncGetAttributes`` and the launch's dynamic size."""
    lib = library()
    out = (ctypes.c_int * 3)()
    attrs = {}
    for bf16, dt in ((0, "fp32"), (1, "bf16")):
        for name, call, smem in (
                ("fwd", lambda: lib.flash_attention_fwd_attrs(hd, bf16, out),
                 lib.flash_attention_smem_bytes(hd, bf16)),
                ("bwd dkv",
                 lambda: lib.flash_attention_bwd_attrs(hd, bf16, 0, out),
                 lib.flash_attention_bwd_smem_bytes(hd, bf16, 0)),
                ("bwd dq",
                 lambda: lib.flash_attention_bwd_attrs(hd, bf16, 1, out),
                 lib.flash_attention_bwd_smem_bytes(hd, bf16, 1))):
            _raise(lib, call(), f"flash {name} attributes")
            attrs[f"{dt} {name}"] = (out[0], out[1], out[2] + smem)
    return attrs


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.flash_error_string(err).decode()}")


def forward(q, k, v, causal: bool = True, with_lse: bool = False,
            causal_offset=None):
    """The forward kernel on CUDA tensors: (out, lse), the row
    log-sum-exp (B, H, Sq) fp32 that the backward reads (None unless
    ``with_lse``)."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v, causal, causal_offset)
    if not _on_card(q):
        raise ValueError("the flash kernels take CUDA tensors")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:   # no row to write: nothing is launched
        return out, lse
    lib = library()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, hd,
        hd ** -0.5, int(q.dtype == torch.bfloat16), int(causal),
        ref.diagonal(Sq, Sk, causal_offset), _stream(q))
    _raise(lib, err, "flash_attention")
    launches["flash_attention"] += 1
    return out, lse


def backward(q, k, v, out, lse, dout, causal: bool = True,
             causal_offset=None):
    """The backward kernel on CUDA tensors: (dq, dk, dv) in the inputs'
    dtype for the upstream gradient dout, from the forward's inputs, output
    and log-sum-exp (see ``ref.attention_bwd_ref`` for an output and
    log-sum-exp over more keys than k holds)."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v, causal, causal_offset)
    if not _on_card(q):
        raise ValueError("the flash kernels take CUDA tensors")
    check_tensor("out", out, q.shape, q.device, q.dtype)
    check_tensor("dout", dout, q.shape, q.device, q.dtype)
    check_tensor("lse", lse, (B, H, Sq), q.device)
    if q.numel() == 0:
        # no query row (a rank's empty row shard): no key is seen, and the
        # kernel, which would launch nothing, writes no dk or dv
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    lib = library()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, hd, hd ** -0.5,
        int(q.dtype == torch.bfloat16), int(causal),
        ref.diagonal(Sq, Sk, causal_offset), _stream(q))
    _raise(lib, err, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention by the forward kernel, its gradient by the backward kernel
    (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, causal_offset=None):
        out, lse = forward(q, k, v, causal, with_lse=True,
                           causal_offset=causal_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.causal_offset = causal, causal_offset
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse,
                              g.to(q.dtype).contiguous(), ctx.causal,
                              ctx.causal_offset)
        return dq, dk, dv, None, None


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, causal_offset=None) -> torch.Tensor:
    """(B, Sq, H, hd) attention output in q's dtype; q (B, Sq, H, hd),
    k and v (B, Sk, KV, hd), one dtype (float32 or bfloat16), contiguous,
    on one device.  The causal mask is k <= q + causal_offset (Sk - Sq when
    None).  Differentiable on both devices."""
    _check(q, k, v, causal, causal_offset)
    if not _on_card(q):
        return ref.attention_ref(q, k, v, causal=causal,
                                 offset=causal_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, causal_offset)
    return forward(q, k, v, causal, causal_offset=causal_offset)[0]


def sdpa_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, causal_offset=None):
    """(out, lse (B, H, Sq) fp32): the forward kernel on CUDA tensors, its
    plain version on CPU ones; not differentiable (``sdpa_bwd`` is its
    gradient)."""
    _check(q, k, v, causal, causal_offset)
    if not _on_card(q):
        return ref.attention_lse_ref(q, k, v, causal=causal,
                                     offset=causal_offset)
    return forward(q, k, v, causal, with_lse=True,
                   causal_offset=causal_offset)


def sdpa_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
             causal_offset=None):
    """(dq, dk, dv) for dout from the forward's inputs, output and
    log-sum-exp: the backward kernel on CUDA tensors, its plain version
    (``ref.attention_bwd_ref``) on CPU ones."""
    _check(q, k, v, causal, causal_offset)
    if not _on_card(q):
        return ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                     offset=causal_offset)
    return backward(q, k, v, out, lse, dout, causal, causal_offset)
