"""Dispatch for the product-Parzen (TPE) scoring kernels.

A CUDA tensor launches the hand-written kernel in ``csrc/tpe_kde.cu`` (built
at first use, see ``repro_torch.kernels.build``); a CPU tensor runs the plain
version in ``ref``.  Nothing falls back: a CUDA call that cannot build or
launch raises.  ``launches`` counts kernel launches per wrapper (CPU calls
leave it alone), so a run can show that its main path went through the
kernels; ``kernel_attrs`` reports each kernel's registers and shared memory.

``parzen_logdens`` is the numpy-facing counterpart of the JAX package's
``repro.kernels.tpe_kde.ops.parzen_logdens``: it pads unpadded inputs and
scores them on ``device``.  The fused proposal (``repro_torch.core.tpe``)
calls ``tpe_scores`` directly with padded buffers.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.sanitizers import to_device, to_host
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.checks import check_dp, check_tensor
from repro_torch.kernels.tpe_kde import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "tpe_kde.cu",)

launches = {"tpe_scores": 0, "parzen_logdens": 0}
CANDIDATES_PER_THREAD = (8, 4, 2, 1)   # the kernels' instantiations

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    return bind(build.load("tpe_kde", SOURCES))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument types on a built library (also one
    built from another tree's source, to compare kernels in one process)."""
    if not getattr(lib, "_typed", False):
        lib.tpe_scores.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.tpe_scores.restype = _I
        lib.tpe_parzen_logdens.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.tpe_parzen_logdens.restype = _I
        lib.tpe_kde_attrs.argtypes = [_I, _I, _P]
        lib.tpe_kde_attrs.restype = _I
        lib.tpe_error_string.argtypes = [_I]
        lib.tpe_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def kernel_attrs() -> dict:
    """What each TPE kernel takes on the card at each count of candidates
    per thread R: {"<kernel> R=<r>": (registers per thread, local-memory
    bytes per thread (spills), static shared memory per block)}, from
    ``cudaFuncGetAttributes``."""
    lib = library()
    out = (ctypes.c_int * 3)()
    attrs = {}
    for parzen, name in enumerate(("tpe_scores", "parzen_logdens")):
        for r in CANDIDATES_PER_THREAD:
            _raise_on(lib, lib.tpe_kde_attrs(parzen, r, out),
                      f"{name} attributes")
            attrs[f"{name} R={r}"] = tuple(out)
    return attrs


def pad_dims(d: int) -> int:
    """Pad the encoded dim to a multiple of 8 (at least 8)."""
    return max(8, int(math.ceil(d / 8)) * 8)


def pad_rows(n: int, multiple: int) -> int:
    return max(multiple, int(math.ceil(n / multiple)) * multiple)


def _check_common(cands, pts, scal, n_live, d_true):
    B, S, dp = cands.shape
    na = pts.shape[1]
    dev = cands.device
    check_dp(dp)
    if not 0 < d_true <= dp:
        raise ValueError(f"d_true={d_true} must lie in [1, {dp}]")
    for name, t, shape in (("cands", cands, (B, S, dp)),
                           ("pts", pts, (B, na, dp)),
                           ("scal", scal, (B, 4))):
        check_tensor(name, t, shape, dev)
    check_tensor("n_live", n_live, (B,), dev, torch.int32)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the TPE kernels run on cuda or cpu, not {dev}")
    return B, S, na, dp, dev


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.tpe_error_string(err).decode()}")


def tpe_scores(cands, pts, a, wg, wb, scal, n_live, *, d_true: int):
    """(B, S) l/g log-ratio scores of every candidate of every study in one
    launch.

    cands (B, S, dp); pts and a (B, na, dp), ``a`` the per-row per-dim
    ``1/(2 bw_j^2)`` of the row's split; wg, wb (B, na) the 0/1 split
    memberships; scal (B, 4) = [1/n_g, 1/n_b, 0, 0]; n_live (B,) int32, the
    rows that may carry weight (observed, then pending).  All float32 but
    ``n_live`` and contiguous on one device."""
    B, S, na, dp, dev = _check_common(cands, pts, scal, n_live, d_true)
    for name, t, shape in (("a", a, (B, na, dp)), ("wg", wg, (B, na)),
                           ("wb", wb, (B, na))):
        check_tensor(name, t, shape, dev)
    if dev.type == "cpu":
        return ref.tpe_scores_ref(cands, pts, a, wg, wb, scal, n_live,
                                  d_true=d_true)
    lib = library()
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    err = lib.tpe_scores(
        cands.data_ptr(), pts.data_ptr(), a.data_ptr(), wg.data_ptr(),
        wb.data_ptr(), scal.data_ptr(), n_live.data_ptr(), out.data_ptr(),
        B, S, na, dp, d_true, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "tpe_scores")
    launches["tpe_scores"] += 1
    return out


def parzen_logdens_bank(cands, pts, w, scal, n_live, *, d_true: int):
    """(B, S) product-Parzen log-density of cands (B, S, dp) under the
    masked point set pts (B, na, dp), w (B, na); scal (B, 4) =
    [1/(2 bw^2), 1/n, 0, 0]; n_live (B,) int32."""
    B, S, na, dp, dev = _check_common(cands, pts, scal, n_live, d_true)
    check_tensor("w", w, (B, na), dev)
    if dev.type == "cpu":
        return ref.parzen_logdens_ref(cands, pts, w, scal, n_live,
                                      d_true=d_true)
    lib = library()
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    err = lib.tpe_parzen_logdens(
        cands.data_ptr(), pts.data_ptr(), w.data_ptr(), scal.data_ptr(),
        n_live.data_ptr(), out.data_ptr(), B, S, na, dp, d_true,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "parzen_logdens")
    launches["parzen_logdens"] += 1
    return out


def parzen_logdens(cands, pts, *, bw=None,
                   device: DeviceLike = None) -> np.ndarray:
    """(m,) product-Parzen log-density of cands (m, d) under pts (n, d).

    ``bw`` defaults to the Scott-rule bandwidth the TPE strategy uses
    (count- and dim-dependent scalar).  Pads d to a multiple of 8 and n to
    a multiple of 8; padded rows carry weight 0 and padded dims are never
    read, so padding is exact.  Runs on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    cands = np.asarray(cands, np.float32)
    pts = np.asarray(pts, np.float32)
    m, d = cands.shape
    n = pts.shape[0]
    dp = pad_dims(d)
    npad = pad_rows(n, 8)
    cb = np.zeros((1, m, dp), np.float32)
    cb[0, :, :d] = cands
    xb = np.zeros((1, npad, dp), np.float32)
    xb[0, :n, :d] = pts
    w = np.zeros((1, npad), np.float32)
    w[0, :n] = 1.0
    if bw is None:
        bw = float(ref.scott_bandwidth(torch.tensor(float(n)), d))
    inv2bw2 = np.float32(0.5 / (float(bw) ** 2))
    scal = np.array([[inv2bw2, 1.0 / max(n, 1), 0.0, 0.0]], np.float32)

    def t(x):
        return to_device(x, dev)

    out = parzen_logdens_bank(t(cb), t(xb), t(w), t(scal),
                              t(np.array([n], np.int32)), d_true=d)
    return to_host(out[0])   # one exit
