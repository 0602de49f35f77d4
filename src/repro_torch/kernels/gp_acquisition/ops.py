"""Dispatch for the GP-BUCB scoring kernels.

A CUDA tensor launches the hand-written kernels in ``csrc/gp_acquisition.cu``
and ``csrc/fit_grad.cu`` (one library, built at first use, see
``repro_torch.kernels.build``); a CPU tensor runs the plain version in
``ref``.  Nothing falls back: a CUDA call that cannot build or
launch raises.  ``launches`` counts kernel launches per wrapper (CPU calls
leave it alone), so a run can show that its main path went through the
kernels; one ``score_cov`` call enqueues the split of L^-1 into TF32 parts
and the scoring kernel, and counts once; one ``fit_grad`` call enqueues its
two passes, and counts once; ``masked_kernel`` builds the fit's kernel
matrix in one launch.  ``ref.score_cov_split`` is the
scoring kernel's arithmetic for the CPU tests.  ``gp_mean_std`` is the
single-study entry of the strategies' host loop (``HallucinationStrategy``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.sanitizers import to_device, to_host
from repro_torch.kernels import build
from repro_torch.kernels.checks import check_aligned as _check_aligned
from repro_torch.kernels.checks import check_dp as _check_dp
from repro_torch.kernels.checks import check_tensor as _check
from repro_torch.kernels.gp_acquisition import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "gp_acquisition.cu", _CSRC / "fit_grad.cu")
SCORE_COV_KERNELS = ("score_cov_streamed", "score_cov_resident")

launches = {"score_cov": 0, "var_downdate": 0, "masked_kernel": 0,
            "fit_grad": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = build.load("gp_acquisition", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.gp_score_cov.argtypes = [_P] * 11 + [_I] * 4 + [_P]
        lib.gp_score_cov.restype = _I
        lib.gp_var_downdate.argtypes = [_P] * 10 + [_I] * 4 + [_P]
        lib.gp_var_downdate.restype = _I
        lib.gp_score_cov_smem_bytes.argtypes = [_I, _I]
        lib.gp_score_cov_smem_bytes.restype = ctypes.c_long
        lib.gp_score_cov_blocks_per_sm.argtypes = [_I, _I, _P]
        lib.gp_score_cov_blocks_per_sm.restype = _I
        lib.gp_score_cov_attrs.argtypes = [_I, _P]
        lib.gp_score_cov_attrs.restype = _I
        lib.gp_sqrt_check.argtypes = [ctypes.c_uint, ctypes.c_uint, _P, _P]
        lib.gp_sqrt_check.restype = _I
        lib.gp_masked_kernel.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.gp_masked_kernel.restype = _I
        lib.gp_fit_grad.argtypes = [_P] * 10 + [_I] * 3 + [_P]
        lib.gp_fit_grad.restype = _I
        lib.gp_fit_grad_workspace.argtypes = [_I] * 3
        lib.gp_fit_grad_workspace.restype = ctypes.c_long
        lib.gp_error_string.argtypes = [_I]
        lib.gp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.gp_error_string(err).decode()}")


def kernel_attrs() -> dict:
    """What score_cov's two kernels take on the card: {kernel: (registers
    per thread, local-memory bytes per thread (spills), static shared
    memory per block)}, from ``cudaFuncGetAttributes``."""
    lib = library()
    out = (ctypes.c_int * 3)()
    attrs = {}
    for resident, name in enumerate(SCORE_COV_KERNELS):
        _raise_on(lib, lib.gp_score_cov_attrs(resident, out),
                  f"{name} attributes")
        attrs[name] = tuple(out)
    return attrs


def sqrt_mismatches() -> int:
    """Floats on which the kernel's branch-free square root differs from
    sqrtf, over every float from 1e-12 (the floor of max(d2, 1e-12)) to the
    largest finite one (bit patterns 0x2b8cbccc .. 0x7f7fffff)."""
    lib = library()
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    _raise_on(lib, lib.gp_sqrt_check(
        0x2B8CBCCC, 0x7F7FFFFF, bad.data_ptr(),
        torch.cuda.current_stream(bad.device).cuda_stream), "sqrt_check")
    return int(to_host(bad)[0])   # the one read-back, after the check


def score_cov(Cs, Xs, mask, Linv, alpha, var, noise):
    """(mu, sig2, K) for every candidate of every study in one launch.

    Cs (B, S, dp) and Xs (B, na, dp) are lengthscale-prescaled and padded;
    mask (B, na); Linv (B, na, na) lower triangular; alpha (B, na);
    var, noise (B,).  All float32 and contiguous on one device.  The CUDA
    kernel also needs na a multiple of 4 and Cs, Xs and Linv on 16-byte
    boundaries: it loads their rows 16 bytes at a time."""
    B, S, dp = Cs.shape
    na = Xs.shape[1]
    dev = Cs.device
    _check_dp(dp)
    for name, t, shape in (("Cs", Cs, (B, S, dp)), ("Xs", Xs, (B, na, dp)),
                           ("mask", mask, (B, na)),
                           ("Linv", Linv, (B, na, na)),
                           ("alpha", alpha, (B, na)), ("var", var, (B,)),
                           ("noise", noise, (B,))):
        _check(name, t, shape, dev)
    if dev.type == "cpu":
        return ref.score_cov_ref(Cs, Xs, mask, Linv, alpha, var, noise)
    if dev.type != "cuda":
        raise ValueError(f"score_cov runs on cuda or cpu, not {dev}")
    if na % 4:
        raise ValueError(f"score_cov's kernel needs na % 4 == 0, got {na}")
    _check_aligned(Cs=Cs, Xs=Xs, Linv=Linv)
    lib = library()
    mu = torch.empty((B, S), dtype=torch.float32, device=dev)
    sig2 = torch.empty((B, S), dtype=torch.float32, device=dev)
    K = torch.empty((B, S, na), dtype=torch.float32, device=dev)
    # the TF32 hi and lo parts of Linv, split once for every block
    Lsplit = torch.empty((2, B, na, na), dtype=torch.float32, device=dev)
    err = lib.gp_score_cov(
        Cs.data_ptr(), Xs.data_ptr(), mask.data_ptr(), Linv.data_ptr(),
        alpha.data_ptr(), var.data_ptr(), noise.data_ptr(), mu.data_ptr(),
        sig2.data_ptr(), K.data_ptr(), Lsplit.data_ptr(), B, S, na, dp,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "score_cov")
    launches["score_cov"] += 1
    return mu, sig2, K


def var_downdate(Cs, x_star, Kc, u, schur, sig2, var, slot):
    """Rank-1 GP-BUCB downdate after absorbing x_star: (sig2', knew).

    Cs (B, S, dp); x_star (B, dp); Kc (B, S, na) the cached cross-covariance
    block; u (B, na) the Schur vector; schur, var (B,); sig2 (B, S); slot
    (B,) int32.  knew is also written into column ``slot[b]`` of ``Kc`` in
    place, on both paths.  ``slot[b]`` must lie in [0, na): reading it back
    would cost a device sync, so the caller guarantees it (the bank sizes
    ``na`` for every slot of the batch, ``StudyBank._pick_gp``)."""
    B, S, dp = Cs.shape
    na = Kc.shape[2]
    dev = Cs.device
    _check_dp(dp)
    for name, t, shape in (("Cs", Cs, (B, S, dp)), ("x_star", x_star, (B, dp)),
                           ("Kc", Kc, (B, S, na)), ("u", u, (B, na)),
                           ("schur", schur, (B,)), ("sig2", sig2, (B, S)),
                           ("var", var, (B,))):
        _check(name, t, shape, dev)
    _check("slot", slot, (B,), dev, torch.int32)
    if dev.type == "cpu":
        sig2_new, knew = ref.var_downdate_ref(Cs, x_star, Kc, u, schur, sig2,
                                              var)
        Kc[torch.arange(B), :, slot.long()] = knew
        return sig2_new, knew
    if dev.type != "cuda":
        raise ValueError(f"var_downdate runs on cuda or cpu, not {dev}")
    lib = library()
    sig2_new = torch.empty((B, S), dtype=torch.float32, device=dev)
    knew = torch.empty((B, S), dtype=torch.float32, device=dev)
    err = lib.gp_var_downdate(
        Cs.data_ptr(), x_star.data_ptr(), Kc.data_ptr(), u.data_ptr(),
        schur.data_ptr(), sig2.data_ptr(), var.data_ptr(), slot.data_ptr(),
        sig2_new.data_ptr(), knew.data_ptr(), B, S, na, dp,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "var_downdate")
    launches["var_downdate"] += 1
    return sig2_new, knew


def masked_kernel(X, mask, ls, var, noise, jitter):
    """The fit's masked kernel matrix (B, na, na) in one launch
    (``ref.masked_kernel`` states it).  X (B, na, d) raw rows; mask (B, na);
    ls (B, d); var, noise (its 1e-5 floor added) and jitter (B,).  All
    float32 and contiguous on one device; d up to ``checks.MAX_DP``."""
    B, na, d = X.shape
    dev = X.device
    for name, t, shape in (("X", X, (B, na, d)), ("mask", mask, (B, na)),
                           ("ls", ls, (B, d)), ("var", var, (B,)),
                           ("noise", noise, (B,)), ("jitter", jitter, (B,))):
        _check(name, t, shape, dev, X.dtype)
    if dev.type == "cpu":
        return ref.masked_kernel(X, mask, ls, var, noise, jitter)
    if dev.type != "cuda":
        raise ValueError(f"masked_kernel runs on cuda or cpu, not {dev}")
    if X.dtype != torch.float32:
        raise TypeError(f"masked_kernel's kernel takes float32, not "
                        f"{X.dtype}")
    _check_dp(-(-d // 8) * 8)
    lib = library()
    K = torch.empty((B, na, na), dtype=torch.float32, device=dev)
    err = lib.gp_masked_kernel(
        X.data_ptr(), mask.data_ptr(), ls.data_ptr(), var.data_ptr(),
        noise.data_ptr(), jitter.data_ptr(), K.data_ptr(), B, na, d,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "masked_kernel")
    launches["masked_kernel"] += 1
    return K


def fit_grad(X, mask, Kinv, alpha, ls, var, noise_exp, n_eff):
    """Gradient of each study's -log ML / n_eff with respect to (log ls,
    log var, log noise), (B, d + 2), in closed form from K^-1 and alpha =
    K^-1 z (``ref.fit_grad_ref`` states the formula).

    X (B, na, d) raw rows; mask, alpha (B, na); Kinv (B, na, na); ls (B,
    d); var, ``noise_exp`` = exp(log noise) and n_eff (B,).  Contiguous,
    on one device, of X's dtype; the CUDA kernel takes float32 and d up to
    ``checks.MAX_DP``."""
    B, na, d = X.shape
    dev, dt = X.device, X.dtype
    for name, t, shape in (("X", X, (B, na, d)), ("mask", mask, (B, na)),
                           ("Kinv", Kinv, (B, na, na)),
                           ("alpha", alpha, (B, na)), ("ls", ls, (B, d)),
                           ("var", var, (B,)),
                           ("noise_exp", noise_exp, (B,)),
                           ("n_eff", n_eff, (B,))):
        _check(name, t, shape, dev, dt)
    if dev.type == "cpu":
        return ref.fit_grad_ref(X, mask, Kinv, alpha, ls, var, noise_exp,
                                n_eff)
    if dev.type != "cuda":
        raise ValueError(f"fit_grad runs on cuda or cpu, not {dev}")
    if dt != torch.float32:
        raise TypeError(f"fit_grad's kernel takes float32, not {dt}")
    _check_dp(-(-d // 8) * 8)
    lib = library()
    partial = torch.empty(lib.gp_fit_grad_workspace(B, na, d),
                          dtype=torch.float64, device=dev)
    grad = torch.empty((B, d + 2), dtype=torch.float32, device=dev)
    err = lib.gp_fit_grad(
        X.data_ptr(), mask.data_ptr(), Kinv.data_ptr(), alpha.data_ptr(),
        ls.data_ptr(), var.data_ptr(), noise_exp.data_ptr(),
        n_eff.data_ptr(), partial.data_ptr(), grad.data_ptr(), B, na, d,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "fit_grad")
    launches["fit_grad"] += 1
    return grad


def gp_mean_std(st, cands):
    """(mu, sd) of one study's GP at the candidates, in the original y
    scale, as host arrays: ``score_cov`` at B = 1, both moments from one
    launch.  ``st`` is a ``repro_torch.core.gp.GPState``; its tracked
    factor L^-1 is used when it has one, else solved from L.  ``cands``
    (S, d) is a host array or a tensor."""
    dev = st.L.device
    if st.Linv is not None:
        Linv = st.Linv
    else:
        eye = torch.eye(st.L.shape[0], dtype=torch.float32, device=dev)
        Linv = torch.linalg.solve_triangular(st.L, eye, upper=False)
    Linv = Linv.contiguous()
    alpha = Linv.T @ (Linv @ (st.y * st.mask))
    C = to_device(cands, dev, np.float32)
    d = C.shape[1]
    dp = max(8, -(-d // 8) * 8)
    pad = lambda A: torch.nn.functional.pad(        # noqa: E731
        A / st.ls, (0, dp - d)).contiguous()[None]
    mu, sig2, _ = score_cov(pad(C), pad(st.X), st.mask[None].contiguous(),
                            Linv[None], alpha[None].contiguous(),
                            st.var.reshape(1), st.noise.reshape(1))
    mu, sig2 = to_host(mu[0], sig2[0])   # one exit
    return mu * st.y_std + st.y_mean, np.sqrt(sig2) * st.y_std
