"""The card's peaks and the work of each stage of an ask, frozen here so that
no change to the program moves its own yardstick.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 67
TFLOP/s in float32 outside the tensor cores, 495 TFLOP/s in TF32, 3.35 TB/s
of HBM3; and the special-function units' exponentials, 16 a clock on each of
132 SMs (CUDA programming guide, arithmetic instruction throughput, compute
capability 9.0) at the 1,980 MHz maximum boost clock.  ``score_cov``'s product K L^-T keeps float32 accuracy by running
every float32 product as three TF32 products (split TF32), so its
operations count at a third of the TF32 rate, as ``chip_smoke.py``'s
bounds (PERF.md's kernel table, rows 1-2) count them; everything else
counts at the float32 rate.

Work is counted from the cell's shapes, for what the inputs need: each
study's active rows ``n`` (observations, plus pending and hallucinated
rows where a stage holds them), not the padded bucket, and each input byte
read once and each output byte written once.  Whatever implements a stage,
it cannot do that work faster than these bounds, so no share built on them
reads above 100% because of an implementation's choice.
"""
from __future__ import annotations

from typing import Iterable

PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_SPLIT_TF32 = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
# float32 operations around each exponential of the TPE scorer: difference,
# square, scale, and a multiply-add into each split's density
TPE_FLOPS_PER_EXP = 7
F32 = 4


def bound_s(flops_fp32: float = 0.0, flops_split: float = 0.0,
            nbytes: float = 0.0) -> float:
    """The least time of a stage: its operations at their rates or its
    bytes at the HBM rate, whichever is longer."""
    return max(flops_fp32 / PEAK_FP32 + flops_split / PEAK_SPLIT_TF32,
               nbytes / PEAK_BYTES)


def score_cov_s(ns: Iterable[int], S: int, d: int) -> float:
    """``score_cov`` of one ask: for each study the cross-covariance block
    K (S, n) from the squared distances (2 d + 8 operations an element,
    Matern included) and mu = K alpha (2 n S), in float32; the triangular
    product K L^-T (n (n + 1) S) in split TF32.  Bytes: candidates and
    observations read, L^-1's lower triangle read, mu, sig2 and K written."""
    fp32 = split = nbytes = 0.0
    for n in ns:
        fp32 += S * n * (2 * d + 8) + 2 * S * n
        split += S * n * (n + 1)
        nbytes += F32 * (S * d + n * d + n * (n + 1) / 2 + 2 * n
                         + 2 * S + S * n)
    return bound_s(fp32, split, nbytes)


def var_downdate_s(ns: Iterable[int], S: int, d: int) -> float:
    """One ``var_downdate`` call: for each study k(C, x*) (2 d + 8 an
    element) and K u over its ``n`` active columns (2 n S); bytes: K's
    active columns and the candidates read, sig2 read and written, the new
    column written to K and returned."""
    fp32 = nbytes = 0.0
    for n in ns:
        fp32 += S * (2 * d + 8) + 2 * S * n
        nbytes += F32 * (S * n + S * d + 2 * S + 2 * S + n + d)
    return bound_s(fp32, 0.0, nbytes)


def fit_s(ns: Iterable[int], steps: int, d: int) -> float:
    """The hyperparameter fit of the studies that refit: per Adam step the
    kernel matrix (n^2 (2 d + 8)), its Cholesky factor (n^3 / 3), and the
    gradient of -log ML, which needs K^-1 from the factor (2 n^3 / 3) and
    one pass over K per hyperparameter (2 n^2 (d + 2))."""
    fp32 = 0.0
    for n in ns:
        fp32 += steps * (n * n * (2 * d + 8) + n ** 3
                         + 2 * n * n * (d + 2))
    return bound_s(fp32)


def factors_s(ns: Iterable[int], d: int) -> float:
    """The observation stage's factors: the kernel matrix, its Cholesky
    factor (n^3 / 3) and the triangular inverse (n^3 / 3)."""
    fp32 = 0.0
    for n in ns:
        fp32 += n * n * (2 * d + 8) + 2 * n ** 3 / 3
    return bound_s(fp32)


def cluster_head_s(n_studies: int, n_top: int, k: int, d: int,
                   iters: int = 10) -> float:
    """The clustering head: k-means of the top set, k seeding passes and
    ``iters`` + 1 assignments of n_top points to k centers (3 d operations
    a distance)."""
    fp32 = n_studies * (k + iters + 1) * n_top * k * 3 * d
    return bound_s(fp32, 0.0, F32 * n_studies * n_top * (d + 1))


def tpe_scores_s(ns: Iterable[int], S: int, d: int) -> float:
    """The TPE scorer of one ask (``tpe_scores``, as ``chip_smoke.py``'s
    ``tpe_bound`` counts it): one exponential for each candidate, true
    dimension and weighted row (``ns``: each study's rows in either split)
    at the special-function rate, ``TPE_FLOPS_PER_EXP`` float32 operations
    around each, or the bytes: the candidates' true columns and each
    weighted row's coordinates, scales and two weights read, four scalars
    and the live count a study, the scores written."""
    ns = list(ns)
    rows = float(sum(ns))
    n_exp = float(S) * rows * d
    nbytes = F32 * (len(ns) * S * d + rows * (2 * d + 2) + len(ns) * 5
                    + len(ns) * S)
    return max(n_exp / PEAK_EXP, n_exp * TPE_FLOPS_PER_EXP / PEAK_FP32,
               nbytes / PEAK_BYTES)
