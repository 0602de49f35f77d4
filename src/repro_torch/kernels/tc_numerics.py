"""The split-TF32 tensor-core numerics, in plain PyTorch (tests only).

A kernel that runs an fp32 product on the tensor cores in split TF32 splits
each operand x into hi = x with its 13 low bits cleared and lo = x - hi, and
sums lo.hi + hi.lo + hi.hi through the tensor cores' accumulator, which
aligns its addends to the largest and cuts them toward zero.  ``split_einsum``
computes a contraction that way, so that the CPU tests can hold a kernel's
design (how many passes, how long one accumulator runs) against an oracle.
The mLSTM kernels (``mlstm_chunk``) and the GP scoring kernel
(``gp_acquisition``'s ``score_cov``) use it; neither main path does.
"""
from __future__ import annotations

from typing import Optional

import torch

KSTEP = 8   # depth of one TF32 tensor-core step (mma.sync m16n8k8, wgmma k8)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` cut to TF32 (10 mantissa bits) by clearing its 13 low
    bits, as the kernels cut the hi part and the tensor cores the lo part."""
    b = x.float().contiguous().view(torch.int32)
    return (b & -0x2000).view(torch.float32)


def _chop(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to fp32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mma_step(c: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    """``c + p.sum(-1)`` as one tensor-core step sums it: the products
    ``p`` (exact: TF32 times TF32 fits fp32) and the accumulator ``c``
    (None: a fresh one) are aligned to the largest of them and each cut
    toward zero to fp32's 24 bits below that one's leading bit, the cut
    terms are added exactly and the sum is cut toward zero to fp32.  A
    term smaller than the grid of the largest is lost, so a long chain
    through one accumulator drifts toward zero."""
    big = p.abs().amax(-1)
    if c is not None:
        big = torch.maximum(big, c.abs())
    _, e = torch.frexp(big)
    grid = torch.ldexp(torch.ones_like(big), e - 24)
    s = torch.trunc(p / grid[..., None]).to(torch.int32).sum(
        -1, dtype=torch.int64)
    if c is not None:
        s = s + torch.trunc(c / grid).to(torch.int64)
    return _chop(s.double() * grid.double())


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, *,
                 passes: int = 3, chain: Optional[int] = 1) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` (one contraction index) as the kernels'
    tensor cores compute it: each operand split into hi = tf32(x) and
    lo = tf32(x - hi) (both cut by ``tf32_trunc``); over each ``KSTEP``-deep
    slice of the contraction, lo.hi, then hi.lo, then hi.hi go through one
    accumulator by ``mma_step`` (``passes=1``: hi.hi alone, one TF32 pass).
    Every ``chain`` slices the accumulator is added to an fp32 sum, rounded
    to nearest, and starts afresh: 1 is the mLSTM kernels' design, 8 one
    accumulator a 64-deep slab, None one over the whole contraction (the GP
    scoring kernel's design)."""
    ins, out = eq.split("->")
    ea, eb = ins.split(",")
    (k,) = [c for c in ea if c in eb and c not in out]
    ia, ib = ea.index(k), eb.index(k)
    keep = f"{ea},{eb}->{out}{k}"      # the products, not yet summed
    n = a.shape[ia]
    acc = t = None
    for i, k0 in enumerate(range(0, n, KSTEP)):
        x = a.narrow(ia, k0, min(KSTEP, n - k0))
        y = b.narrow(ib, k0, min(KSTEP, n - k0))
        xh, yh = tf32_trunc(x), tf32_trunc(y)
        terms = [(xh, yh)]
        if passes == 3:
            terms = [(tf32_trunc(x - xh), yh), (xh, tf32_trunc(y - yh)),
                     (xh, yh)]
        for xa, yb in terms:
            t = mma_step(t, torch.einsum(keep, xa, yb))
        if k0 + KSTEP >= n or (chain and (i + 1) % chain == 0):
            acc = t if acc is None else acc + t
            t = None
    return acc
