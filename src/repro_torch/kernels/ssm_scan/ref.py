"""Plain PyTorch versions of the selective-scan kernels, forward and backward.

``ssm_scan_ref`` is the counterpart of ``repro.kernels.ssm_scan.ref.
ssm_scan_ref``: the sequential Mamba recurrence over a (di, N) state,

    h_t = Abar_t * h_{t-1} + Bx_t,    y_t[i] = sum_n h_t[i, n] C_t[n],

with h_{-1} = 0, and optionally the final state h_S = h_{S-1}.  Autograd
differentiates it on the CPU.

``ssm_scan_bwd_ref`` writes out the gradient in the decomposition the
backward kernel (``csrc/ssm_scan_bwd.cu``) follows, for upstream gradients
dy = dL/dy and (optionally) dh_S = dL/dh_S:

    dh_t = dh_{t+1} * Abar_{t+1} + dy_t[i] C_t[n]   (dh_{S-1} adds dh_S)
    dBx_t = dh_t,   dAbar_t = dh_t * h_{t-1},   dC_t[n] = sum_i dy_t[i] h_t[i, n]

It never divides by Abar to step back in time (Abar can be tiny): the
states come from the forward recurrence.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

CHUNK = 64   # steps between the chunk-boundary states the kernels keep


def ssm_states(Abar: torch.Tensor, Bx: torch.Tensor) -> torch.Tensor:
    """Every state h_t (B, S, di, N) of the recurrence."""
    h = Abar.new_zeros(Abar.shape[0], *Abar.shape[2:])
    hs = []
    # unbind, not a slice per step: its backward stacks the steps' gradients
    # once instead of scattering each into a zero tensor of the whole input
    for a, x in zip(Abar.unbind(1), Bx.unbind(1)):
        h = a * h + x
        hs.append(h)
    return torch.stack(hs, dim=1)


def ssm_scan_ref(Abar: torch.Tensor, Bx: torch.Tensor, Cc: torch.Tensor,
                 return_state: bool = False):
    """Abar, Bx (B, S, di, N); Cc (B, S, N) -> y (B, S, di), and the final
    state h_S (B, di, N) with ``return_state``; all in Abar's dtype."""
    hs = ssm_states(Abar, Bx)
    y = torch.einsum("bsin,bsn->bsi", hs, Cc)
    return (y, hs[:, -1]) if return_state else y


def ssm_scan_bwd_ref(Abar: torch.Tensor, Bx: torch.Tensor, Cc: torch.Tensor,
                     dy: torch.Tensor, dhS: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dAbar, dBx, dCc) for dy (B, S, di) and, where the final state is an
    output too, dhS (B, di, N)."""
    B, S, di, N = Abar.shape
    hs = ssm_states(Abar, Bx)
    h_prev = torch.cat([hs.new_zeros(B, 1, di, N), hs[:, :-1]], dim=1)
    dh = torch.empty_like(hs)
    carry = hs.new_zeros(B, di, N) if dhS is None else dhS.to(hs.dtype)
    for t in range(S - 1, -1, -1):
        d = carry + dy[:, t, :, None] * Cc[:, t, None, :]
        dh[:, t] = d
        carry = d * Abar[:, t]
    dAbar = dh * h_prev
    dCc = torch.einsum("bsi,bsin->bsn", dy, hs)
    return dAbar, dh, dCc
