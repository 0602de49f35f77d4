"""Mamba pieces the port needs so far: the depthwise causal convolution that
the mLSTM block shares (``repro.models.mamba._causal_conv``).  The Mamba
mixer itself comes with the jamba slice (ROADMAP queue 1 item 13c)."""
from __future__ import annotations

from typing import Optional

import torch


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 shift_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via Kc shifted adds, summed in fp32 and cast to
    x's dtype.  x (B, S, di), w (Kc, di); ``shift_in`` (B, Kc - 1, di) are
    the inputs before position 0 (zeros by default)."""
    Kc = w.shape[0]
    B, S, di = x.shape
    if shift_in is None:
        shift_in = x.new_zeros(B, Kc - 1, di)
    xp = torch.cat([shift_in, x], dim=1)
    out = x.new_zeros(B, S, di, dtype=torch.float32)
    for i in range(Kc):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return out.to(x.dtype)
