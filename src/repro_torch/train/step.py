"""Prefill and decode step factories (the serving half of
``repro.train.step``; the train step comes with the training slice).

Each step returns the greedy next token (int32, argmax of the logits), the
cache, and the fp32 logits it was chosen from, so a caller can check them
without computing them again.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import forward_decode, forward_prefill


def make_decode_step(cfg: ArchConfig, rt: Runtime) -> Callable:
    def decode_step(params, tokens, cache, cache_len: int):
        logits, cache = forward_decode(params, tokens, cache, cache_len,
                                       cfg, rt)
        return logits.argmax(dim=-1).int(), cache, logits

    return decode_step


def make_prefill_step(cfg: ArchConfig, rt: Runtime,
                      cache_size: Optional[int] = None) -> Callable:
    def prefill_step(params, batch):
        logits, cache = forward_prefill(params, batch, cfg, rt,
                                        cache_size=cache_size)
        return logits.argmax(dim=-1).int(), cache, logits

    return prefill_step
