"""Deterministic, resumable synthetic token pipeline.

The port's copy of ``repro.data.pipeline`` (host numpy, no framework): the
same seed gives the same batches bit for bit in both packages.

Real training needs a data substrate with: determinism under restart,
shard-awareness (each DP rank reads its slice), and O(1) resume state.  We
generate an order-2 Markov token stream from a seed-derived transition table
— it has learnable structure (CE drops well below ln(V) within a few hundred
steps on a small model) while requiring no files.

Resume state is just ``(seed, step)``: batch ``i`` is a pure function of
them, so a restarted job continues byte-identically (tested).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branch: int = 4  # Markov branching factor (lower = more learnable)


class SyntheticLM:
    """Order-1 Markov stream with a deterministic per-(seed,step) batch."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # each token has `branch` likely successors
        self.succ = rng.integers(0, V, size=(V, cfg.branch), dtype=np.int32)
        self.step = 0

    def state(self) -> Dict:
        return {"seed": self.cfg.seed, "step": self.step}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.cfg.seed, "data seed mismatch"
        self.step = int(state["step"])

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        choices = rng.integers(0, cfg.branch, size=(B, S))
        noise = rng.random((B, S)) < 0.05  # 5% uniform noise
        noise_tok = rng.integers(0, V, size=(B, S), dtype=np.int32)
        for t in range(S):
            nxt = self.succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def host_shard(batch: Dict[str, np.ndarray], rank: int, world: int
               ) -> Dict[str, np.ndarray]:
    """Slice the global batch for one data-parallel host (multi-host I/O)."""
    def s(a):
        per = a.shape[0] // world
        return a[rank * per:(rank + 1) * per]
    return {k: s(v) for k, v in batch.items()}
