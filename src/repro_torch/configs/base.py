"""Architecture & shape configuration for the repro framework.

Every assigned architecture is expressed as an ``ArchConfig``: a declarative,
framework-agnostic description of a decoder LM (optionally with an encoder and
a stubbed modality frontend).  Layers are described as a repeating *period* of
``LayerSpec``s so heterogeneous stacks (Jamba's 1:7 Mamba:attention interleave
with MoE every other layer) lower to a single ``lax.scan`` over periods in
the JAX package; the port applies the layers one by one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating layer period."""

    mixer: str  # "attn" | "mamba" | "mlstm" | "slstm"
    ffn: str = "dense"  # "dense" | "moe" | "none"
    cross_attn: bool = False  # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    period: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    n_shared_experts: int = 0  # qwen2-moe: always-on shared experts
    capacity_factor: float = 1.25

    # --- SSM (mamba) ---
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # --- xLSTM ---
    lstm_expand: int = 2  # mLSTM up-projection factor

    # --- encoder / frontend stubs ---
    encoder_layers: int = 0  # whisper: 32
    encoder_seq: int = 0  # whisper: 1500 frames (post-conv stub)
    vision_tokens: int = 0  # internvl2: prepended patch embeddings

    # --- misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (swiglu) | gelu (plain mlp)
    rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    subquadratic: bool = False  # can run long_500k

    # ----------------------------------------------------------------- props
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"period={len(self.period)}"
        )
        return self.n_layers // len(self.period)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def lstm_d_inner(self) -> int:
        return self.lstm_expand * self.d_model

    @property
    def lstm_heads(self) -> int:
        # xLSTM uses a small head count over the up-projected dim.
        return self.n_kv_heads

    def padded_vocab(self, multiple: int = 128) -> int:
        """Vocab padded for TP divisibility / MXU lane alignment (Megatron-style)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    # ------------------------------------------------------------- counting
    def param_count(self) -> dict:
        """Analytic parameter counts: total and active-per-token (MoE-aware)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        attn = qkv + self.n_heads * hd * d
        dense_ffn = 3 * d * ff if self.act == "silu" else 2 * d * ff
        shared_ffn = 3 * d * (self.n_shared_experts * self.moe_d_ff)
        expert = 3 * d * self.moe_d_ff
        di, r, n = self.ssm_d_inner, self.dt_rank, self.ssm_state_dim
        mamba = (d * 2 * di + di * self.ssm_conv_dim + di * (r + 2 * n)
                 + r * di + di * n + di + di * d)
        li = self.lstm_d_inner
        nh = self.lstm_heads
        dh_l = li // max(nh, 1)
        # block-diagonal per-head q/k/v (3 * nh * dh^2 = 3 * li * dh)
        mlstm = (d * 2 * li + 3 * li * dh_l + li * 2 * nh
                 + 4 * li + li * d)
        dh_s = d // max(nh, 1)
        slstm = d * 4 * d + nh * dh_s * 4 * dh_s + d * d

        total = active = 0
        for spec in self.period:
            mix = {"attn": attn, "mamba": mamba, "mlstm": mlstm, "slstm": slstm}[spec.mixer]
            if spec.cross_attn:
                mix += attn
            total += mix
            active += mix
            if spec.ffn == "dense":
                total += dense_ffn
                active += dense_ffn
            elif spec.ffn == "moe":
                total += self.n_experts * expert + d * self.n_experts + shared_ffn
                active += self.top_k * expert + d * self.n_experts + shared_ffn
        total *= self.n_periods
        active *= self.n_periods

        if self.encoder_layers:  # whisper encoder: attn + dense mlp
            enc = self.encoder_layers * (attn + dense_ffn)
            total += enc
            active += enc

        emb = self.padded_vocab() * d
        head = 0 if self.tie_embeddings else emb
        total += emb + head
        active += emb + head
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    def applicable(self, cfg: ArchConfig) -> Tuple[bool, str]:
        if self.name == "long_500k" and not cfg.subquadratic:
            return False, ("quadratic full attention at 524k context; "
                           "run only for SSM/hybrid/linear-attention archs")
        return True, ""


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
