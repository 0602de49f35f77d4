"""whisper-large-v3 — encoder-decoder with conv frontend STUB.

[arXiv:2212.04356] 32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
Encoder-decoder: 32 encoder layers (bidirectional) + 32 decoder layers
(causal + cross-attention).  The conv1d/mel frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings
(1500 x d_model).  Sinusoidal positions (no RoPE).  Vocab 51866 is padded
to a multiple of 128 for TP divisibility (padded rows masked out of loss).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    period=(LayerSpec("attn", "dense", cross_attn=True),),
    encoder_layers=32,
    encoder_seq=1500,
    norm="layernorm",
    act="gelu",
    rope=False,
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, encoder_layers=2, encoder_seq=16,
    )
