"""yi-34b — llama-architecture dense GQA model.

[arXiv:2403.04652] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
56 heads are not divisible by TP=16 -> attention falls back to
KV-sequence sharding (see repro/launch/sharding.py).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    period=(LayerSpec("attn", "dense"),),
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128,
        vocab_size=512,
    )
