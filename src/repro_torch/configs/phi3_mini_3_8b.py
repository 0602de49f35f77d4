"""phi3-mini-3.8b — RoPE SwiGLU dense model (MHA: kv=32).

[arXiv:2404.14219] 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    period=(LayerSpec("attn", "dense"),),
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512,
    )
