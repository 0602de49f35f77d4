"""internvl2-76b — InternViT frontend (stub) + 80L LM backbone.

[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The InternViT-6B vision tower is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (vision_tokens x d_model) which the
backbone prepends to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    period=(LayerSpec("attn", "dense"),),
    vision_tokens=256,
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, vision_tokens=8,
    )
