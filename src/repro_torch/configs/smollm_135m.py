"""smollm-135m — small llama-architecture dense model.

[hf:HuggingFaceTB/SmolLM-135M] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152.  9 heads are not divisible by TP=16 -> KV-sequence sharding
fallback for attention.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    period=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=72, n_heads=3, n_kv_heads=1, d_ff=192,
        vocab_size=512,
    )
