"""olmoe-1b-7b — 64 routed experts, top-8.

[arXiv:2409.02060] 16L d_model=2048 16H (kv=16) d_ff=1024(per expert)
vocab=50304, MoE 64e top-8, no shared experts.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    period=(LayerSpec("attn", "moe"),),
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=512, n_experts=8, top_k=4, moe_d_ff=64,
    )
