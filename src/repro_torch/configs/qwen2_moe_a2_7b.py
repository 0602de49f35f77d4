"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) d_ff=1408(per expert)
vocab=151936, MoE 60e top-4 with 4 always-on shared experts.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    period=(LayerSpec("attn", "moe"),),
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=512, n_experts=8, top_k=2, moe_d_ff=96, n_shared_experts=2,
    )
