"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Period of 8 layers: one attention layer per period (1:7 attn:mamba), MoE on
every other layer (4 MoE positions per period).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_PERIOD = (
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("attn", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    period=_PERIOD,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    rope=False,  # jamba uses no positional encoding (Mamba provides position)
    subquadratic=True,  # 7/8 of layers are SSM; attn layers decode linearly
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, n_experts=4, top_k=2, moe_d_ff=128, ssm_state_dim=8,
    )
