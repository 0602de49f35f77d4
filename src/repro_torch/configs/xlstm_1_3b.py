"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM), no FFN.

[arXiv:2405.04517] 48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.
xLSTM blocks contain their own up/down projections (d_ff=0 -> ffn="none").
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_PERIOD = (
    LayerSpec("mlstm", "none"),
    LayerSpec("mlstm", "none"),
    LayerSpec("mlstm", "none"),
    LayerSpec("slstm", "none"),
    LayerSpec("mlstm", "none"),
    LayerSpec("mlstm", "none"),
    LayerSpec("mlstm", "none"),
    LayerSpec("mlstm", "none"),
)

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    period=_PERIOD,
    lstm_expand=2,
    rope=False,
    subquadratic=True,  # constant-size matrix/scalar memory
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=512,
    )
