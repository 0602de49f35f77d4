"""command-r-35b — dense GQA, no biases, 256k vocabulary.

[hf:CohereForAI/c4ai-command-r-v01] 40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000.  The 256k x 8192 embedding is vocab-sharded over the
model axis (and tied to the LM head, as in the released model).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    period=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    subquadratic=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=1024,
    )
