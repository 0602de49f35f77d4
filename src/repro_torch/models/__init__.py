"""The model stack: dense attention and MoE decoders, jamba (Mamba +
attention + MoE) and xLSTM, served and trained."""
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import (check_supported, forward_decode,
                                            forward_prefill, forward_train,
                                            init_cache, init_params)

__all__ = ["Runtime", "check_supported", "forward_decode", "forward_prefill",
           "forward_train", "init_cache", "init_params"]
