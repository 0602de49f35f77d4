"""The model stack's serving half: dense attention decoders."""
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            init_cache, init_params)

__all__ = ["Runtime", "forward_decode", "forward_prefill", "init_cache",
           "init_params"]
