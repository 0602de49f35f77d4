"""The model stack: dense attention and MoE decoders, jamba (Mamba +
attention + MoE), xLSTM and the whisper encoder-decoder, served and
trained."""
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import (encode_audio, forward_decode,
                                            forward_prefill, forward_train,
                                            init_cache, init_params)

__all__ = ["Runtime", "encode_audio", "forward_decode", "forward_prefill",
           "forward_train", "init_cache", "init_params"]
