"""The Mimi neural audio codec (counterpart of ``csm_tpu/codec``).

Mimi maps 24 kHz mono audio to frames of 32 RVQ codebook tokens at 12.5 Hz
and back: a SEANet causal-conv encoder (stride 960), an 8-layer causal
transformer at 25 Hz, a stride-2 downsample, a split residual vector
quantizer (1 semantic + 31 acoustic codebooks of 2048); the decoder mirrors
it.  :mod:`.streaming` decodes (and encodes) chunk by chunk with carried
state, as the server streams each request's audio.
"""

from csm_tpu_torch.codec.convert import (  # noqa: F401
    mimi_params_from_jax,
    mimi_params_from_state_dict,
    random_mimi_params,
)
from csm_tpu_torch.codec.mimi import MimiCodec, MimiCodecConfig, load_mimi  # noqa: F401
from csm_tpu_torch.codec.streaming import StreamingMimiDecoder, StreamingMimiEncoder  # noqa: F401

__all__ = [
    "MimiCodec",
    "MimiCodecConfig",
    "StreamingMimiDecoder",
    "StreamingMimiEncoder",
    "load_mimi",
    "mimi_params_from_jax",
    "mimi_params_from_state_dict",
    "random_mimi_params",
]
