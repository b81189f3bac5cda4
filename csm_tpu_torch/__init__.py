"""csm_tpu_torch: the PyTorch / CUDA port of csm_tpu for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference).  It imports
``torch`` and ``numpy``, never ``jax`` or anything of ``csm_tpu``.

- :mod:`csm_tpu_torch.config`: ``CSMConfig`` (own copy, JSON round trip).
- :mod:`csm_tpu_torch.models`: the Llama stack and the CSM model with losses.
- :mod:`csm_tpu_torch.generation`: greedy / top-k generation from
  ``[B, S, 33]`` prompts to ``[B, F, 32]`` codebook tokens.
- :mod:`csm_tpu_torch.model_api`: ``CSMModel`` (``from_pretrained``,
  ``generate``, ``exact()``, ``quantize()``).
- :mod:`csm_tpu_torch.ops`: RoPE, sampling, W8A16 weights, the speculative
  codebook loop, and the hand-written CUDA kernels (flash prefill and
  backward, exact / int8 / int4 backbone decode steps, fused codebook loop)
  beside their plain PyTorch versions.
- :mod:`csm_tpu_torch.codec`: the Mimi codec, offline and streaming.
- :mod:`csm_tpu_torch.serving`: ``CSMStreamer`` and ``CSMServer``
  (continuous batching, per-request sampling, prefix caching, streamed
  audio).

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

from csm_tpu_torch.config import CSMConfig, LlamaConfig, RopeScalingConfig  # noqa: F401
from csm_tpu_torch.model_api import CSMModel  # noqa: F401

__version__ = "0.5.0"

__all__ = [
    "CSMConfig", "LlamaConfig", "RopeScalingConfig", "CSMModel", "CSMServer", "CSMStreamer",
    "__version__",
]

_LAZY = {
    "CSMServer": ("csm_tpu_torch.serving", "CSMServer"),
    "CSMStreamer": ("csm_tpu_torch.serving", "CSMStreamer"),
}


def __getattr__(name):
    # Lazy, as in the JAX package: the server pulls in the codec.
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'csm_tpu_torch' has no attribute {name!r}")
