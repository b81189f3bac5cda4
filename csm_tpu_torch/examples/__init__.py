"""Example scripts of the port (counterparts of the JAX package's
``examples/``): ``python -m csm_tpu_torch.examples.generate`` (voice cloning
from a context clip, offline or streamed) and ``python -m
csm_tpu_torch.examples.serve`` (continuous batching)."""
