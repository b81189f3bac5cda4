"""Attention dispatch (counterpart of ``csm_tpu/ops/attention.py``).

Multi-token forward passes whose queries start at position 0 (the prefill
and the uncached forward, training included: the flash op carries its own
backward kernels) go to the flash kernel when the stack runs on CUDA and the
kernels take its shape and type; everything else, decode steps
(``q_len == 1``) included, takes the plain path.
"""

from __future__ import annotations

import torch

from csm_tpu_torch.config import LlamaConfig
from csm_tpu_torch.ops.flash_attention import DTYPES, GROUPS, HEAD_DIMS


def flash_eligible(q_len: int, config: LlamaConfig, weight: torch.Tensor) -> bool:
    """Whether a ``q_len``-token pass of the stack ``config`` whose weights
    look like ``weight`` (dtype, device) should use the flash kernels."""
    if weight.device.type != "cuda" or q_len < 2:
        return False
    nq, nkv = config.num_attention_heads, config.num_key_value_heads
    return (
        weight.dtype in DTYPES
        and config.head_dim in HEAD_DIMS
        and nq % nkv == 0
        and nq // nkv in GROUPS
    )
