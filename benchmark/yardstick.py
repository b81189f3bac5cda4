"""The yardstick: the card's peaks and a call's least time (its roofline
bound) from the bytes and operations its data needs (``chip_smoke.py``'s
``bound_ms``, copied).  What a model's kernels and frames need comes from
its family (``families/<family>.py``: ``k2_work``, ``bb_work``,
``flash_train_work`` and the model FLOPs), computed from shapes alone, so
later changes to the program cannot move it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its full 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, n_flops: float, dtype: str = "bfloat16") -> float:
    """The least time of a call: the larger of its bytes over the memory's
    bandwidth and its operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_FLOPS[dtype])
