"""Utilities: profiling hooks, generation timing counters, a numerics
switch (:mod:`.profiling`), on-device measurement (:mod:`.measure`), the
generation warm-up (:mod:`.warmup`), synthetic training batches and the
pattern overfit that sharpens random weights."""

from csm_tpu_torch.utils.profiling import (
    FrameTimer,
    enable_nan_checks,
    trace,
)

__all__ = ["trace", "FrameTimer", "enable_nan_checks"]
