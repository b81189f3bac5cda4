"""Tracing, timing and numerics checks (counterpart of
``csm_tpu/utils/profiling.py``).

- :func:`trace` wraps a region in a ``torch.profiler`` run whose Chrome /
  Perfetto trace is written into a directory;
- :func:`sync` is a real host barrier on the card;
- :class:`FrameTimer` collects per-step wall-clock counters (frames/s,
  real-time factor);
- :func:`enable_nan_checks` raises at the first operation that makes a NaN
  (the counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None):
    """Profile a region: ``with trace("/tmp/torch-trace"): run()``.  Host
    activity, and the card's when CUDA is available; the body runs inside
    ``record_function(name)`` when a name is given.  On exit, also after an
    exception, the trace is written to
    ``log_dir/<host>_<pid>.<ns>.pt.trace.json`` (Perfetto or
    ``chrome://tracing`` load it).  Yields the ``torch.profiler.profile``
    object."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            if name is not None:
                with record_function(name):
                    yield prof
            else:
                yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def sync(tree) -> None:
    """Host barrier: waits for the card when any tensor of ``tree`` (dicts,
    lists, tuples) lies on CUDA; CPU tensors are ready already."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class FrameTimer:
    """Wall-clock counters for generation/training loops.

    >>> timer = FrameTimer()
    >>> with timer.step(frames=64):
    ...     out = generate(...)
    ...     sync(out)
    >>> timer.summary()  # {'steps': 1, 'frames_per_sec': ..., ...}
    """

    def __init__(self):
        self.times: List[float] = []
        self.frames: List[int] = []

    @contextlib.contextmanager
    def step(self, frames: int = 1):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        self.frames.append(frames)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        total_t = sum(self.times)
        total_f = sum(self.frames)
        return {
            "steps": len(self.times),
            "total_time_s": total_t,
            "frames_per_sec": total_f / total_t if total_t else float("nan"),
            "mean_step_ms": 1000.0 * total_t / len(self.times),
            "p50_step_ms": 1000.0 * float(np.median(self.times)),
            "audio_realtime_factor": (total_f / 12.5) / total_t if total_t else float("nan"),
        }


class _NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the first operation whose
    floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_nan_mode: Optional[_NanCheckMode] = None


def enable_nan_checks(on: bool = True) -> None:
    """Raise at the first NaN: the forward's operations through a dispatch
    mode pushed while on (in the calling thread), the backward's through
    ``torch.autograd.set_detect_anomaly(on, check_nan=True)``.  Every check
    waits for the card, so it is a debugging switch.  The port's kernels are
    ctypes launches that write into torch tensors outside the dispatcher: a
    NaN one of them writes is caught at the next torch operation that reads
    it."""
    global _nan_mode
    torch.autograd.set_detect_anomaly(on, check_nan=True)
    if on and _nan_mode is None:
        _nan_mode = _NanCheckMode()
        _nan_mode.__enter__()
    elif not on and _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None
