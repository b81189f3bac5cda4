"""Tracing, timing and numerics checks (counterpart of
``csm_tpu/utils/profiling.py``).

- :func:`trace` wraps a region in a ``torch.profiler`` run whose Chrome /
  Perfetto trace is written into a directory;
- :func:`span` marks a layer boundary of the program (``SPAN_NAMES``): while
  a ``torch.profiler`` run records, it sits in the profiler's timeline and
  is kept in memory with its parent, attributes and times, one
  :class:`Session` per stretch of profiling (:func:`last_session`,
  :func:`sessions`); otherwise it does nothing;
- :func:`sync` is a real host barrier on the card;
- :class:`FrameTimer` collects per-step wall-clock counters (frames/s,
  real-time factor);
- :func:`enable_nan_checks` raises at the first operation that makes a NaN
  (the counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import threading
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


# The program's spans, outermost layers first.
SPAN_NAMES = (
    "csm.serve.submit",  # CSMServer.submit; attrs rid
    "csm.serve.admit",  # CSMServer._admit_request; rid, slot, S, queued_ms, state_bytes
    "csm.serve.register",  # a prefix's prefill (register_prefix); S, state_bytes
    "csm.serve.step",  # CSMServer.step / step_many; B live slots (step_many: n frames)
    "csm.serve.frame",  # the frame step through its host read; B
    "csm.serve.observe",  # CSMServer._observe; rid, slot
    "csm.codec.feed",  # StreamingMimiDecoder.feed through its host read; B
    "csm.codec.layer",  # one layer of the codec's streaming transformer; l
    "csm.codec.seanet",  # the codec's streaming SEANet decoder
    "csm.gen.prefill",  # generate_frame's backbone over more than one frame; S, B; device
    "csm.gen.backbone",  # generate_frame's backbone over one frame; S, B; device
    "csm.gen.codebooks",  # generate_frame's codebook loop; B; device
    "csm.spec.round",  # one draft + verify round of decode_frame_specdec; round
    "csm.k2.launch",  # one launch of the fused codebook kernel (K2); B
    "csm.bb.launch",  # one launch of a backbone step kernel (K1 / K1q); B
    "csm.llama.layer",  # one layer of a plain Llama pass (prefill, verify, training); l
    "csm.hybrid.layer",  # one layer of a hybrid backbone pass; l, kind ("mamba" / "attention")
    "csm.ssm.scan",  # a mixer's chunked scan over a prefill; S, chunks; device
    "csm.ssm.launch",  # one mixer step: its kernel's launch (its plain version on a CPU); B; device
    "csm.train.step",  # make_train_step's step; accum
    "csm.train.forward",  # one micro-batch's loss, the masters' cast included; device
    "csm.train.backward",  # one micro-batch's backward; device
    "csm.train.update",  # gradient sum over ranks, scale, clip, AdamW; device
)

# Records kept over all sessions; the oldest sessions go first, then new
# records are dropped and counted.
MAX_RECORDS = 1 << 20

_autograd_profiler = torch.autograd.profiler


class Span:
    """One recorded span: ``name``, ``parent`` (the innermost span open on
    its thread when it began, or None), ``attrs``, host ``start_ns`` /
    ``end_ns`` (``time.perf_counter_ns``; the profiler's clock is that plus
    the session's ``offset_ns``), and for a ``device=True`` span its
    duration on the device's timeline (:attr:`device_ms`)."""

    __slots__ = ("name", "parent", "attrs", "start_ns", "end_ns", "_device")

    def __init__(self, name: str, parent: Optional["Span"], attrs: dict, device):
        self.name, self.parent, self.attrs, self._device = name, parent, attrs, device
        self.start_ns = self.end_ns = None

    @property
    def host_ms(self) -> Optional[float]:
        """Host milliseconds, None while the span is open."""
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two timing events on the CUDA
        stream that was current at its ends, resolved (waiting for the
        second) on first read; for a span whose work ran on the CPU, which
        runs operations synchronously, its host milliseconds; None for a
        span not marked ``device``."""
        d = self._device
        if d is None or isinstance(d, float):
            return d
        if d == "host":
            return self.host_ms
        start, end = d
        end.synchronize()
        self._device = start.elapsed_time(end)
        _EVENT_POOL.extend(d)
        return self._device

    def within(self, name: str) -> bool:
        """Whether an ancestor is named ``name``."""
        s = self.parent
        while s is not None:
            if s.name == name:
                return True
            s = s.parent
        return False


class Session:
    """The spans of one stretch of profiling, in the order they began;
    ``dropped`` counts those not kept (:data:`MAX_RECORDS`); the profiler's
    clock reads ``perf_counter_ns() + offset_ns``."""

    def __init__(self):
        self.spans: List[Span] = []
        self.dropped = 0
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


_EVENT_POOL: list = []  # CUDA timing events free for reuse


def _event():
    return _EVENT_POOL.pop() if _EVENT_POOL else torch.cuda.Event(enable_timing=True)


class _Recorder:
    """The process's sessions and each thread's stack of open spans."""

    def __init__(self):
        self.sessions: collections.deque = collections.deque()
        self.count = 0
        self.saw_off = True  # the next span opens a session
        self.local = threading.local()
        self.lock = threading.Lock()

    def keep(self, rec: Span) -> None:
        """Into the current session, or a new one if the profiler was seen
        off since the last span."""
        with self.lock:
            if self.saw_off or not self.sessions:
                self.saw_off = False
                self.sessions.append(Session())
            sess = self.sessions[-1]
            while self.count >= MAX_RECORDS and self.sessions[0] is not sess:
                self.count -= len(self.sessions.popleft().spans)
            if self.count >= MAX_RECORDS:
                sess.dropped += 1
            else:
                sess.spans.append(rec)
                self.count += 1

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_RECORDER = _Recorder()


class _On:
    """A span while the profiler records."""

    __slots__ = ("rec", "rf", "stack")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.stack = _RECORDER.stack()
        dev = None
        if device:
            dev = (_event(), _event()) if torch.cuda.is_initialized() else "host"
        self.rec = Span(name, self.stack[-1] if self.stack else None, attrs, dev)
        _RECORDER.keep(self.rec)
        self.rf = torch.profiler.record_function(name)

    # The host times and device events enclose the ``record_function``
    # event, whose own start comes before its bookkeeping.
    def __enter__(self):
        rec = self.rec
        rec.start_ns = time.perf_counter_ns()
        if isinstance(rec._device, tuple):
            rec._device[0].record()
        self.rf.__enter__()
        self.stack.append(rec)
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if self.stack and self.stack[-1] is rec:
            self.stack.pop()
        self.rf.__exit__(exc_type, exc, tb)
        if isinstance(rec._device, tuple):
            rec._device[1].record()
        rec.end_ns = time.perf_counter_ns()
        return False


class _Off:
    """The shared span while the profiler is off: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str, device: bool = False, **attrs):
    """A layer boundary of the program, as a context manager:
    ``with span("csm.serve.frame", B=8): ...``.

    Off (no ``torch.profiler`` run recording, read from
    ``torch.autograd.profiler._is_profiler_enabled``) it returns one shared
    context that does nothing: no clock, no ``record_function``, no record.
    On, it enters ``record_function(name)``, so the span sits in the
    profiler's timeline on the device events' clock, and keeps a
    :class:`Span` with its parent, ``attrs`` and host times in the current
    :class:`Session`; a session begins at the first span after the
    profiler was last seen off.  ``device=True`` also records a pair of
    pooled CUDA timing events on the current stream, resolved when
    :attr:`Span.device_ms` is read: for spans whose work ends without a host
    read."""
    if not _autograd_profiler._is_profiler_enabled:
        _RECORDER.saw_off = True
        return _OFF
    return _On(name, device, attrs)


def sessions() -> List[Session]:
    """Every kept session, oldest first."""
    return list(_RECORDER.sessions)


def last_session() -> Optional[Session]:
    """The newest session (the last stretch of profiling), or None."""
    return _RECORDER.sessions[-1] if _RECORDER.sessions else None


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
