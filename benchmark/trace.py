"""Reading the device: the profiler's trace summed by exact kernel name
(``chip_smoke.port_kernel`` / ``device_breakdown``, copied), the device's
busy time, its idle gaps labelled by what the host was doing, and a record of
the kernel wrappers' calls so each launch's bound is counted from its
shapes."""

from __future__ import annotations

import bisect
import re
import time
from contextlib import contextmanager

import torch

from benchmark import yardstick

# The port's kernels by group, under their exact names.
PORT_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
    "flash_bwd_dq": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
    "flash_bwd_dkv": ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel"),
    "bb": ("bb_step_kernel", "bbq_step_kernel"),
    "k2": ("fused_decoder_kernel",),
}
_PORT_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def port_group(name: str):
    """The group of one of the port's kernels, else None."""
    m = _PORT_NAME.match(name)
    if m:
        for group, kernels in PORT_KERNELS.items():
            if m.group(1) in kernels:
                return group
    return None


class Clock:
    """Host spans of the benchmark's calls into the program, by name, as
    ``perf_counter`` intervals."""

    def __init__(self):
        self.spans: dict = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def durations(self, name: str, lo: float = float("-inf"), hi: float = float("inf")) -> list:
        return [b - a for a, b in self.spans.get(name, []) if a >= lo and b <= hi]


@contextmanager
def timed_method(clock: Clock, owner, attr: str, name: str):
    """Time every call of ``owner.attr`` (a function or method) as span
    ``name`` while the block runs.  Each wrapped call ends in a host read,
    so the host clock sees its device work."""
    orig = getattr(owner, attr)

    def wrapped(*a, **k):
        with clock.span(name):
            return orig(*a, **k)

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


class Launches:
    """While on, the shapes of every K2 and backbone-step launch, in order,
    for their bounds (the model family's ``k2_work`` and ``bb_work``);
    installed around the kernels' Python wrappers."""

    def __init__(self, fam, cfg):
        self.fam, self.cfg = fam, cfg
        self.on = False
        self.k2, self.bb = [], []

    @contextmanager
    def installed(self):
        from csm_tpu_torch.ops import bb_kernel, fused_decoder

        k2_orig, bb_orig = fused_decoder.fused_decode_codebooks, bb_kernel.bb_decode_step
        log = self

        def k2(qdec, config, x0, *a, **k):
            if log.on:
                log.k2.append((x0.shape[0], 8 if "head_scale" in qdec else 16))
            return k2_orig(qdec, config, x0, *a, **k)

        def bb(qsb, config, h0, cos, sin, bias_w, *a, **k):
            if log.on:
                bits = 4 if "u" in qsb else 8 if "s" in qsb else 16
                log.bb.append((h0.shape[0], bias_w.shape[1], bias_w, bits))
            return bb_orig(qsb, config, h0, cos, sin, bias_w, *a, **k)

        k2.launches, bb.launches = k2_orig.launches, bb_orig.launches
        fused_decoder.fused_decode_codebooks, bb_kernel.bb_decode_step = k2, bb
        try:
            yield self
        finally:
            fused_decoder.fused_decode_codebooks, bb_kernel.bb_decode_step = k2_orig, bb_orig

    def bounds_s(self) -> dict:
        """Summed least times of the recorded launches, by group."""
        fam, cfg = self.fam, self.cfg
        k2 = sum(yardstick.bound_s(*fam.k2_work(cfg, B, hb)) for B, hb in self.k2)
        bb = 0.0
        for B, W, bias, bits in self.bb:
            usable = int((bias >= 0).sum())
            bb += yardstick.bound_s(*fam.bb_work(cfg, B, W, usable, bits))
        return {"k2": k2, "bb": bb}


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host: list, starts: list, t: float, cap: int = 2000) -> str:
    """The latest-starting host event that still holds ``t`` (host events
    nest, so it is the innermost), looking back at most ``cap`` events."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - cap, -1), -1):
        a, b, name = host[j]
        if b >= t and not name.startswith("bench.call"):
            return name
    return "host"


def summarize(prof, top: int = 10) -> dict:
    """From a ``torch.profiler.profile`` over whole calls: device seconds and
    launches by exact kernel name and by the port's groups, the busy
    seconds (union of device activity), and the idle gaps between device
    activity inside the benchmark's call spans (``bench.call``), summed by
    the innermost host event (an op or a ``bench.*`` span) at each gap's
    midpoint."""
    dev_iv, host, calls = [], [], []
    by_name: dict = {}
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            n, s = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, s + (b - a) / 1e6)
            dev_iv.append((a, b))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((a, b, e.name))
            if e.name.startswith("bench.call"):
                calls.append((a, b))
    busy = _union(dev_iv)
    groups: dict = {}
    for name, (n, s) in by_name.items():
        g = port_group(name)
        if g:
            n0, s0 = groups.get(g, (0, 0.0))
            groups[g] = [n0 + n, s0 + s]
    host.sort()
    starts = [h[0] for h in host]
    busy_starts = [a for a, _ in busy]
    gaps: dict = {}
    for ca, cb in sorted(calls):
        cursor = ca
        i = max(bisect.bisect_right(busy_starts, ca) - 1, 0)
        while cursor < cb:
            a, b = busy[i] if i < len(busy) else (cb, cb)
            if b > cursor:
                hi = min(a, cb)
                if hi > cursor:
                    label = _innermost(host, starts, (cursor + hi) / 2)
                    gaps[label] = gaps.get(label, 0.0) + (hi - cursor) / 1e6
                cursor = max(cursor, b)
            i += 1
            if i > len(busy):
                break
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "kernels": {n: list(v) for n, v in by_name.items()},
        "groups": groups,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "breakdown": {"device_ops": [[n[:160], s] for n, (_, s) in ops],
                      "idle_gaps": sorted(([n[:160], s] for n, s in gaps.items()),
                                          key=lambda x: -x[1])[:top]},
    }
