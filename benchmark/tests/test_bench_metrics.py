"""The metric arithmetic: tails over every request due in the window, a
pending request counted at the window's end, gaps pooled over streams, rates
over the window."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import spec


def run(**kw):
    base = dict(window_s=10.0, requests=[], frames=0, sequences=0, spans={}, trace=None,
                flops=0.0, span_total_s=0.0, setup_s=1.5)
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, r):
    return spec.reader(name)(r)


def test_ttfa_counts_pending_requests_at_the_windows_end():
    reqs = [dict(due=float(i), times=[i + 0.1, i + 0.2], finished=True) for i in range(8)]
    reqs.append(dict(due=4.0, times=[], finished=False))  # never served: 10 - 4 = 6 s
    reqs.append(dict(due=5.0, times=[], finished=False))  # never served: 5 s
    reqs.append(dict(due=11.0, times=[], finished=False))  # due after the window: left out
    got = read("ttfa_p90_ms", run(requests=reqs))
    waits = [0.1] * 8 + [6.0, 5.0]
    assert got == pytest.approx(np.percentile(waits, 90) * 1e3)
    assert got > 0.1e3 * 5


def test_frame_gaps_are_pooled_over_every_stream():
    reqs = [dict(due=0.0, times=[0.0, 0.05, 0.10, 0.30], finished=True),
            dict(due=0.0, times=[1.0, 1.08], finished=True)]
    got = read("frame_gap_p95_ms", run(requests=reqs))
    assert got == pytest.approx(np.percentile([0.05, 0.05, 0.2, 0.08], 95) * 1e3)
    one = [dict(due=0.0, times=[1.0], finished=True)]
    assert read("frame_gap_p95_ms", run(requests=one)) is None


def test_a_live_streams_open_gap_counts_at_the_windows_end():
    stalled = dict(due=0.0, times=[0.0, 0.05, 0.10, 2.0], finished=False)  # open 8 s
    silent = dict(due=9.0, times=[], finished=False)  # no chunk yet: the TTFA's
    done = dict(due=0.0, times=[3.0, 3.05], finished=True)
    got = read("frame_gap_p95_ms", run(requests=[stalled, silent, done]))
    assert got == pytest.approx(np.percentile([0.05, 0.05, 1.9, 8.0, 0.05], 95) * 1e3)
    assert got > 5e3


def test_rates_are_over_the_whole_window():
    assert read("frames_per_s", run(frames=5000, window_s=10.0)) == 500.0
    assert read("train_seq_ms", run(sequences=80, window_s=32.0)) == pytest.approx(400.0)
    assert read("train_seq_ms", run(sequences=0)) is None
    assert read("setup_s", run()) == 1.5


def test_medians_of_spans():
    r = run(spans={"call.step": [0.04, 0.05, 0.2], "admit": [0.03], "feed": [0.01, 0.02]})
    assert read("step_ms.stream", r) == pytest.approx(50.0)
    assert read("step_ms.batch", r) == pytest.approx(50.0)
    assert read("admit_ms", r) == pytest.approx(30.0)
    assert read("mimi_feed_ms", r) == pytest.approx(15.0)
    assert read("admit_ms", run()) is None


def test_trace_readers_say_nothing_without_a_trace_and_never_zero():
    for name in ("k2_roofline.stream", "bb_roofline.batch", "flash_roofline.train",
                 "idle_share.train"):
        assert read(name, run()) is None
    t = dict(groups={"k2": [10, 0.5], "bb": [10, 0.05], "flash_fwd": [16, 0.002],
                     "flash_bwd_dq": [16, 0.002], "flash_bwd_dkv": [16, 0.004]},
             bounds_s={"k2": 0.01, "bb": 0.02, "flash": 0.004}, busy_s=0.6, span_s=1.0)
    r = run(trace=t)
    assert read("k2_roofline.batch", r) == pytest.approx(2.0)
    assert read("bb_roofline.stream", r) == pytest.approx(40.0)
    assert read("flash_roofline.train", r) == pytest.approx(50.0)
    assert read("idle_share.stream", r) == pytest.approx(40.0)
    no_k2 = run(trace=dict(t, groups={}, bounds_s={}))
    assert read("k2_roofline.stream", no_k2) is None


def test_mfu_is_over_the_calls_wall_time():
    r = run(flops=989e12 * 0.5, span_total_s=10.0)
    assert read("mfu.stream", r) == pytest.approx(5.0)
    assert read("mfu.train", run()) is None
