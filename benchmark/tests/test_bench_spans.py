"""The readers of the program's spans, on synthetic sessions: each value
from hand-made spans, ``None`` where the traced run lacks them (no trace, no
such span, a program without the span recorder), and every span name a
reader reads is one the program records."""

import os
import re
from types import SimpleNamespace

import pytest

from benchmark import spec
from csm_tpu_torch.utils import profiling

READERS = ("frame_ms.stream", "feed_share.stream", "prefill_ms", "spec_rounds.stream",
           "trace_kept.stream", "trace_kept.batch", "backward_ms.train", "update_ms.train")


def span(name, ms, parent=None, device_ms=None, at=0.0, **attrs):
    s = profiling.Span(name, parent, attrs, device_ms)
    s.start_ns = int(at * 1e6)
    s.end_ns = s.start_ns + int(ms * 1e6)
    return s


def session(*spans):
    sess = profiling.Session()
    sess.spans.extend(spans)
    return sess


def use(monkeypatch, *sessions):
    monkeypatch.setattr(profiling, "sessions", lambda: list(sessions))
    monkeypatch.setattr(profiling, "last_session", lambda: sessions[-1] if sessions else None)


def run(trace=None):
    return SimpleNamespace(trace={"groups": {}} if trace is None else trace, spans={})


def read(name, r):
    return spec.reader(name)(r)


def serving_session():
    """Two steps of two live slots, one admission."""
    out = []
    for i, (frame, feeds) in enumerate(((20.0, (7.0, 9.0)), (30.0, (8.0, 6.0)))):
        st = span("csm.serve.step", frame + sum(feeds) + 1.0, at=100.0 * i, B=2)
        out.append(st)
        out.append(span("csm.serve.frame", frame, parent=st, B=2))
        for slot, ms in enumerate(feeds):
            ob = span("csm.serve.observe", ms + 0.5, parent=st, rid=slot, slot=slot)
            out += [ob, span("csm.codec.feed", ms, parent=ob, B=1)]
    ad = span("csm.serve.admit", 40.0, at=300.0, rid=7, slot=0, S=100)
    ob = span("csm.serve.observe", 9.0, parent=ad, rid=7, slot=0)
    out += [ad, span("csm.gen.prefill", 16.0, parent=ad, device_ms=15.0, S=128, B=1), ob,
            span("csm.codec.feed", 8.5, parent=ob, B=1)]  # outside a step: not in the share
    return session(*out)


def test_serving_readers(monkeypatch):
    use(monkeypatch, serving_session())
    assert read("frame_ms.stream", run()) == pytest.approx(25.0)
    # 30 ms of feeds inside steps of 37 + 45 ms; the admission's feed is outside
    assert read("feed_share.stream", run()) == pytest.approx(100.0 * 30.0 / 82.0)
    assert read("prefill_ms", run()) == pytest.approx(15.0)


def test_prefill_falls_back_to_the_runs_other_traced_admissions(monkeypatch):
    setup = session(span("csm.serve.admit", 30.0, rid=0),)
    setup.spans.append(span("csm.gen.prefill", 12.0, parent=setup.spans[0], device_ms=11.0))
    window = session(span("csm.serve.step", 50.0, B=8))
    use(monkeypatch, setup, window)
    assert read("prefill_ms", run()) == pytest.approx(11.0)
    stray = session(span("csm.gen.prefill", 9.0, device_ms=8.0))  # not an admission's
    use(monkeypatch, stray)
    assert read("prefill_ms", run()) is None


def test_spec_rounds_per_frame(monkeypatch):
    frames = [span("csm.gen.codebooks", 40.0, device_ms=38.0, B=1) for _ in range(4)]
    rounds = [span("csm.spec.round", 10.0, parent=f, round=r)
              for f, n in zip(frames, (1, 3, 2, 2)) for r in range(n)]
    use(monkeypatch, session(*frames, *rounds))
    assert read("spec_rounds.stream", run()) == pytest.approx(2.0)
    use(monkeypatch, session(*rounds))
    assert read("spec_rounds.stream", run()) is None


def test_trace_kept_holds_the_device_trace_against_the_launch_spans(monkeypatch):
    launches = [span("csm.bb.launch", 0.1, B=8) for _ in range(10)] + \
        [span("csm.k2.launch", 0.1, B=8) for _ in range(10)]
    use(monkeypatch, session(*launches))
    lost = run({"groups": {"bb": [10, 0.01], "k2": [9, 0.2], "flash_fwd": [5, 0.1]}})
    assert read("trace_kept.stream", lost) == pytest.approx(95.0)
    assert read("trace_kept.batch", run({"groups": {"bb": [5, 0.01], "k2": [5, 0.1]}})) == \
        pytest.approx(50.0)
    use(monkeypatch, session(span("csm.serve.step", 1.0)))
    assert read("trace_kept.stream", run()) == 100.0  # nothing launched, nothing lost
    assert read("trace_kept.stream", run({"groups": {"k2": [3, 0.1]}})) is None


def test_training_readers(monkeypatch):
    st = span("csm.train.step", 900.0, accum=2)
    parts = [span("csm.train.forward", 100.0, parent=st, device_ms=80.0),
             span("csm.train.backward", 200.0, parent=st, device_ms=190.0),
             span("csm.train.forward", 100.0, parent=st, device_ms=82.0),
             span("csm.train.backward", 200.0, parent=st, device_ms=210.0),
             span("csm.train.update", 50.0, parent=st, device_ms=45.0)]
    use(monkeypatch, session(st, *parts))
    assert read("backward_ms.train", run()) == pytest.approx(200.0)
    assert read("update_ms.train", run()) == pytest.approx(45.0)
    use(monkeypatch, session(span("csm.train.backward", 200.0)))  # not a device span
    assert read("backward_ms.train", run()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(monkeypatch, name):
    """No trace, an empty session, no session at all, and a program whose
    profiling module has no span recorder (an older tree)."""
    use(monkeypatch, serving_session())
    assert read(name, SimpleNamespace(trace=None, spans={})) is None
    empty = run({"groups": {"bb": [4, 0.1]}})
    use(monkeypatch, session())
    assert read(name, empty) is None
    use(monkeypatch)
    assert read(name, run()) is None
    monkeypatch.delattr(profiling, "last_session")
    monkeypatch.delattr(profiling, "sessions")
    assert read(name, run()) is None


def test_every_span_a_reader_reads_is_recorded_by_the_program():
    bench = spec.load_benchmark()
    names = {m["name"] for m in bench["per_layer"]}
    assert set(READERS) <= names
    read_names = set()
    for metric in READERS:
        path = os.path.join(spec.HERE, "metrics", metric + ".py")
        if not os.path.exists(path):
            path = os.path.join(spec.HERE, "metrics", metric.split(".", 1)[0] + ".py")
        with open(path) as f:
            read_names |= set(re.findall(r'"(csm\.[a-z0-9_.]+)"', f.read()))
    assert read_names and read_names <= set(profiling.SPAN_NAMES), read_names - set(
        profiling.SPAN_NAMES)
