"""The program's spans (``csm_tpu_torch.utils.profiling.span``): nothing is
recorded or entered while no profiler runs; under ``torch.profiler`` the
server, codec, generation and train step leave the span tree their layers
promise, one session per stretch of profiling, on the profiler's clock.

No JAX here, so on the GPU host the file runs as
``python -m pytest tests/test_torch_tracing.py --noconftest -q``; the cases
marked ``gpu`` need the card (device-timeline times, the kernels' launch
spans) and skip without one."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from csm_tpu_torch import CSMConfig, CSMModel, generation
from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, random_mimi_params
from csm_tpu_torch.config import LlamaConfig
from csm_tpu_torch.ops import specdec
from csm_tpu_torch.ops import fused_decoder as fd
from csm_tpu_torch.serving import CSMServer
from csm_tpu_torch.train import make_optimizer, make_train_step
from csm_tpu_torch.utils import profiling


def _prompt(cfg, S: int, seed: int):
    """A ``[1, S, 33]`` request: 2 text frames, then audio frames."""
    rng = np.random.default_rng(seed)
    N = cfg.audio_num_codebooks
    ids = np.zeros((1, S, cfg.frame_width), np.int64)
    mask = np.zeros((1, S, cfg.frame_width), np.float32)
    ids[0, :2, N] = rng.integers(1, cfg.text_vocab_size, 2)
    mask[0, :2, N] = 1
    ids[0, 2:, :N] = rng.integers(1, cfg.audio_vocab_size, (S - 2, N))
    mask[0, 2:, :N] = 1
    return ids, mask


def _server(cfg, device="cpu", dtype=torch.float32, n_slots=2, tier=None, **kw):
    """A server with a tiny codec; every frame is voiced
    (``stop_on_all_zeros=False``), so each observe feeds the codec."""
    model = CSMModel(cfg, dtype=dtype, seed=2, device=device)
    if tier == "int4":
        model = model.quantize(bits=4)
    elif tier == "exact":
        model = model.exact()
    tiers = dict(qdec=model._qdec, qbb=model._qbb, qsb=model._qsb, specdec=model._specdec)
    ccfg = MimiCodecConfig.tiny(num_quantizers=cfg.audio_num_codebooks)
    codec = MimiCodec(ccfg, random_mimi_params(ccfg, seed=1), device=device)
    return CSMServer(model.params, cfg, n_slots=n_slots, window=64, temperature=0.8, topk=5,
                     stop_on_all_zeros=False, max_new_frames=3, codec=codec, **tiers, **kw)


def _serve(server, cfg, lengths=(5, 9, 7)):
    """Submit one request a length (the last queues behind a full 2-slot
    server) and serve them to the end."""
    rids = [server.submit(*_prompt(cfg, S, seed=S), greedy=i % 2 == 0)
            for i, S in enumerate(lengths)]
    server.run_until_idle()
    return rids


def _profile(cuda: bool = False):
    """A profiler run whose spans open a session of their own: a session
    begins at the first span after one saw the profiler off."""
    with profiling.span("csm.serve.step"):
        pass
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _children(sess, parent, name=None):
    return [s for s in sess.spans if s.parent is parent and (name is None or s.name == name)]


def test_off_records_nothing_and_never_enters_record_function(monkeypatch):
    """No profiler: a served run with a codec keeps no span, never builds a
    ``record_function``, and every span is the one shared no-op."""
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    cfg = CSMConfig.tiny()
    before = profiling.sessions()
    server = _server(cfg)
    _serve(server, cfg)
    assert entered == [] and profiling.sessions() == before
    assert profiling.span("csm.serve.step", B=2) is profiling.span("csm.gen.prefill",
                                                                   device=True)
    with _profile():  # the patch is the one the spans use
        server.submit(*_prompt(cfg, 6, seed=1))
    assert "csm.serve.admit" in entered and profiling.last_session() is not None


def test_served_requests_leave_the_layers_span_tree():
    """Each step: one frame, one observe per live slot, one feed under each
    observe; each admission: one prefill and its first frame's observe; a
    request's admit, observe and feed spans share its rid."""
    cfg = CSMConfig.tiny()
    server = _server(cfg)
    with _profile():
        rids = _serve(server, cfg)
    sess = profiling.last_session()
    assert sess.dropped == 0 and {s.name for s in sess.spans} <= set(profiling.SPAN_NAMES)
    steps = sess.named("csm.serve.step")
    assert steps
    for st in steps:
        assert st.parent is None and st.host_ms > 0
        assert len(_children(sess, st, "csm.serve.frame")) == 1
        obs = _children(sess, st, "csm.serve.observe")
        assert len(obs) == st.attrs["B"] >= 1
        for ob in obs:
            assert [f.name for f in _children(sess, ob)][:1] == ["csm.codec.feed"]
        backbone = [s for s in sess.named("csm.gen.backbone") if s.within("csm.serve.frame")
                    and s.parent.parent is st]
        assert len(backbone) == 1 and backbone[0].attrs["B"] == server.n_slots
    admits = sess.named("csm.serve.admit")
    assert sorted(a.attrs["rid"] for a in admits) == rids
    for a in admits:
        assert len(_children(sess, a, "csm.gen.prefill")) == 1
        assert _children(sess, a, "csm.gen.prefill")[0].attrs["S"] == 32  # the prompt bucket
        assert len(_children(sess, a, "csm.gen.codebooks")) == 1
        first = _children(sess, a, "csm.serve.observe")
        assert len(first) == 1 and first[0].attrs["rid"] == a.attrs["rid"]
        assert a.attrs["queued_ms"] >= 0 and a.attrs["S"] in (5, 9, 7)
    # The third request waited for a slot: admitted from a step's observe.
    late = [a for a in admits if a.attrs["rid"] == rids[2]]
    assert late[0].within("csm.serve.step") and late[0].attrs["queued_ms"] > 0
    by_rid = {a.attrs["rid"] for a in admits}
    for ob in sess.named("csm.serve.observe"):
        assert ob.attrs["rid"] in by_rid
        for f in _children(sess, ob, "csm.codec.feed"):
            assert f.parent.attrs["rid"] == ob.attrs["rid"] and f.attrs["B"] == 1
    for p in sess.named("csm.gen.prefill"):  # the layer spans split the long passes
        assert [s.attrs["l"] for s in _children(sess, p)] == list(
            range(cfg.backbone.num_hidden_layers))
    for f in sess.named("csm.codec.feed"):
        assert [s.name for s in _children(sess, f)] == ["csm.codec.layer"] * \
            server.codec.config.num_hidden_layers + ["csm.codec.seanet"]
    submits = sess.named("csm.serve.submit")
    assert [s.attrs["rid"] for s in submits] == rids
    assert all(a.within("csm.serve.submit") for a in admits if a.attrs["rid"] != rids[2])


def test_step_many_is_one_step_and_one_frame_span():
    cfg = CSMConfig.tiny()
    server = _server(cfg)
    server.submit(*_prompt(cfg, 5, seed=5))
    with _profile():
        server.step_many(2)
    sess = profiling.last_session()
    (st,) = sess.named("csm.serve.step")
    assert st.attrs == {"B": 1, "n": 2}
    assert len(_children(sess, st, "csm.serve.frame")) == 1
    assert len(_children(sess, st, "csm.serve.observe")) == 2
    assert len(sess.named("csm.gen.backbone")) == 2


@pytest.mark.parametrize("seed,greedy", [(0, True), (3, False), (7, True)])
def test_spec_rounds_of_a_frame_equal_the_loops_count(seed, greedy):
    """The exact tier: one frame's ``csm.spec.round`` spans, numbered from
    0, are the rounds ``decode_frame_specdec(return_rounds=True)`` counts."""
    cfg = CSMConfig.tiny(audio_num_codebooks=8)
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device="cpu").exact()
    tp, qdec = model.params, model._qdec
    rng = np.random.default_rng(seed)
    last_h = torch.tensor(rng.standard_normal((1, cfg.backbone.hidden_size)),
                          dtype=torch.bfloat16)
    c0 = last_h @ tp["codebook0_head"]
    with _profile():
        with profiling.span("csm.gen.codebooks", device=True, B=1):
            generation.decode_frame(tp, cfg, last_h, c0, greedy=greedy, qdec=qdec, specdec=True,
                                    generator=torch.Generator().manual_seed(seed))
    sess = profiling.last_session()
    (frame,) = sess.named("csm.gen.codebooks")
    spans = _children(sess, frame, "csm.spec.round")
    gum = fd.build_frame_gumbel(cfg, torch.Generator().manual_seed(seed), 1, greedy, "cpu")
    _, rounds = specdec.decode_frame_specdec(tp, qdec, cfg, last_h, c0, gum, 1.0, 50, greedy,
                                             return_rounds=True)
    assert [s.attrs["round"] for s in spans] == list(range(rounds)) and rounds >= 1


def test_two_profiler_runs_give_two_sessions():
    """Untraced work between two profiler runs splits them; the last
    session is the second run's alone."""
    cfg = CSMConfig.tiny()
    server = _server(cfg, n_slots=1)
    with profile(activities=[ProfilerActivity.CPU]):
        server.submit(*_prompt(cfg, 5, seed=1), max_new_frames=3)
    first = profiling.last_session()
    server.step()  # untraced: the spans see the profiler off
    with profile(activities=[ProfilerActivity.CPU]):
        server.step()
    second = profiling.last_session()
    assert second is not first and profiling.sessions()[-2:] == [first, second]
    assert {s.name for s in first.spans} >= {"csm.serve.submit", "csm.serve.admit"}
    assert not second.named("csm.serve.admit") and len(second.named("csm.serve.step")) == 1


def test_sessions_keep_at_most_max_records(monkeypatch):
    """Past the bound the oldest sessions go first, then new records are
    dropped and counted."""
    monkeypatch.setattr(profiling, "MAX_RECORDS", 5)
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())
    for n in (3, 7):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                with profiling.span("csm.serve.step"):
                    pass
        with profiling.span("csm.serve.step"):  # seen off
            pass
    (sess,) = profiling.sessions()
    assert len(sess.spans) == 5 and sess.dropped == 2


def test_train_step_has_accum_forward_backward_pairs_and_one_update():
    from oracle import random_csm_batch

    cfg = CSMConfig.tiny()
    accum = 3
    d = random_csm_batch(cfg, accum, 24, seed=4)
    batch = {k: torch.as_tensor(v.reshape(accum, 1, 24, -1)) for k, v in d.items()}
    opt = make_optimizer(1e-3, 4)
    state = opt.init(CSMModel(cfg, seed=5, device="cpu").params)
    step = make_train_step(cfg, opt, 24, remat=True)
    with _profile():
        step(state, None, batch)
    sess = profiling.last_session()
    (st,) = sess.named("csm.train.step")
    assert st.attrs == {"accum": accum}
    names = [s.name for s in _children(sess, st)]
    assert names == ["csm.train.forward", "csm.train.backward"] * accum + ["csm.train.update"]
    for s in _children(sess, st):
        # On the CPU the device's timeline is the host's.
        assert s.device_ms == s.host_ms > 0


def _rf_events_ns(prof) -> dict:
    """The profiler's host events of the program's spans, by name, as
    absolute ``(start, end)`` nanoseconds in start order."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    out = {}
    for e in prof.events():
        if e.name in profiling.SPAN_NAMES and e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name, []).append((t0 + e.time_range.start * 1e3,
                                               t0 + e.time_range.end * 1e3))
    return {k: sorted(v) for k, v in out.items()}


def _assert_on_the_profilers_clock(prof, sess) -> None:
    """Each span, moved onto the profiler's clock by its session's offset,
    holds its ``record_function`` event (within 5 us) and starts before it
    by the profiler's own entry path, at the median within 50 us (one entry
    can take longer on a loaded host)."""
    events = _rf_events_ns(prof)
    leads = []
    for name in {s.name for s in sess.spans}:
        mine = sorted((s.start_ns + sess.offset_ns, s.end_ns + sess.offset_ns)
                      for s in sess.named(name))
        assert len(mine) == len(events[name]), name
        for (a, b), (ea, eb) in zip(mine, events[name]):
            assert a - 5e3 <= ea and eb <= b + 5e3, (name, ea - a, b - eb)
            leads.append(ea - a)
    assert np.median(leads) <= 50e3, sorted(leads)


def test_span_starts_lie_on_the_profilers_clock():
    """The spans' host times, moved by their session's offset, lie on the
    clock of ``prof.events()`` (see :func:`_assert_on_the_profilers_clock`)."""
    cfg = CSMConfig.tiny()
    server = _server(cfg)
    _serve(server, cfg, lengths=(5,))
    with _profile() as prof:
        # A profiler run's first event pays the profiler's own set-up
        # between the host's clock and its timestamp.
        with torch.profiler.record_function("warm-up"):
            pass
        _serve(server, cfg, lengths=(5, 9))
    _assert_on_the_profilers_clock(prof, profiling.last_session())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device-timeline times and kernel launches")
    return torch.device("cuda")


def _card_config() -> CSMConfig:
    """Small, with the kernels' head_dim 64 in both stacks."""
    return CSMConfig.tiny(
        backbone=LlamaConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=64),
        decoder=LlamaConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=1,
                            max_position_embeddings=32),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["int4", "exact"])
def test_card_device_spans_and_launch_spans(cuda, tier):
    """A served run on the card: every ``device=True`` span reads a device
    time above 0, the launch spans equal the kernels' ``.launches`` delta,
    the exact tier's rounds sit under its frames, and the spans lie on the
    profiler's clock."""
    from csm_tpu_torch.ops import bb_kernel

    cfg = _card_config()
    server = _server(cfg, device=cuda, dtype=torch.bfloat16, tier=tier)
    _serve(server, cfg, lengths=(6,))  # builds and loads the kernels
    bbs = (bb_kernel.bb_decode_step, bb_kernel.bb_decode_step_q, bb_kernel.bb_decode_step_q4)
    before = [f.launches for f in bbs], fd.fused_decode_codebooks.launches
    with _profile(cuda=True) as prof:
        _serve(server, cfg)
    sess = profiling.last_session()
    dev = [s for s in sess.spans if s.name in ("csm.gen.prefill", "csm.gen.backbone",
                                               "csm.gen.codebooks")]
    assert dev and all(s.device_ms > 0 for s in dev)
    assert len(sess.named("csm.bb.launch")) == sum(f.launches for f in bbs) - sum(before[0]) > 0
    assert len(sess.named("csm.k2.launch")) == fd.fused_decode_codebooks.launches - before[1] > 0
    rounds = sess.named("csm.spec.round")
    assert (len(rounds) >= len(sess.named("csm.gen.codebooks"))) if tier == "exact" else not rounds
    _assert_on_the_profilers_clock(prof, sess)


@pytest.mark.gpu
def test_card_train_spans_time_the_device(cuda):
    from oracle import random_csm_batch

    cfg = _card_config()
    d = random_csm_batch(cfg, 2, 48, seed=4)
    batch = {k: torch.as_tensor(v.reshape(2, 1, 48, -1), device=cuda) for k, v in d.items()}
    opt = make_optimizer(1e-3, 4)
    state = opt.init(CSMModel(cfg, seed=5, device=cuda).params)
    step = make_train_step(cfg, opt, 24, remat=True, compute_dtype=torch.bfloat16)
    step(state, None, batch)
    with _profile(cuda=True):
        step(state, None, batch)
    sess = profiling.last_session()
    (st,) = sess.named("csm.train.step")
    spans = _children(sess, st)
    assert [s.name for s in spans] == ["csm.train.forward", "csm.train.backward"] * 2 + [
        "csm.train.update"]
    assert all(s.device_ms > 0 for s in spans)
