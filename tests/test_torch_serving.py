"""The port's serving layer (csm_tpu_torch.serving) on the CPU at
CSMConfig.tiny() in fp32: CSMServer's greedy tokens equal the JAX package's
solo generate (fp32 greedy tokens are the parity contract) and the port's
own; batched equals solo, greedy and sampled (each request draws from its
own generator); prefix caching, cancel, the queue, step_many and per-slot
audio; CSMStreamer equals the compiled path."""

import functools

import jax
import numpy as np
import pytest
import torch

from csm_tpu import generation as jgen
from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu_torch import CSMConfig, CSMModel, generation
from csm_tpu_torch.checkpoint import params_from_jax
from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, random_mimi_params
from csm_tpu_torch.serving import CSMServer, CSMStreamer

WAVE_RTOL, WAVE_ATOL = 1e-4, 1e-5  # as tests/test_torch_codec.py


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = JaxCSMConfig.tiny()
    jp = jcsm.init_params(jax.random.key(0), jcfg)
    cfg = CSMConfig.tiny()
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)


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


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _solo(params, cfg, ids, mask, budget, seed=None, temperature=0.9, topk=5, greedy=False,
          **tiers):
    """A request alone through the port's generate, its noise from its own
    generator (a list of one, as the server draws it)."""
    return generation.generate(
        params, cfg, ids, mask, max_new_frames=budget, temperature=temperature, topk=topk,
        greedy=greedy, stop_mode="stream", generator=None if greedy else [_gen(seed)],
        **tiers)[0]


def _server(**kw):
    jcfg, jp, cfg, tp = _pair()
    args = dict(n_slots=3, window=64, temperature=0.9, topk=5, max_new_frames=5)
    args.update(kw)
    return CSMServer(tp, cfg, **args)


def test_greedy_server_matches_jax_and_port_solo_runs():
    """Ragged prompts, one request joining mid-flight, one queued behind a
    full server: each equals JAX ``generate`` greedy on its prompt alone and
    the port's solo generate."""
    jcfg, jp, cfg, tp = _pair()
    server = _server(n_slots=2, greedy=True)
    prompts = [_prompt(cfg, S, seed=10 + S) for S in (6, 9, 7)]
    rids = [server.submit(*prompts[0])]
    server.step()
    server.step()  # the first request is 3 frames deep...
    rids.append(server.submit(*prompts[1]))  # ...when the second joins
    rids.append(server.submit(*prompts[2]))
    assert server.stats()["queued"] == 1 and len(server.active_slots) == 2
    server.run_until_idle()
    for rid, (ids, mask) in zip(rids, prompts):
        want = np.asarray(jgen.generate(jp, jcfg, ids.astype(np.int32), mask, max_new_frames=5,
                                        greedy=True, stop_mode="stream"))[0]
        np.testing.assert_array_equal(server.results[rid], want)
        np.testing.assert_array_equal(server.results[rid], _solo(tp, cfg, ids, mask, 5,
                                                                 greedy=True))
    st = server.stats()
    assert st["completed"] == 3 and st["prefills"] == 3 and st["active_slots"] == 0


def test_sampled_batched_equals_solo_per_request_generator():
    jcfg, jp, cfg, tp = _pair()
    server = _server()
    prompts = [_prompt(cfg, S, seed=20 + S) for S in (5, 8, 6)]
    seeds = (101, 102, 103)
    rids = [server.submit(*prompts[0], seed=seeds[0])]
    server.step()
    rids += [server.submit(*p, generator=_gen(s)) for p, s in zip(prompts[1:], seeds[1:])]
    server.run_until_idle()
    for rid, (ids, mask), seed in zip(rids, prompts, seeds):
        np.testing.assert_array_equal(server.results[rid], _solo(tp, cfg, ids, mask, 5, seed))


def test_per_request_sampling_params():
    """Three requests with different parameters in one sampled batch, one of
    them greedy: each equals its solo run with its own parameters, and the
    greedy one is exactly argmax (the greedy solo run)."""
    jcfg, jp, cfg, tp = _pair()
    server = _server()
    reqs = [(6, None, None, False), (9, 1.3, 3, False), (7, None, None, True)]
    rids = []
    for i, (S, t, k, g) in enumerate(reqs):
        rids.append(server.submit(*_prompt(cfg, S, seed=30 + i), seed=40 + i, temperature=t,
                                  topk=k, greedy=g))
    server.run_until_idle()
    for i, ((S, t, k, g), rid) in enumerate(zip(reqs, rids)):
        ids, mask = _prompt(cfg, S, seed=30 + i)
        want = _solo(tp, cfg, ids, mask, 5, 40 + i, temperature=0.9 if t is None else t,
                     topk=5 if k is None else k, greedy=g)
        np.testing.assert_array_equal(server.results[rid], want)


@pytest.mark.parametrize("greedy", [True, False])
def test_prefix_caching_matches_the_full_prompt(greedy):
    """Two requests on one prefix, one without, then a request on a prefix
    stacked on the first: each equals the concatenated prompt's solo run;
    the prefix is reusable after serving."""
    jcfg, jp, cfg, tp = _pair()
    server = _server(greedy=greedy, max_new_frames=4)
    pre = _prompt(cfg, 6, seed=71)
    pid = server.register_prefix(*pre)
    conts = [_prompt(cfg, 3, seed=72), _prompt(cfg, 5, seed=73)]
    plain = _prompt(cfg, 4, seed=74)
    rids = [server.submit(*c, seed=81 + i, prefix_id=pid) for i, c in enumerate(conts)]
    rid_c = server.submit(*plain, seed=83)
    server.run_until_idle()

    def full(*parts):
        return tuple(np.concatenate([p[i] for p in parts], axis=1) for i in range(2))

    def solo(prompt, seed):
        return _solo(tp, cfg, *prompt, 4, seed, greedy=greedy)

    for i, (rid, c) in enumerate(zip(rids, conts)):
        np.testing.assert_array_equal(server.results[rid], solo(full(pre, c), 81 + i))
    np.testing.assert_array_equal(server.results[rid_c], solo(plain, 83))
    rid_d = server.submit(*conts[0], seed=81, prefix_id=pid)
    server.run_until_idle()
    np.testing.assert_array_equal(server.results[rid_d], server.results[rids[0]])

    ext, tail = _prompt(cfg, 4, seed=75), _prompt(cfg, 3, seed=76)
    child = server.register_prefix(*ext, prefix_id=pid)
    rid_e = server.submit(*tail, seed=84, prefix_id=child)
    server.run_until_idle()
    np.testing.assert_array_equal(server.results[rid_e], solo(full(pre, ext, tail), 84))
    st = server.stats()
    assert st["prefix_prefills"] == 4 and st["prefixes_registered"] == 2
    server.drop_prefix(child)
    server.drop_prefix(pid)
    assert server.stats()["prefixes_registered"] == 0


def test_cancel_leaves_the_other_slots_unchanged():
    jcfg, jp, cfg, tp = _pair()
    server = _server(n_slots=2)
    prompts = [_prompt(cfg, 4 + 2 * i, seed=90 + i) for i in range(3)]
    rids = [server.submit(*p, seed=91 + i) for i, p in enumerate(prompts)]
    assert len(server.active_slots) == 2  # the third is queued
    server.step()
    assert server.cancel(rids[0])  # running: frees its slot, admits the third
    assert len(server.results[rids[0]]) == 2  # the prefill's frame and one step
    assert len(server.active_slots) == 2
    assert not server.cancel(rids[0])
    server.run_until_idle()
    for i in (1, 2):
        np.testing.assert_array_equal(server.results[rids[i]],
                                      _solo(tp, cfg, *prompts[i], 5, 91 + i))
    st = server.stats()
    assert st["active_slots"] == 0 and st["queued"] == 0 and st["completed"] == 3

    server2 = _server(n_slots=1, greedy=True)
    r1 = server2.submit(*prompts[0])
    r2 = server2.submit(*prompts[1])
    assert server2.cancel(r2)
    server2.run_until_idle()
    assert len(server2.results[r2]) == 0 and len(server2.results[r1]) > 0


def test_step_many_equals_single_steps():
    """``run_until_idle(chunk=4)`` (step_many, one host read a chunk,
    admission between chunks) gives each request the tokens of per-frame
    stepping."""
    jcfg, jp, cfg, tp = _pair()

    def run(chunk):
        server = _server(n_slots=2, max_new_frames=6)
        rids = [server.submit(*_prompt(cfg, 5 + 2 * i, seed=50 + i), seed=60 + i)
                for i in range(3)]
        server.run_until_idle(chunk=chunk)
        return [server.results[r] for r in rids]

    for a, b in zip(run(1), run(4)):
        assert a.shape == (6, cfg.audio_num_codebooks)
        np.testing.assert_array_equal(a, b)


def _tiny_codec(seed: int):
    ccfg = MimiCodecConfig.tiny(num_quantizers=CSMConfig.tiny().audio_num_codebooks)
    return MimiCodec(ccfg, random_mimi_params(ccfg, seed=seed), device="cpu")


def test_server_streams_each_requests_audio():
    """Each request's PCM, decoded frame by frame in its slot (a reused slot
    included), equals the offline decode of its frames; a cancelled request
    keeps the audio of the frames it got."""
    jcfg, jp, cfg, tp = _pair()
    codec = _tiny_codec(7)
    hop = 2 * codec.config.total_stride
    server = _server(n_slots=2, greedy=True, stop_on_all_zeros=False, max_new_frames=4,
                     codec=codec)
    rids = [server.submit(*_prompt(cfg, S, seed=80 + i)) for i, S in enumerate((5, 7, 6))]
    server.run_until_idle()
    for rid in rids:
        frames = server.results[rid]
        assert frames.shape == (4, cfg.audio_num_codebooks)
        assert server.audio[rid].shape == (4 * hop,)
        np.testing.assert_allclose(server.audio[rid], codec.decode(frames.T), rtol=WAVE_RTOL,
                                   atol=WAVE_ATOL)
    assert server.stats()["audio_samples"] == 3 * 4 * hop

    rid = server.submit(*_prompt(cfg, 5, seed=95))
    server.step()
    server.cancel(rid)
    assert server.results[rid].shape[0] == 2 and server.audio[rid].shape == (2 * hop,)
    np.testing.assert_allclose(server.audio[rid], codec.decode(server.results[rid].T),
                               rtol=WAVE_RTOL, atol=WAVE_ATOL)


def test_stop_frame_is_not_voiced():
    """A request whose frames are all zero stops at once: no frame, no PCM."""
    jcfg, jp, cfg, tp = _pair()
    zero = dict(tp, codebook0_head=tp["codebook0_head"] * 0, audio_head=tp["audio_head"] * 0)
    server = CSMServer(zero, cfg, n_slots=1, window=64, greedy=True, codec=_tiny_codec(3))
    rid = server.submit(*_prompt(cfg, 5, seed=1))
    server.run_until_idle()
    assert server.results[rid].shape == (0, 32) and server.audio[rid].shape == (0,)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_servers_equal_solo_generate_on_the_same_tier(bits):
    """Servers on ``quantize(bits)``'s bundles (plain versions on the CPU)
    give each request the tokens of the port's solo generate on that tier."""
    jcfg, jp, cfg, tp = _pair()
    model = CSMModel(cfg, tp, device="cpu").quantize(bits=bits)
    tiers = dict(qdec=model._qdec, qbb=model._qbb, qsb=model._qsb)
    server = _server(n_slots=2, greedy=True, max_new_frames=4, **tiers)
    prompts = [_prompt(cfg, S, seed=110 + S) for S in (6, 8)]
    rids = [server.submit(*p) for p in prompts]
    server.run_until_idle()
    for rid, (ids, mask) in zip(rids, prompts):
        want = model.generate(ids, mask, max_new_frames=4, greedy=True)[0]
        np.testing.assert_array_equal(server.results[rid], want)


def test_server_error_paths():
    """Unknown prefix ids fail at submit; a prefix dropped while its request
    sat queued soft-fails that request; ids are never reused; a prompt or a
    prefix too long for the window raises."""
    jcfg, jp, cfg, tp = _pair()
    server = _server(n_slots=1, greedy=True, max_new_frames=2)
    with pytest.raises(KeyError):
        server.submit(*_prompt(cfg, 4, seed=1), prefix_id="nope")
    pid_a = server.register_prefix(*_prompt(cfg, 4, seed=2))
    server.drop_prefix(pid_a)
    pid_b = server.register_prefix(*_prompt(cfg, 4, seed=3))
    assert pid_b != pid_a
    r_busy = server.submit(*_prompt(cfg, 4, seed=4))
    r_q = server.submit(*_prompt(cfg, 3, seed=5), prefix_id=pid_b)
    server.drop_prefix(pid_b)
    with pytest.warns(UserWarning, match="dropped while"):
        server.run_until_idle()
    assert len(server.results[r_q]) == 0 and len(server.results[r_busy]) > 0

    small = CSMServer(tp, cfg, n_slots=1, window=8, greedy=True)  # a window of 128
    assert small.window == 128
    long_ids = np.zeros((1, 130, cfg.frame_width), np.int64)
    long_mask = np.ones((1, 130, cfg.frame_width), np.float32)
    with pytest.raises(ValueError, match="exceeds the serving window"):
        small.submit(long_ids, long_mask)
    with pytest.raises(ValueError, match="must leave room"):
        small.register_prefix(long_ids[:, :128], long_mask[:, :128])


def test_streamer_equals_the_compiled_path_and_streams_audio():
    """CSMStreamer with one generator equals generate's frames from the same
    seed (stop mode "stream"), its audio chunks equal the offline decode,
    and a prefix session equals the full-prompt session."""
    jcfg, jp, cfg, tp = _pair()
    ids = np.concatenate([_prompt(cfg, 9, seed=31)[0], _prompt(cfg, 9, seed=32)[0]])
    mask = np.concatenate([_prompt(cfg, 9, seed=31)[1], _prompt(cfg, 9, seed=32)[1]])
    want = generation.generate(tp, cfg, ids, mask, max_new_frames=5, temperature=0.9, topk=5,
                               stop_on_all_zeros=False, stop_mode="stream", generator=_gen(11))
    codec = _tiny_codec(5)
    streamer = CSMStreamer(tp, cfg, codec=codec, temperature=0.9, topk=5,
                           stop_on_all_zeros=False)
    outs = list(streamer.run(ids, mask, max_new_frames=5, generator=_gen(11)))
    got = np.stack([o["frame"] for o in outs], axis=1)
    np.testing.assert_array_equal(got, want)
    hop = 2 * codec.config.total_stride
    pcm = np.concatenate([o["audio"] for o in outs], axis=1)
    assert pcm.shape == (2, 5 * hop)
    np.testing.assert_allclose(pcm, codec.decode(np.transpose(got, (0, 2, 1))), rtol=WAVE_RTOL,
                               atol=WAVE_ATOL)

    pre, cont = _prompt(cfg, 6, seed=201), _prompt(cfg, 3, seed=202)

    def frames(s, ids, mask, **kw):
        out = [s.start(ids, mask, generator=_gen(7), max_new_frames=8, **kw)]
        out += [s.step() for _ in range(3)]
        return np.stack(out)

    s1 = CSMStreamer(tp, cfg, temperature=0.9, topk=5, stop_on_all_zeros=False)
    pid = s1.register_prefix(*pre, max_new_frames=16)
    a = frames(s1, *cont, prefix_id=pid)
    b = frames(CSMStreamer(tp, cfg, temperature=0.9, topk=5, stop_on_all_zeros=False),
               np.concatenate([pre[0], cont[0]], 1), np.concatenate([pre[1], cont[1]], 1))
    np.testing.assert_array_equal(a, b)
    # The prefix is not consumed by a session.
    np.testing.assert_array_equal(frames(s1, *cont, prefix_id=pid), a)
