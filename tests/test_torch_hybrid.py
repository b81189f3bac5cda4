"""CSM on a hybrid Mamba-2 / attention backbone (``HybridConfig``,
``ibm-granite/granite-4.0-h-micro``'s layer pattern at tiny widths): the
port's prefill, cached steps, server and prefix cache held to the plain
float32 reference in ``tests/reference_hybrid.py`` (position-by-position
recurrence, attention over the whole sequence), and the mixer step kernel
held to its plain version on the card (marked ``gpu``; there, run with
``--noconftest``).  The tiny backbone keeps one whole period of the
published pattern (five mixers, an attention layer, four mixers) and a scan
chunk of 8, so prompts cross chunk edges."""

import numpy as np
import pytest
import torch

from csm_tpu_torch import CSMConfig
from csm_tpu_torch.config import HybridConfig
from csm_tpu_torch.generation import _pad_to_bucket, generate
from csm_tpu_torch.models import csm, hybrid
from csm_tpu_torch.ops import ssm
from csm_tpu_torch.serving import CSMServer, CSMStreamer

# tests/ is on the path (pytest puts the directory of a test module without
# an __init__.py there); ``tests`` may name another package on a host.
import reference_hybrid as ref  # noqa: E402

# float32 throughout: the port and the reference differ only in the order of
# float32 sums (the chunked scan against the recurrence, cuBLAS-free CPU
# products), about 1e-6 of the logits' scale; 1e-4 leaves room for 40 layers
# of that and is still 100x under what one bf16 rounding of the state or of
# any layer's output moves them (checked in the padding test's control).
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    cfg = CSMConfig.tiny_hybrid(max_seq_len=128)
    return cfg, csm.init_params(cfg, seed=3)


def _prompt(cfg, S, seed):
    """A ``[1, S, 33]`` prompt: text on the first two frames, audio after."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((1, S, cfg.frame_width), np.int64)
    mask = np.zeros((1, S, cfg.frame_width), np.float32)
    N = cfg.audio_num_codebooks
    ids[0, :2, N] = rng.integers(1, cfg.text_vocab_size, 2)
    mask[0, :2, N] = 1
    ids[0, 2:, :N] = rng.integers(0, cfg.audio_vocab_size, (S - 2, N))
    mask[0, 2:, :N] = 1
    return ids, mask


def _frames_as_inputs(cfg, frames):
    """Generated ``[F, 32]`` frames as ``[F, 33]`` inputs (audio only)."""
    ids = np.zeros((len(frames), cfg.frame_width), np.int64)
    mask = np.zeros(ids.shape, np.float32)
    ids[:, :cfg.audio_num_codebooks] = frames
    mask[:, :cfg.audio_num_codebooks] = 1
    return ids, mask


def _prefill(params, cfg, ids, mask, window=64):
    """The bucket-padded prefill of one prompt into a fresh cache; returns
    ``(c0 logits at its last real frame, cache indexed after it)``."""
    pids, pmask, S, _ = _pad_to_bucket(ids, mask)
    cache = csm.new_cache(cfg, 1, window, dtype=torch.float32)
    out = csm.forward(params, cfg, torch.from_numpy(pids), torch.from_numpy(pmask), cache=cache,
                      last_index=S - 1, flash_prefill=True)
    out.cache.index = S
    return out.logits, out.cache


def test_prefill_then_steps_match_the_reference(model):
    """A 13-frame prompt (bucket 32, chunks of 8) prefilled, then 6 frames
    stepped one at a time through the cache: each step's c0 logits against
    the reference's full forward over prompt and frames."""
    cfg, params = model
    ids, mask = _prompt(cfg, 13, seed=1)
    frames = np.random.default_rng(2).integers(0, cfg.audio_vocab_size, (6, 32))
    fids, fmask = _frames_as_inputs(cfg, frames)
    want = ref.c0_logits(params, cfg, torch.from_numpy(np.concatenate([ids[0], fids])),
                         torch.from_numpy(np.concatenate([mask[0], fmask])))
    got, cache = _prefill(params, cfg, ids, mask)
    torch.testing.assert_close(got[0], want[12], **TOL)
    for j in range(6):
        out = csm.forward(params, cfg, torch.from_numpy(fids[None, j:j + 1]),
                          torch.from_numpy(fmask[None, j:j + 1]), cache=cache)
        cache = out.cache
        torch.testing.assert_close(out.logits[0], want[13 + j], **TOL)
    # The uncached forward over the whole sequence reads the same.
    whole = csm.forward(params, cfg, torch.from_numpy(np.concatenate([ids[0], fids])[None]),
                        torch.from_numpy(np.concatenate([mask[0], fmask])[None]),
                        return_all_logits=True)
    torch.testing.assert_close(whole.logits[0], want, **TOL)


def test_a_right_padded_bucket_leaves_the_state_of_the_unpadded_prompt(model):
    """The pads of a bucket move neither the conv nor the recurrent state:
    the cache after a 21-frame prompt padded to 32 holds the states of the
    same prompt prefilled unpadded, and its K/V rows of the real frames (to
    the order of float32 sums: the padded products and attention run over
    more rows and keys).  Control: feeding the pads into the state moves it
    a thousand times further."""
    cfg, params = model
    ids, mask = _prompt(cfg, 21, seed=5)
    _, padded = _prefill(params, cfg, ids, mask)
    bare = csm.new_cache(cfg, 1, 64, dtype=torch.float32)
    csm.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask), cache=bare)
    for got, want in ((padded.conv, bare.conv), (padded.ssm, bare.ssm),
                      (padded.k[:, :, :21], bare.k[:, :, :21])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    fed = csm.new_cache(cfg, 1, 64, dtype=torch.float32)
    pids, pmask, _, _ = _pad_to_bucket(ids, mask)
    pmask[:, 21:, 0] = 1  # the pads made real frames
    csm.forward(params, cfg, torch.from_numpy(pids), torch.from_numpy(pmask), cache=fed)
    assert (fed.ssm - bare.ssm).abs().max() > 1e-3 * bare.ssm.abs().max()


@pytest.mark.parametrize("S", [5, 8, 21, 24])
def test_the_chunked_scan_equals_the_recurrence(S):
    """The SSD scan with chunks of 8 (``S`` inside one chunk, on a chunk
    edge, across edges) from a nonzero state, with frames that move no state
    (``dt`` = 0), against the position-by-position recurrence."""
    g = torch.Generator().manual_seed(S)
    H, P, N, G = 4, 3, 5, 2
    x = torch.randn((2, S, H, P), generator=g)
    dt = torch.rand((2, S, H), generator=g) * 0.5
    dt[1, S // 2] = 0.0
    A = -torch.rand((H,), generator=g) - 0.5
    Bm, Cm = torch.randn((2, S, G, N), generator=g), torch.randn((2, S, G, N), generator=g)
    s0 = torch.randn((2, H, P, N), generator=g)
    y, s = hybrid.ssd_scan(x, dt, A, Bm, Cm, 8, s0)
    st, ys = s0, []
    Bh, Ch = Bm.repeat_interleave(2, dim=2), Cm.repeat_interleave(2, dim=2)
    for t in range(S):
        st = torch.exp(dt[:, t] * A)[..., None, None] * st + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None]
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
    torch.testing.assert_close(y, torch.stack(ys, dim=1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, st, rtol=1e-5, atol=1e-5)


def test_the_steps_plain_version_matches_the_reference(model):
    """The mixer stepped frame by frame through ``ssm_step``'s plain version
    (the kernel's oracle) against the reference's Mamba-2 layer over the
    whole sequence, and the states it leaves against the chunked prefill's
    over the same frames."""
    cfg, params = model
    c = cfg.backbone
    lp = {n: w[2] for n, w in params["backbone"]["mamba"].items()}
    x = torch.randn((1, 11, c.hidden_size), generator=torch.Generator().manual_seed(9))
    conv = torch.zeros((1, c.mamba_d_conv - 1, c.conv_dim))
    state = torch.zeros((1, c.mamba_n_heads, c.mamba_d_head, c.mamba_d_state))
    outs = [hybrid._mixer_step(lp, c, x[:, t:t + 1], conv, state) for t in range(11)]
    want = ref.mamba({n: w.float() for n, w in lp.items()}, c, x[0])
    torch.testing.assert_close(torch.cat(outs, dim=1)[0], want, **TOL)
    _, conv2, state2 = hybrid._mixer_scan(lp, c, x, torch.tensor([11]), None, None)
    torch.testing.assert_close(conv, conv2, **TOL)
    torch.testing.assert_close(state, state2, **TOL)


def _solo(params, cfg, ids, mask, n, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return generate(params, cfg, ids, mask, max_new_frames=n, greedy=True, generator=[g],
                    stop_mode="stream")[0]


def test_server_slots_at_different_depths_and_a_freed_slot_readmitted(model):
    """Five greedy requests of 5-30 frames on two slots: slots sit at
    different depths, each slot is freed and readmitted, and every request's
    frames equal its solo run (no state of a slot's earlier request reaches
    the next)."""
    cfg, params = model
    server = CSMServer(params, cfg, n_slots=2, window=128, greedy=True, max_new_frames=5)
    prompts = [_prompt(cfg, S, seed=20 + S) for S in (9, 30, 5, 17, 12)]
    rids = [server.submit(*p, max_new_frames=n) for p, n in zip(prompts, (3, 6, 4, 5, 2))]
    assert server.cache.state_bytes == 9 * 4 * (3 * 160 + 8 * 16 * 16)
    server.run_until_idle()
    for rid, p, n in zip(rids, prompts, (3, 6, 4, 5, 2)):
        np.testing.assert_array_equal(server.results[rid], _solo(params, cfg, *p, n, 0))
    assert server.stats()["prefills"] == 5


def test_a_prefix_and_its_continuation_equal_the_whole_conversation(model):
    """``register_prefix`` keeps the prefix's states and K/V; a continuation
    submitted on it serves the frames of the whole conversation submitted
    at once, and the prefix serves a second continuation unchanged."""
    cfg, params = model
    server = CSMServer(params, cfg, n_slots=2, window=128, greedy=True, max_new_frames=4)
    pre, cont = _prompt(cfg, 19, seed=40), _prompt(cfg, 11, seed=41)
    whole = tuple(np.concatenate([a, b], axis=1) for a, b in zip(pre, cont))
    pid = server.register_prefix(*pre)
    r1 = server.submit(*cont, prefix_id=pid)
    r2 = server.submit(*whole)
    server.run_until_idle()
    np.testing.assert_array_equal(server.results[r1], server.results[r2])
    np.testing.assert_array_equal(server.results[r1], _solo(params, cfg, *whole, 4, 0))
    r3 = server.submit(*cont, prefix_id=pid)
    server.run_until_idle()
    np.testing.assert_array_equal(server.results[r3], server.results[r1])
    assert server.stats()["prefix_prefills"] == 2


def test_the_streamer_runs_the_hybrid_cache(model):
    """``CSMStreamer`` on a prefix: its frames equal the whole prompt's solo
    generation."""
    cfg, params = model
    pre, cont = _prompt(cfg, 14, seed=50), _prompt(cfg, 6, seed=51)
    whole = tuple(np.concatenate([a, b], axis=1) for a, b in zip(pre, cont))
    st = CSMStreamer(params, cfg, greedy=True)
    pid = st.register_prefix(*pre, max_new_frames=64)
    frames = [st.start(*cont, max_new_frames=4, prefix_id=pid)]
    frames += [st.step() for _ in range(3)]
    np.testing.assert_array_equal(np.concatenate(frames), _solo(params, cfg, *whole, 4, 0))


def test_config_round_trip_and_the_published_shapes():
    cfg = CSMConfig.from_dict(dict(CSMConfig().to_dict(), text_vocab_size=100352,
                                   backbone_config=HybridConfig().to_dict()))
    c = cfg.backbone
    assert isinstance(c, HybridConfig) and CSMConfig.from_dict(cfg.to_dict()) == cfg
    assert (c.in_proj_dim, c.conv_dim, c.attention_layers) == (8512, 4352, (5, 15, 25, 35))
    assert len(c.mamba_layers) == 36 and c.vocab_size == 100352
    with pytest.raises(ValueError):
        HybridConfig(position_embedding_type="rope")


# ---------------------------------------------------------------------------
# The mixer step kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mixer step kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("io", [torch.bfloat16, torch.float32])
def test_the_step_kernel_matches_its_plain_version(cuda, B, io):
    """Three consecutive launches at the published widths (64 heads of 64,
    state 128, one group) against the plain version on the card, each from
    the plain version's states, all in ``io``.  The conv state is moved, not
    computed: bitwise.  y and a float32 state differ by the order of float32
    sums (rtol 1e-5); a bfloat16 state may round a value the other way
    (atol: one bf16 step of the largest)."""
    c = HybridConfig()
    g = torch.Generator(device=cuda).manual_seed(B)
    lp = {"conv_w": torch.randn((c.conv_dim, 4), generator=g, device=cuda) * 0.5,
          "conv_b": torch.randn((c.conv_dim,), generator=g, device=cuda) * 0.1,
          "dt_bias": torch.full((c.mamba_n_heads,), -3.0, device=cuda),
          "A_log": torch.linspace(-1, 1, c.mamba_n_heads, device=cuda),
          "D": torch.ones((c.mamba_n_heads,), device=cuda)}
    lp = {k: v.to(io).contiguous() for k, v in lp.items()}
    conv = (torch.randn((B, 3, c.conv_dim), generator=g, device=cuda)).to(io)
    st = torch.randn((B, c.mamba_n_heads, c.mamba_d_head, c.mamba_d_state), generator=g,
                     device=cuda).to(io)
    launches = ssm.ssm_step.launches
    for _ in range(3):
        conv_k, st_k = conv.clone(), st.clone()
        z = torch.randn((B, c.in_proj_dim), generator=g, device=cuda).to(io)
        want = ssm.ssm_step_reference(z, conv, st, lp, c)
        got = ssm.ssm_step(z, conv_k, st_k, lp, c)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(conv_k, conv)
        atol = 1e-5 if io == torch.float32 else float(st.float().abs().max()) * 2 ** -8
        torch.testing.assert_close(st_k.float(), st.float(), rtol=1e-5, atol=atol)
    assert ssm.ssm_step.launches == launches + 3


@pytest.mark.gpu
def test_a_servers_graphed_step_equals_its_eager_step(cuda):
    """A 4-slot greedy server at kernel widths (heads of 64, state 128) on
    the card: its steps, and its admissions' prefills of one bucket, replay
    captured CUDA graphs after the first few, and every request's frames
    equal those of the same server running eagerly throughout.  A second
    graphed server, built after the first is dropped (where its memory
    was), captures its own graphs and never replays the first's."""
    backbone = HybridConfig.tiny(hidden_size=256, intermediate_size=512,
                                 shared_intermediate_size=512, num_attention_heads=4,
                                 num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=64,
                                 mamba_d_state=128, attention_multiplier=1 / 64)
    cfg = CSMConfig.tiny_hybrid(max_seq_len=256, backbone=backbone)
    prompts = [_prompt(cfg, S, seed=60 + S) for S in (9, 30, 5, 17, 12, 40, 7, 25)]
    results = []
    hybrid._CAPTURED.clear()
    hybrid._PREFILLS.clear()
    hybrid._PREFILLS_SEEN.clear()
    for graphs in (False, True, True):
        hybrid.GRAPHS = graphs
        try:
            params = csm.init_params(cfg, seed=7, dtype=torch.bfloat16, device=cuda)
            server = CSMServer(params, cfg, n_slots=4, window=128, greedy=True)
            rids = [server.submit(*p, max_new_frames=12) for p in prompts]
            server.run_until_idle()
            results.append([server.results[r] for r in rids])
            assert len(hybrid._CAPTURED) == len(hybrid._PREFILLS) == int(graphs)
            if graphs:
                assert hybrid._same(hybrid._CAPTURED[0].refs,
                                    hybrid._graph_tensors(params["backbone"], server.cache))
                (prefill,) = hybrid._PREFILLS.values()
                assert hybrid._same(prefill.refs, hybrid._param_tensors(params["backbone"]))
            del params, server
            torch.cuda.empty_cache()
        finally:
            hybrid.GRAPHS = True
    for eager, graphed, again in zip(*results):
        np.testing.assert_array_equal(graphed, eager)
        np.testing.assert_array_equal(again, eager)
