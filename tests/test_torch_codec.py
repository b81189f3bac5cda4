"""The port's Mimi codec (csm_tpu_torch.codec) against csm_tpu.codec on the
CPU at MimiCodecConfig.tiny(): the JAX package's random parameters carried
across by mimi_params_from_jax, the same numpy inputs.  Encode is token
exact; decode agrees within fp32 tolerance (the convolutions sum in another
order); streaming equals offline."""

import functools

import jax
import numpy as np
import pytest
import torch

from csm_tpu.codec import convert as jconv
from csm_tpu.codec import mimi as jmimi
from csm_tpu_torch.checkpoint.safetensors_io import save_file
from csm_tpu_torch.codec import convert, mimi, streaming
from csm_tpu_torch.codec import (
    MimiCodec, MimiCodecConfig, StreamingMimiDecoder, StreamingMimiEncoder, load_mimi,
)

# Decode: fp32 convolutions and products summed in another order than XLA's;
# the waveform's values are O(1e-2) at this init, so 1e-5 absolute is ~1e-3
# of them.
WAVE_RTOL, WAVE_ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _pair(window: int = 16):
    jcfg = jmimi.MimiCodecConfig.tiny(sliding_window=window)
    cfg = MimiCodecConfig.tiny(sliding_window=window)
    jp = jconv.random_mimi_params(jcfg, seed=0)
    tp = convert.mimi_params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, jp, cfg, tp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def test_random_params_equal_the_jax_packages_from_the_same_seed():
    jcfg, jp, cfg, tp = _pair()
    want = _leaves(jp)
    got = _leaves(convert.random_mimi_params(cfg, seed=0))
    assert got.keys() == want.keys() == _leaves(tp).keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def _wave(n: int, seed: int, B: int = 2) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal((B, 1, n))).astype(np.float32)


@pytest.mark.parametrize("n", [960 * 4, 960 * 7 + 123])
@pytest.mark.parametrize("nq", [None, 3])
def test_encode_is_token_exact_with_jax(n, nq):
    jcfg, jp, cfg, tp = _pair()
    wave = _wave(n, seed=n)
    want = np.asarray(jmimi.mimi_encode(jcfg, jp, wave, nq))
    got = mimi.mimi_encode(cfg, tp, torch.from_numpy(wave), nq).numpy()
    assert got.shape == want.shape == (2, nq or cfg.num_quantizers, -(-n // 1920))
    np.testing.assert_array_equal(got, want)


def _codes(cfg, F: int, seed: int, B: int = 2, Q=None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.codebook_size, (B, Q or cfg.num_quantizers, F)).astype(np.int32)


@pytest.mark.parametrize("F,Q", [(5, None), (3, 4)])
def test_decode_matches_jax(F, Q):
    jcfg, jp, cfg, tp = _pair()
    codes = _codes(cfg, F, seed=F, Q=Q)
    want = np.asarray(jmimi.mimi_decode(jcfg, jp, codes))
    got = mimi.mimi_decode(cfg, tp, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 1, F * 1920)
    np.testing.assert_allclose(got, want, rtol=WAVE_RTOL, atol=WAVE_ATOL)


def test_sliding_window_is_active_past_its_length():
    """The codec transformer over 24 tokens, past the tiny window of 16 (layer
    scales at 1, so attention shows): the port matches the JAX package, the
    first 16 rows equal a full causal transformer's, and later rows differ
    from it, so the window is what the two packages agree on."""
    jcfg, jp, cfg, tp = _pair()
    jt = jax.tree.map(lambda a: a, jp["decoder_transformer"])
    jt["layers"] = {**jt["layers"], "scale_attn": jt["layers"]["scale_attn"] * 0 + 1,
                    "scale_mlp": jt["layers"]["scale_mlp"] * 0 + 1}
    tt = convert.mimi_params_from_jax(jax.tree.map(np.asarray, jt))
    x = np.random.default_rng(4).standard_normal((1, 24, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jmimi.codec_transformer(jcfg, jt, x))
    got = mimi.codec_transformer(cfg, tt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    full = mimi.codec_transformer(MimiCodecConfig.tiny(sliding_window=None), tt,
                                  torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[:, :16], full[:, :16], rtol=1e-4, atol=1e-5)
    assert np.abs(got[:, 16:] - full[:, 16:]).min(axis=-1).max() > 0
    assert np.abs(got[:, 16:] - full[:, 16:]).max() > 100 * 1e-5


def _hf_state_dict(cfg, seed: int) -> dict:
    """A numpy state dict in the HF ``MimiModel`` key layout."""
    rng = np.random.default_rng(seed)
    sd = {}

    def r(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    for prefix, plan in (("encoder", mimi.encoder_plan(cfg)), ("decoder", mimi.decoder_plan(cfg))):
        for i, item in enumerate(plan):
            if item[0] == "conv":
                s = item[1]
                shape = ((s.in_ch, s.out_ch // s.groups, s.kernel) if s.transposed
                         else (s.out_ch, s.in_ch // s.groups, s.kernel))
                sd[f"{prefix}.layers.{i}.conv.weight"] = r(*shape)
                sd[f"{prefix}.layers.{i}.conv.bias"] = r(s.out_ch)
            elif item[0] == "resnet":
                for bi, s in zip((1, 3), item[1]):
                    sd[f"{prefix}.layers.{i}.block.{bi}.conv.weight"] = r(s.out_ch, s.in_ch,
                                                                          s.kernel)
                    sd[f"{prefix}.layers.{i}.block.{bi}.conv.bias"] = r(s.out_ch)
    H, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    for prefix in ("encoder_transformer", "decoder_transformer"):
        for i in range(cfg.num_hidden_layers):
            base = f"{prefix}.layers.{i}"
            for n, shape in (("self_attn.q_proj", (cfg.num_attention_heads * hd, H)),
                             ("self_attn.k_proj", (cfg.num_key_value_heads * hd, H)),
                             ("self_attn.v_proj", (cfg.num_key_value_heads * hd, H)),
                             ("self_attn.o_proj", (H, cfg.num_attention_heads * hd)),
                             ("mlp.fc1", (I, H)), ("mlp.fc2", (H, I))):
                sd[f"{base}.{n}.weight"] = r(*shape)
            for n in ("input_layernorm.weight", "input_layernorm.bias",
                      "post_attention_layernorm.weight", "post_attention_layernorm.bias",
                      "self_attn_layer_scale.scale", "mlp_layer_scale.scale"):
                sd[f"{base}.{n}"] = r(H)
    sd["downsample.conv.weight"] = r(H, H, mimi.downsample_spec(cfg).kernel)
    up = mimi.upsample_spec(cfg)
    sd["upsample.conv.weight"] = r(H, H // up.groups, up.kernel)
    for name, n in (("semantic", cfg.num_semantic_quantizers),
                    ("acoustic", cfg.num_quantizers - cfg.num_semantic_quantizers)):
        base = f"quantizer.{name}_residual_vector_quantizer"
        sd[f"{base}.input_proj.weight"] = r(cfg.codebook_dim, H, 1)
        sd[f"{base}.output_proj.weight"] = r(H, cfg.codebook_dim, 1)
        for i in range(n):
            sd[f"{base}.layers.{i}.codebook.embed_sum"] = r(cfg.codebook_size, cfg.codebook_dim)
            usage = rng.random(cfg.codebook_size).astype(np.float32) * 3
            usage[:2] = 0.0  # clamped to eps by the conversion
            sd[f"{base}.layers.{i}.codebook.cluster_usage"] = usage
    return sd


def test_state_dict_converters_agree(tmp_path, monkeypatch):
    """One numpy state dict in the HF layout through both packages'
    converters gives equal parameters; load_mimi reads the same from a
    safetensors file (by path and by CSM_TPU_MIMI_PATH) and raises
    FileNotFoundError, naming what is missing, without one."""
    jcfg, _, cfg, _ = _pair()
    sd = _hf_state_dict(cfg, seed=5)
    want = _leaves(jconv.mimi_params_from_state_dict(sd, jcfg))
    got = _leaves(convert.mimi_params_from_state_dict(sd, cfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)

    save_file({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    codec = load_mimi(str(tmp_path), num_codebooks=4, config=cfg, device="cpu")
    assert codec.num_codebooks == 4
    loaded = _leaves(codec.params)
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k], k)
    monkeypatch.setenv("CSM_TPU_MIMI_PATH", str(tmp_path / "model.safetensors"))
    assert _leaves(load_mimi(config=cfg, device="cpu").params).keys() == want.keys()
    monkeypatch.delenv("CSM_TPU_MIMI_PATH")
    with pytest.raises(FileNotFoundError, match="CSM_TPU_MIMI_PATH"):
        load_mimi(config=cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="nowhere"):
        load_mimi(str(tmp_path / "nowhere"), config=cfg, device="cpu")


@pytest.mark.parametrize("chunks", [[1] * 6, [2, 3, 1], [6]])
def test_streaming_decode_equals_offline(chunks):
    jcfg, jp, cfg, tp = _pair()
    codec = MimiCodec(cfg, tp, device="cpu")
    codes = _codes(cfg, sum(chunks), seed=40 + len(chunks))
    offline = mimi.mimi_decode(cfg, codec.params, torch.from_numpy(codes))[:, 0].numpy()
    dec = StreamingMimiDecoder(codec, batch=2)
    parts, t = [], 0
    for c in chunks:
        parts.append(dec.feed(codes[:, :, t:t + c]))
        assert parts[-1].shape == (2, c * 1920)
        t += c
    np.testing.assert_allclose(np.concatenate(parts, axis=-1), offline, rtol=WAVE_RTOL,
                               atol=WAVE_ATOL)
    # Against the JAX package's streaming decoder too.
    from csm_tpu.codec import streaming as jstreaming

    js, t, jparts = jstreaming.decode_state_init(jcfg, 2), 0, []
    for c in chunks:
        out, js = jstreaming.decode_step(jcfg, jp, js, codes[:, :, t:t + c])
        jparts.append(np.asarray(out[:, 0]))
        t += c
    np.testing.assert_allclose(np.concatenate(parts, -1), np.concatenate(jparts, -1),
                               rtol=WAVE_RTOL, atol=WAVE_ATOL)


def test_streaming_decode_past_the_window_and_reset():
    """20 frames one at a time (40 tokens, past the window of 16) equal
    offline; after ``reset`` a new stream decodes as a fresh decoder does."""
    jcfg, jp, cfg, tp = _pair()
    codec = MimiCodec(cfg, tp, device="cpu")
    a, b = _codes(cfg, 20, seed=7, B=1), _codes(cfg, 3, seed=8, B=1)
    dec = StreamingMimiDecoder(codec)
    got = np.concatenate([dec.feed(a[:, :, t:t + 1]) for t in range(20)], axis=-1)
    np.testing.assert_allclose(got, codec.decode(a), rtol=WAVE_RTOL, atol=WAVE_ATOL)
    dec.reset()
    assert dec.state["kv"]["pos"] == 0
    again = np.concatenate([dec.feed(b[:, :, t:t + 1]) for t in range(3)], axis=-1)
    fresh = StreamingMimiDecoder(codec)
    want = np.concatenate([fresh.feed(b[:, :, t:t + 1]) for t in range(3)], axis=-1)
    np.testing.assert_array_equal(again, want)


def test_streaming_decode_rebases_long_streams(monkeypatch):
    """Past the RoPE table the cached keys are rotated back and the position
    shifts down; the audio stays the offline decode's."""
    jcfg, jp, cfg, tp = _pair()
    monkeypatch.setattr(streaming, "ROPE_TABLE_POS", 16)
    codec = MimiCodec(cfg, tp, device="cpu")
    codes = _codes(cfg, 14, seed=9, B=1)
    dec = StreamingMimiDecoder(codec)
    got = np.concatenate([dec.feed(codes[:, :, t:t + 1]) for t in range(14)], axis=-1)
    assert dec.state["kv"]["pos"] < 28
    np.testing.assert_allclose(got, codec.decode(codes), rtol=WAVE_RTOL, atol=WAVE_ATOL)


@pytest.mark.parametrize("chunks", [[1, 1, 1, 1], [3, 1]])
def test_streaming_encode_equals_offline(chunks):
    jcfg, jp, cfg, tp = _pair()
    codec = MimiCodec(cfg, tp, device="cpu")
    wave = _wave(1920 * sum(chunks), seed=11)
    offline = codec.encode_batch(torch.from_numpy(wave)).numpy()
    enc = StreamingMimiEncoder(codec, batch=2)
    parts, t = [], 0
    for c in chunks:
        parts.append(enc.feed(wave[..., t * 1920:(t + c) * 1920]))
        t += c
    np.testing.assert_array_equal(np.concatenate(parts, axis=-1), offline)
    enc.reset()
    np.testing.assert_array_equal(enc.feed(wave[..., :1920]), offline[..., :1])
    with pytest.raises(ValueError, match="frame_size"):
        enc.feed(wave[..., :1000])


def test_codec_wrapper_round_trip_shapes():
    jcfg, jp, cfg, tp = _pair()
    codec = MimiCodec(cfg, tp, num_codebooks=5, device="cpu")
    codes = codec.encode(_wave(1920 * 3, seed=3, B=1)[0, 0])
    assert codes.shape == (5, 3) and codes.dtype == np.int64
    assert codec.decode(codes).shape == (3 * 1920,)
    np.testing.assert_array_equal(
        codes, np.asarray(jmimi.MimiCodec(jcfg, jp, num_codebooks=5).encode(
            _wave(1920 * 3, seed=3, B=1)[0, 0])))


def test_rvq_decode_clamps_codes_past_the_codebook():
    """CSM's audio vocabulary has 2051 ids and Mimi 2048 centroids: the
    port's ``rvq_decode`` gives a code past the codebook the last centroid
    (codes 2048 and 2050 decode as 2047), where the JAX ``_rvq_decode``'s
    ``jnp.take`` fills NaN.  On codes clipped to 2047 the two agree."""
    rng = np.random.default_rng(5)
    Q, V, D = 3, 2048, 8
    books = rng.standard_normal((Q, V, D)).astype(np.float32)
    codes = np.broadcast_to(np.array([0, 2047, 2048, 2050]), (2, Q, 4)).copy()
    codes[1, 1] = [5, 2047, 2049, 2050]
    got = mimi.rvq_decode(torch.from_numpy(books), torch.from_numpy(codes)).numpy()
    assert got.shape == (2, 4, D) and np.isfinite(got).all()
    for t in (2, 3):
        np.testing.assert_array_equal(got[:, t], got[:, 1])
    clipped = np.minimum(codes, V - 1)
    want = np.asarray(jmimi._rvq_decode(jax.numpy.asarray(books), jax.numpy.asarray(clipped)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        mimi.rvq_decode(torch.from_numpy(books), torch.from_numpy(clipped)).numpy(), want,
        rtol=1e-6, atol=1e-6)


def test_convolutions_run_without_tf32_whatever_the_caller_set(monkeypatch):
    """Every Mimi pass (offline encode and decode, streaming encode and
    decode) runs its convolutions with ``cudnn.allow_tf32`` off, and leaves
    the caller's setting as it was, also when blocks overlap across
    threads; the card's codes drifted under the default TF32."""
    import threading

    jcfg, jp, cfg, tp = _pair()
    codec = MimiCodec(cfg, tp, device="cpu")
    seen = []
    plain = {name: getattr(torch.nn.functional, name) for name in ("conv1d", "conv_transpose1d")}

    def recording(name):
        def conv(*args, **kw):
            seen.append(torch.backends.cudnn.allow_tf32)
            return plain[name](*args, **kw)
        return conv

    for name in plain:
        monkeypatch.setattr(torch.nn.functional, name, recording(name))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    wave = _wave(1920 * 2, seed=5, B=1)
    codes = codec.encode(wave[0, 0])
    codec.decode(codes)
    StreamingMimiEncoder(codec).feed(wave)
    StreamingMimiDecoder(codec).feed(codes[None, :, :1])
    assert seen and not any(seen)
    assert torch.backends.cudnn.allow_tf32 is True

    # Two threads inside at once: the setting comes back only after both.
    inside, release = threading.Event(), threading.Event()

    def hold():
        with mimi.fp32_convolutions:
            inside.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    assert inside.wait(10)
    with mimi.fp32_convolutions:
        pass
    assert torch.backends.cudnn.allow_tf32 is False
    release.set()
    t.join(10)
    assert not t.is_alive() and torch.backends.cudnn.allow_tf32 is True
