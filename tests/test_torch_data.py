"""The port's data pipeline (csm_tpu_torch.data, csm_tpu_torch.native) on the
CPU against the JAX package's: the same stub tokenizer and codec
(tests/test_processor.py), the same numpy inputs and ``default_rng`` seeds.
The processor's and the dataset's tensors are exactly equal; the native
library is the same C++ source built by the same compiler, so its reads and
its resampler are bitwise equal to the JAX package's; against scipy the
resampler holds the JAX tests' tolerance (5e-4)."""

import json
import logging
import os
import struct
import wave as pywave

import numpy as np
import pytest
import torch

from csm_tpu import native as jnative
from csm_tpu.data import audio_io as jaudio
from csm_tpu.data.dataset import CSMAudioTextDataset as JaxDataset
from csm_tpu.data.processor import CSMProcessor as JaxProcessor
from csm_tpu.data.tokenizer import load_llama3_tokenizer as jax_load_tokenizer
from csm_tpu_torch import native
from csm_tpu_torch.data import CSMAudioTextDataset, CSMDataCollator, CSMProcessor, audio_io
from csm_tpu_torch.data.processor import IGNORE_INDEX
from csm_tpu_torch.data.tokenizer import load_llama3_tokenizer

from tests.test_native_audio import (
    _encode_flac,
    _encode_mp3_lame,
    _encode_ogg_vorbis,
    _ffmpeg_present,
)
from tests.test_processor import StubCodec, StubTokenizer

KEYS = ("input_ids", "attention_mask", "labels")


def _equal(got: dict, want: dict):
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), k)


# ---------------------------------------------------------------------------
# Processor
# ---------------------------------------------------------------------------


def _wave(n_frames: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(160 * n_frames).astype(np.float32)


def _convo(seed: int, n_audio: int = 5, text: str = "hello there"):
    messages = [
        {"role": "speaker_0", "content": [{"type": "text", "text": text}]},
        {"role": "speaker_1", "content": [{"type": "text", "text": "hi"},
                                          {"type": "audio", "url": "x.wav"}]},
        {"role": "speaker_0", "content": [{"type": "text", "text": "and again"},
                                          {"type": "audio", "url": "y.wav"}]},
    ]
    return messages, [_wave(n_audio, seed), _wave(n_audio + 3, seed + 1)]


def _processors(ratio: int = 4):
    return (CSMProcessor(StubTokenizer(), StubCodec(), amortization_ratio=ratio),
            JaxProcessor(StubTokenizer(), StubCodec(), amortization_ratio=ratio))


def _both(seed: int = 7, **kw) -> dict:
    """Both processors on the same arguments, each with its own
    ``default_rng(seed)``; the outputs must be equal.  Returns the port's."""
    port, jax_proc = _processors()
    got = port(rng=np.random.default_rng(seed), **kw)
    want = jax_proc(rng=np.random.default_rng(seed), **kw)
    _equal(got, want)
    return got


@pytest.mark.parametrize("amortize", [False, True])
def test_processor_single_conversation(amortize):
    messages, audios = _convo(0)
    out = _both(messages=messages, audios=audios, amortize_decoder_training=amortize)
    ids, mask, labels = (out[k][0] for k in KEYS)
    assert ids.shape[1] == 33 and out["input_ids"].shape[0] == 1
    assert (labels[:, -1] == IGNORE_INDEX).all()
    # the audio spans end in the all-zero EOS frame
    audio_rows = np.flatnonzero(mask[:, 0])
    assert (ids[audio_rows[-1], :32] == 0).all()
    if amortize:
        full = _both(messages=messages, audios=audios, amortize_decoder_training=False)
        dropped = (full["labels"][0] != IGNORE_INDEX) & (labels == IGNORE_INDEX)
        assert dropped.any() and not dropped[:, 0].any()


def test_processor_batch_left_pads():
    m0, a0 = _convo(1, n_audio=3, text="short")
    m1, a1 = _convo(2, n_audio=9, text="a much longer first message")
    out = _both(messages=[m0, m1], audios=[a0, a1])
    assert out["input_ids"].shape[0] == 2
    lengths = [_both(messages=m, audios=a)["input_ids"].shape[1] for m, a in ((m0, a0), (m1, a1))]
    pad = max(lengths) - min(lengths)
    assert pad > 0 and out["input_ids"].shape[1] == max(lengths)
    assert (out["labels"][0, :pad] == IGNORE_INDEX).all()
    assert (out["attention_mask"][0, :pad] == 0).all() and (out["input_ids"][0, :pad] == 0).all()


@pytest.mark.parametrize("max_length", [12, 20, 31])
def test_processor_tail_truncation_shifts_message_masks(max_length):
    """Tail truncation with a message mask: the boundaries are shifted by the
    dropped prefix, so the kept message keeps its labels."""
    messages, audios = _convo(3)
    out = _both(messages=messages, audios=audios, max_length=max_length,
                messages_training_mask=[1, 0, 1], amortize_decoder_training=False)
    full = _both(messages=messages, audios=audios, max_length=2048,
                 messages_training_mask=[1, 0, 1], amortize_decoder_training=False)
    assert out["input_ids"].shape[1] == max_length
    np.testing.assert_array_equal(out["input_ids"][0], full["input_ids"][0, -max_length:])
    np.testing.assert_array_equal(out["labels"][0], full["labels"][0, -max_length:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_processor_amortization_draws_equal_frames(seed):
    messages, audios = _convo(4, n_audio=40)
    on = _both(seed=seed, messages=messages, audios=audios, amortization_ratio=8)
    off = _both(seed=seed, messages=messages, audios=audios, amortize_decoder_training=False)
    live = (on["labels"][0, :, 1:-1] != IGNORE_INDEX).any(-1)
    valid = (off["labels"][0, :, :-1] != IGNORE_INDEX).any(-1)
    assert live.sum() == max(1, valid.sum() // 8)


def test_processor_single_text_mode():
    out = _both(text="just text", speaker_id=3)
    want = StubTokenizer().encode("[3]just text")
    np.testing.assert_array_equal(out["input_ids"][0, :, 32], want)
    port, _ = _processors()
    with pytest.raises(ValueError, match="speaker_id"):
        port(text="no speaker")


def test_processor_returns_torch_int64_and_refuses_jax():
    messages, audios = _convo(5)
    port, jax_proc = _processors()
    got = port(messages=messages, audios=audios, return_tensors="pt",
               rng=np.random.default_rng(0))
    want = jax_proc(messages=messages, audios=audios, rng=np.random.default_rng(0))
    for k in KEYS:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.int64
    _equal({k: v.numpy() for k, v in got.items()}, want)
    with pytest.raises(ValueError, match='"np".*"pt"'):
        port(messages=messages, audios=audios, return_tensors="jax")


def test_processor_warns_for_missing_and_unused_audio():
    messages, audios = _convo(6)
    port, _ = _processors()
    with pytest.warns(UserWarning, match="not used"):
        port(messages=messages[:1], audios=audios[:1])
    with pytest.warns(UserWarning, match="no audio tensor"):
        port(messages=messages, audios=audios[:1])


# ---------------------------------------------------------------------------
# Audio I/O and the native library
# ---------------------------------------------------------------------------


def test_native_library_builds_and_is_available():
    assert native.available(), native.load_error()
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")


def test_native_build_is_atomic_and_named_by_its_sources(tmp_path, monkeypatch):
    """Builds racing on one library name (as pytest's workers do) each write
    a temporary file and rename it into place: the library that lands loads,
    and no temporary file is left.  Threads loading at once share one build.
    Another flag gives another name."""
    import ctypes
    import sys
    import threading

    assert native.available(), native.load_error()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    out = native.library_path()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        racers = [threading.Thread(target=run, args=(lambda: native._build(out),))
                  for _ in range(3)]
        for t in racers:
            t.start()
        for t in racers:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in racers) and not errors, errors
        assert sorted(p.name for p in tmp_path.iterdir()) == [os.path.basename(out)]
        ctypes.CDLL(out).resample_poly_len  # a whole library

        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_error", None)
        os.remove(out)
        libs = []
        loaders = [threading.Thread(target=run, args=(lambda: libs.append(native.load()),))
                   for _ in range(4)]
        for t in loaders:
            t.start()
        for t in loaders:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in loaders) and not errors, errors
    finally:
        sys.setswitchinterval(interval)
    assert len(libs) == 4 and libs[0] is not None and all(lib is libs[0] for lib in libs)
    assert sorted(p.name for p in tmp_path.iterdir()) == [os.path.basename(out)]
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != out


def _signal(n: int, seed: int, ch: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((ch, n)) * 0.3, -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("ch", [1, 2])
def test_wavs_written_by_either_package_read_equal(tmp_path, ch):
    wave = _signal(2400, ch, ch)
    p_port, p_jax = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    audio_io.save_wav(p_port, wave if ch > 1 else wave[0], 24000)
    jaudio.save_wav(p_jax, wave if ch > 1 else wave[0], 24000)
    assert open(p_port, "rb").read() == open(p_jax, "rb").read()
    for p in (p_port, p_jax):
        got, rate = audio_io.load_wav(p)
        want, jrate = jaudio.load_wav(p)
        assert rate == jrate == 24000 and got.shape == (ch, 2400)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(audio_io.load_audio(p)[0], jaudio.load_audio(p)[0])
        np.testing.assert_allclose(got, wave, atol=2 / 32768)


def _write_pcm_wav(path: str, ints: np.ndarray, width: int, rate: int) -> None:
    """``ints``: [channels, samples] integers in the width's range, written by
    the standard library's writer (8-bit unsigned, 16/24/32-bit signed)."""
    inter = ints.T.reshape(-1)
    if width == 1:
        raw = inter.astype(np.uint8).tobytes()
    elif width == 3:
        u = inter.astype(np.int64) & 0xFFFFFF
        raw = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], -1).astype(np.uint8).tobytes()
    else:
        raw = inter.astype({2: "<i2", 4: "<i4"}[width]).tobytes()
    with pywave.open(path, "wb") as w:
        w.setnchannels(ints.shape[0])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)


def _write_float_wav(path: str, wave: np.ndarray, rate: int) -> None:
    data = np.ascontiguousarray(wave.T).astype("<f4").tobytes()
    ch = wave.shape[0]
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 3, ch, rate, rate * ch * 4, ch * 4, 32)
           + b"data" + struct.pack("<I", len(data)))
    with open(path, "wb") as f:
        f.write(hdr + data)


@pytest.mark.parametrize("width", [1, 2, 3, 4, "float"])
def test_every_wav_width_reads_equal(tmp_path, width):
    rng = np.random.default_rng(11)
    path = str(tmp_path / f"w{width}.wav")
    if width == "float":
        want = _signal(777, 12, 2)
        _write_float_wav(path, want, 16000)
    else:
        bits = 8 * width
        if width == 1:
            ints = rng.integers(0, 256, (2, 777))
            want = ((ints - 128) / 128.0).astype(np.float32)
        else:
            ints = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (2, 777))
            want = (ints / float(1 << (bits - 1))).astype(np.float32)
        _write_pcm_wav(path, ints, width, 16000)
    got, rate = audio_io.load_wav(path)
    assert rate == 16000 and got.shape == (2, 777)
    np.testing.assert_array_equal(got, jaudio.load_wav(path)[0])
    np.testing.assert_allclose(got, want, atol=1e-7)
    if width != "float":  # the standard library's reader has no float WAV
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native, "available", lambda: False)
            fallback, frate = audio_io.load_wav(path)
        assert frate == 16000
        np.testing.assert_allclose(fallback, want, atol=1e-7)


def test_mono_mix_matches_numpy_and_the_jax_library():
    stereo = np.random.default_rng(2).standard_normal((2, 777)).astype(np.float32)
    got = native.mono_mix(stereo)
    np.testing.assert_array_equal(got, jnative.mono_mix(stereo))
    np.testing.assert_allclose(got, stereo.mean(axis=0), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(audio_io.to_mono(stereo), stereo.mean(axis=0))


@pytest.mark.parametrize("orig,target", [(48000, 24000), (16000, 24000), (44100, 24000)])
def test_resample_is_bitwise_the_jax_librarys(orig, target):
    from math import gcd

    from scipy.signal import resample_poly as scipy_resample

    rng = np.random.default_rng(3)
    t = np.arange(orig) / orig
    wave = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(orig)).astype(
        np.float32)
    got = audio_io.resample(wave, orig, target)
    np.testing.assert_array_equal(got, jnative.resample_poly(wave, orig, target))
    assert len(got) == native.resample_len(len(wave), orig, target)
    g = gcd(orig, target)
    ref = scipy_resample(wave.astype(np.float64), target // g, orig // g)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=5e-4)
    with pytest.MonkeyPatch.context() as mp:  # the scipy fallback
        mp.setattr(native, "available", lambda: False)
        np.testing.assert_allclose(audio_io.resample(wave, orig, target), ref, atol=1e-6)


@pytest.mark.parametrize("subframe", ["verbatim", "fixed1", "lpc1"])
@pytest.mark.parametrize("ch", [1, 2])
def test_flac_decode(tmp_path, subframe, ch):
    rng = np.random.default_rng(0)
    n = 512
    chans = [np.cumsum(rng.integers(-80, 81, n)).astype(np.int64).clip(-32768, 32767)
             for _ in range(ch)]
    path = tmp_path / f"t_{subframe}_{ch}.flac"
    path.write_bytes(_encode_flac(chans, 24000, subframe))
    wave, rate = audio_io.load_audio(str(path))
    assert rate == 24000 and wave.shape == (ch, n)
    np.testing.assert_array_equal(wave, jaudio.load_audio(str(path))[0])
    for c in range(ch):
        np.testing.assert_allclose(wave[c], np.asarray(chans[c], np.float32) / 32768.0,
                                   atol=1e-7)


def test_flac_decoder_rejects_garbage(tmp_path):
    rng = np.random.default_rng(7)
    x = np.cumsum(rng.integers(-50, 51, 256)).clip(-32768, 32767).astype(np.int64)
    good = _encode_flac([x], 24000, "fixed1")
    for name, blob in {"empty": b"", "magic_only": b"fLaC",
                       "garbage_meta": b"fLaC" + bytes(rng.integers(0, 256, 128, np.uint8)),
                       "truncated": good[: len(good) // 2]}.items():
        p = tmp_path / f"{name}.flac"
        p.write_bytes(blob)
        with pytest.raises(IOError):
            native._read_via("flac_read", str(p))


def test_unknown_container_names_the_supported_formats(tmp_path):
    path = str(tmp_path / "junk.bin")
    with open(path, "wb") as f:
        f.write(b"\x01\x02\x03\x04junk" * 64)
    with pytest.raises(IOError, match="FFmpeg|supported natively"):
        native.audio_read(path)


def test_unknown_container_without_ffmpeg_names_the_supported_formats(monkeypatch):
    """Where the system FFmpeg is missing, the runtime returns -30 for an
    unknown container, and the error names what it reads natively."""

    class Lib:
        def audio_read(self, *args):
            return -30

    monkeypatch.setattr(native, "load", Lib)
    with pytest.raises(IOError, match="supported natively: WAV, FLAC, MP3, OGG/Vorbis"):
        native.audio_read("clip.m4a")


def test_mp3_decode(tmp_path):
    rate, n, freq = 24000, 24000, 440.0
    sig = (0.5 * np.sin(2 * np.pi * freq * np.arange(n) / rate) * 32767).astype(np.int16)
    path = str(tmp_path / "t.mp3")
    _encode_mp3_lame(path, sig, rate)
    wave, got_rate = audio_io.load_audio(path)
    assert got_rate == rate and n <= wave.shape[1] < 2 * n
    np.testing.assert_array_equal(wave, jaudio.load_audio(path)[0])
    spec = np.abs(np.fft.rfft(wave[0] * np.hanning(wave.shape[1])))
    assert abs(np.argmax(spec) * rate / wave.shape[1] - freq) < 5.0


def test_ogg_vorbis_decode(tmp_path):
    rate, n, freq = 24000, 24000, 440.0
    path = str(tmp_path / "t.ogg")
    _encode_ogg_vorbis(path, 0.5 * np.sin(2 * np.pi * freq * np.arange(n) / rate), rate)
    wave, got_rate = audio_io.load_audio(path)
    assert got_rate == rate and wave.shape[0] == 1 and abs(wave.shape[1] - n) <= 128
    np.testing.assert_array_equal(wave, jaudio.load_audio(path)[0])
    spec = np.abs(np.fft.rfft(wave[0] * np.hanning(wave.shape[1])))
    assert abs(np.argmax(spec) * rate / wave.shape[1] - freq) < 5.0


def test_ffmpeg_path_decodes_wav_bit_exact(tmp_path):
    if not _ffmpeg_present():
        pytest.skip("system FFmpeg libraries not present")
    w = (0.5 * np.sin(2 * np.pi * 220 * np.arange(12000) / 24000)).astype(np.float32)
    path = str(tmp_path / "tone.wav")
    audio_io.save_wav(path, w, 24000)
    ref, r1 = native.wav_read(path)
    got, r2 = native.ffmpeg_read(path)
    assert r1 == r2 == 24000
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(got, jnative.ffmpeg_read(path)[0])


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def _jsonl(tmp_path, rows) -> str:
    path = str(tmp_path / "d.jsonl")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def _rows(tmp_path):
    """As tests/test_data_pipeline.py's dataset test, plus a 48 kHz stereo
    clip (resampled on load) and a FLAC one."""
    mono = str(tmp_path / "u.wav")
    audio_io.save_wav(mono, (np.random.default_rng(2).standard_normal(160 * 8) * 0.2)
                      .astype(np.float32), 24000)
    stereo = str(tmp_path / "s.wav")
    audio_io.save_wav(stereo, _signal(160 * 12, 3, 2), 48000)
    flac = tmp_path / "f.flac"
    x = np.cumsum(np.random.default_rng(4).integers(-60, 61, 160 * 10)).clip(-32768, 32767)
    flac.write_bytes(_encode_flac([x.astype(np.int64)], 24000, "fixed1"))

    def audio_turn(role, text, url):
        return {"role": role, "content": [{"type": "text", "text": text},
                                          {"type": "audio", "url": url}]}

    return [
        {"messages": [{"role": "speaker_0", "content": [{"type": "text", "text": "one"}]},
                      audio_turn("speaker_1", "two", mono)],
         "training_mask": [0, 1]},
        {"messages": [audio_turn("speaker_0", "three", str(tmp_path / "missing.wav"))]},
        {"messages": [audio_turn("speaker_0", "four", stereo),
                      audio_turn("speaker_1", "five", str(flac))]},
    ]


def test_dataset_items_equal_the_jax_datasets(tmp_path, caplog):
    path = _jsonl(tmp_path, _rows(tmp_path))
    kw = dict(num_train_epochs=3, seed=5)
    ds = CSMAudioTextDataset(path, processor=CSMProcessor(StubTokenizer(), StubCodec()), **kw)
    jds = JaxDataset(path, processor=JaxProcessor(StubTokenizer(), StubCodec()), **kw)
    assert len(ds) == len(jds) == 9
    with caplog.at_level(logging.WARNING):
        items = [ds[i] for i in range(len(ds))]
    for i, item in enumerate(items):
        _equal(item, jds[i])
    assert any("missing.wav" in r.getMessage() for r in caplog.records)
    # the missing clip soft-fails to a text-only conversation
    assert items[1]["input_ids"].shape[0] == len(StubTokenizer().encode("[0]three"))
    # each epoch draws its own amortized frames
    assert not np.array_equal(items[2]["labels"], items[5]["labels"])
    np.testing.assert_array_equal(items[2]["input_ids"], items[5]["input_ids"])
    batch = CSMDataCollator(text_pad_token_id=StubTokenizer.eos_token_id,
                            pad_to_multiple=8)(items[:3])
    assert batch["input_ids"].shape[1] % 8 == 0


def test_dataset_reads_the_audio_cache(tmp_path):
    cache = tmp_path / "cache"
    rows = _rows(tmp_path)[:1]
    real = rows[0]["messages"][1]["content"][1]["url"]
    rows[0]["messages"][1]["content"][1]["url"] = str(tmp_path / "remote" / "u.wav")
    path = _jsonl(tmp_path, rows)
    ds = CSMAudioTextDataset(path, audio_cache_dir=str(cache),
                             processor=CSMProcessor(StubTokenizer(), StubCodec()), seed=1)
    assert cache.is_dir()
    text_only = ds[0]["input_ids"].shape[0]
    (cache / "u.wav").write_bytes(open(real, "rb").read())
    item = ds[0]
    assert item["input_ids"].shape[0] == text_only + 8 + 1
    jds = JaxDataset(path, audio_cache_dir=str(cache),
                     processor=JaxProcessor(StubTokenizer(), StubCodec()), seed=1)
    _equal(item, jds[0])


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


def test_llama3_tokenizer_loader_wraps_bos_eos(tmp_path, monkeypatch):
    """A word-level tokenizer built here and saved through
    PreTrainedTokenizerFast: both loaders give the same ids, BOS first and
    EOS last.  Nothing is downloaded."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    words = ["[UNK]", "<|begin_of_text|>", "<|end_of_text|>", "[", "]", "0", "1",
             "hello", "there", "world"]
    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<|begin_of_text|>",
                            eos_token="<|end_of_text|>",
                            unk_token="[UNK]").save_pretrained(str(tmp_path))
    got = load_llama3_tokenizer(str(tmp_path))
    want = jax_load_tokenizer(str(tmp_path))
    for text in ("[0]hello there", "[1]world hello"):
        ids = got.encode(text, add_special_tokens=True)
        assert ids == want.encode(text, add_special_tokens=True)
        assert ids[0] == 1 and ids[-1] == 2 and len(ids) == 7
    assert got.eos_token_id == 2
