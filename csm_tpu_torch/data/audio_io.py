"""Host-side audio I/O (own copy of ``csm_tpu/data/audio_io.py``): WAV
load/save, stereo→mono, resampling, any supported container.

The counterpart of the reference's ``torchaudio`` usage (``train.py:117-126``,
``README.md:65-70``).  The fast path is the native C++ runtime
(:mod:`csm_tpu_torch.native`: WAV codec, FLAC / MP3 / OGG / FFmpeg decoders,
Kaiser-sinc polyphase resampler, built on first use); these pure-Python
implementations are the behaviour spec and the fallback.  All host-side,
numpy in and out.
"""

from __future__ import annotations

import wave as _wave
from typing import Tuple

import numpy as np

from csm_tpu_torch import native as _native


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 waveform ``[channels, samples]`` in
    [-1, 1], sample_rate).  Supports 8/16/24/32-bit PCM and 32-bit float."""
    if _native.available():
        return _native.wav_read(path)
    with _wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())

    if width == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:  # packed 24-bit
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        as32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        data = as32.astype(np.float32) / float(1 << 23)
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    return data.reshape(-1, n_ch).T, rate


def save_wav(path: str, wave: np.ndarray, sample_rate: int) -> None:
    """Write float32 ``[samples]`` or ``[channels, samples]`` in [-1, 1] as
    16-bit PCM (the README recipe's int16 output, ``README.md:114-118``)."""
    if _native.available():
        return _native.wav_write(path, wave, sample_rate)
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 1:
        wave = wave[None, :]
    pcm = np.clip(wave * 32767.0, -32768, 32767).astype("<i2")
    with _wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


def to_mono(wave: np.ndarray) -> np.ndarray:
    """``[channels, samples]`` → ``[samples]`` by channel mean
    (``train.py:119-120``)."""
    wave = np.asarray(wave)
    if wave.ndim == 1:
        return wave
    return wave.mean(axis=0)


def resample(wave: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling (equivalent role to torchaudio's Resample,
    ``train.py:121-126``)."""
    if orig_rate == target_rate:
        return np.asarray(wave, np.float32)
    if _native.available():
        return _native.resample_poly(wave, orig_rate, target_rate)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_rate, target_rate)
    return resample_poly(
        np.asarray(wave, np.float64), target_rate // g, orig_rate // g
    ).astype(np.float32)


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read any supported container → (``[channels, samples]`` float32,
    sample_rate).

    The native runtime sniffs magic bytes and decodes WAV (all PCM widths +
    float), FLAC (from-scratch decoder in ``native/codecs.cpp``), MP3
    (system libmpg123), and OGG/Vorbis (system libvorbisfile) — covering
    the formats the reference pipeline gets from torchaudio
    (``train.py:117-126``).  Without the native runtime only WAV is
    readable (pure-Python fallback).
    """
    if _native.available():
        return _native.audio_read(path)
    return load_wav(path)


def load_audio_mono(path: str, target_rate: int) -> np.ndarray:
    """Load → mono → resample: the dataset's per-clip pipeline
    (``train.py:117-126``)."""
    wave, rate = load_audio(path)
    return resample(to_mono(wave), rate, target_rate)
