"""Native (C++) audio runtime bindings (own copy of the JAX package's).

``audio.cpp`` (WAV read / write, mono mix, Kaiser-sinc polyphase resampler)
and ``codecs.cpp`` (FLAC from scratch, MP3 / OGG / FFmpeg through
``dlopen``) are compiled by ``g++`` on first use, never at import, into
``csm_tpu_torch/_build/`` (listed in ``.gitignore``), and bound with ctypes.
The library's name carries a hash of the sources, the flags and the
compiler's version, and it is written to a temporary file first and then
renamed into place, so several processes building at once never load a
half-written or stale library.

Every entry point mirrors a pure-Python function of
:mod:`csm_tpu_torch.data.audio_io`, which is the fallback when the library
cannot be built; :func:`load_error` says why it could not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from math import gcd
from typing import Dict, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("audio.cpp", "codecs.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ldl",)

_float_p = ctypes.POINTER(ctypes.c_float)
_READ = ([ctypes.c_char_p, ctypes.POINTER(_float_p), ctypes.POINTER(ctypes.c_int),
          ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)], ctypes.c_int)

# ``{function: (argtypes, restype)}`` of every ``extern "C"`` function of the
# two sources, set once when the library is loaded (and held against the C
# declarations by tests/test_torch_ctypes_signatures.py).
SIGNATURES: Dict[str, tuple] = {
    "wav_read": _READ,
    "flac_read": _READ,
    "mp3_read": _READ,
    "ogg_read": _READ,
    "audio_read": _READ,
    "ffmpeg_read": _READ,
    "wav_free": ([_float_p], None),
    "wav_write": ([ctypes.c_char_p, _float_p, ctypes.c_int, ctypes.c_int, ctypes.c_long],
                  ctypes.c_int),
    "mono_mix": ([_float_p, ctypes.c_int, ctypes.c_long, _float_p], None),
    "resample_poly_len": ([ctypes.c_long, ctypes.c_int, ctypes.c_int], ctypes.c_long),
    "resample_poly": ([_float_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, _float_p], None),
}

# Return codes of audio_read that name an unsupported file.
_FFMPEG_FAILED = (-51, -52, -53, -54, -55, -56, -57)
_UNKNOWN_CONTAINER = -30

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _compiler() -> str:
    """The compiler's version and target, so that a library built elsewhere
    (a checkout shared between hosts) is not loaded."""
    return subprocess.run(["g++", "-dumpfullversion", "-dumpmachine"], capture_output=True,
                          text=True, check=True).stdout


def library_path() -> str:
    """The library's path, named by a hash of the sources, the flags and the
    compiler."""
    h = hashlib.sha256()
    for src in SOURCES:
        with open(os.path.join(_HERE, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_compiler().encode())
    return os.path.join(BUILD_DIR, f"audio-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *(os.path.join(_HERE, s) for s in SOURCES), "-o", tmp, *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (rc={res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Load the native library, building it if needed; None if it cannot be
    built or loaded (then :func:`load_error` says why)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
        except Exception as e:  # noqa: BLE001 (the pure-Python fallback takes over)
            _error = f"{type(e).__name__}: {e}"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def load_error() -> Optional[str]:
    """Why the library could not be built or loaded; None if it was (or
    has not been tried)."""
    return _error


def _read_via(fn_name: str, path: str) -> Tuple[np.ndarray, int]:
    lib = load()
    data = _float_p()
    ch = ctypes.c_int()
    rate = ctypes.c_int()
    frames = ctypes.c_long()
    rc = getattr(lib, fn_name)(path.encode(), ctypes.byref(data), ctypes.byref(ch),
                               ctypes.byref(rate), ctypes.byref(frames))
    if rc != 0:
        hint = ""
        if rc == _UNKNOWN_CONTAINER:
            hint = ("; unrecognized container — supported natively: WAV, FLAC, MP3, "
                    "OGG/Vorbis; AAC/M4A/MP4 and other containers require the system "
                    "FFmpeg libraries (libavformat/libavcodec), which could not be loaded")
        elif rc in _FFMPEG_FAILED:
            hint = "; FFmpeg could not decode an audio stream from this file"
        raise IOError(f"{fn_name}({path}) failed with code {rc}{hint}")
    try:
        n = frames.value * ch.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
    finally:
        lib.wav_free(data)
    return arr.reshape(frames.value, ch.value).T, rate.value


def wav_read(path: str) -> Tuple[np.ndarray, int]:
    """WAV -> (``[channels, samples]`` float32, sample_rate)."""
    return _read_via("wav_read", path)


def audio_read(path: str) -> Tuple[np.ndarray, int]:
    """Any supported container -> (``[channels, samples]`` float32,
    sample_rate).  WAV / FLAC / MP3 / OGG are sniffed by magic bytes and
    decoded by the built-in paths; anything else (AAC/M4A/MP4, WMA, ALAC,
    ...) falls back to the system FFmpeg libraries when present.  Raises
    ``IOError`` naming the supported formats when no decoder can handle the
    file."""
    return _read_via("audio_read", path)


def ffmpeg_read(path: str) -> Tuple[np.ndarray, int]:
    """Decode ``path`` through the FFmpeg backstop directly, bypassing the
    magic-byte dispatch."""
    return _read_via("ffmpeg_read", path)


def wav_write(path: str, wave: np.ndarray, sample_rate: int) -> None:
    """float32 ``[samples]`` or ``[channels, samples]`` -> 16-bit PCM WAV."""
    lib = load()
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 1:
        wave = wave[None, :]
    interleaved = np.ascontiguousarray(wave.T.reshape(-1))
    rc = lib.wav_write(path.encode(), interleaved.ctypes.data_as(_float_p), wave.shape[0],
                       sample_rate, wave.shape[1])
    if rc != 0:
        raise IOError(f"wav_write({path}) failed with code {rc}")


def mono_mix(wave: np.ndarray) -> np.ndarray:
    """``[channels, samples]`` -> ``[samples]`` channel mean."""
    lib = load()
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 1:
        return wave
    interleaved = np.ascontiguousarray(wave.T.reshape(-1))
    out = np.empty(wave.shape[1], np.float32)
    lib.mono_mix(interleaved.ctypes.data_as(_float_p), wave.shape[0], wave.shape[1],
                 out.ctypes.data_as(_float_p))
    return out


def _ratio(orig_rate: int, target_rate: int) -> Tuple[int, int]:
    g = gcd(orig_rate, target_rate)
    return target_rate // g, orig_rate // g


def resample_len(n: int, orig_rate: int, target_rate: int) -> int:
    """The length :func:`resample_poly` gives ``n`` samples."""
    up, down = _ratio(orig_rate, target_rate)
    return int(load().resample_poly_len(n, up, down))


def resample_poly(wave: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Rational polyphase resample (scipy-compatible Kaiser-sinc design)."""
    lib = load()
    wave = np.ascontiguousarray(wave, np.float32)
    if orig_rate == target_rate:
        return wave
    up, down = _ratio(orig_rate, target_rate)
    out = np.empty(lib.resample_poly_len(len(wave), up, down), np.float32)
    lib.resample_poly(wave.ctypes.data_as(_float_p), len(wave), up, down,
                      out.ctypes.data_as(_float_p))
    return out
