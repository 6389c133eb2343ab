"""ctypes binding of the native (C++) audio IO library (port of
``ddim_audio_tpu/data/native_io.py``).

``native/audio_io.cpp`` decodes RIFF/WAVE (PCM 8/16/24/32-bit, IEEE float
32/64, any channel count mixed down to mono) and resamples linearly. The
library is built from that source at first use with the flags of
``native/Makefile`` into the port's own ``ddim_audio_tpu_torch/build/``
(ignored by git; the file name carries a hash of the source, so an edited
source is rebuilt). Where it cannot be built, ``available()`` is False and
``codec.read_audio`` decodes through scipy instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "audio_io.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def _build() -> Path:
    """The library for the current source, compiled if absent."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libaudio_io_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=1)
def _load():
    """The loaded library, or None where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.decode_wav_mono.restype = ctypes.c_int
    lib.decode_wav_mono.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(f32p),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.resample_linear.restype = ctypes.c_int
    lib.resample_linear.argtypes = [
        f32p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_longlong)]
    lib.audio_free.argtypes = [f32p]
    return lib


def available() -> bool:
    return _load() is not None


def load_wav(path: str, target_samplerate: int) -> np.ndarray | None:
    """Decode + mixdown + resample natively. Returns float32 [-1, 1] mono,
    or None when the native library is unavailable (the caller decodes
    another way)."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        raw = f.read()

    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong()
    sr = ctypes.c_int()
    rc = lib.decode_wav_mono(raw, len(raw), ctypes.byref(buf),
                             ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native WAV decode failed (code {rc}): {path}")
    try:
        if sr.value == target_samplerate:
            return np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
        out = ctypes.POINTER(ctypes.c_float)()
        m = ctypes.c_longlong()
        rc = lib.resample_linear(buf, n.value, sr.value, target_samplerate,
                                 ctypes.byref(out), ctypes.byref(m))
        if rc != 0:
            raise ValueError(f"native resample failed (code {rc}): {path}")
        try:
            return np.ctypeslib.as_array(out, shape=(m.value,)).copy()
        finally:
            lib.audio_free(out)
    finally:
        lib.audio_free(buf)
