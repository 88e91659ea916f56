"""ctypes bindings for the native audio decoder (`audio.cpp`).

A copy of `slamkit_tpu/native/bindings.py` (`decode_audio` :65, `audio_info`
:82): the library is built by `_build.py` against the system's libav
(libavformat, libavcodec, libavutil, libswresample). Where it cannot be
built, every call raises `NativeUnavailable` with the build's own error;
`utils/audio.py` then reads a WAV itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from . import _build
from ._build import NativeUnavailable

__all__ = ["NativeUnavailable", "audio_info", "available", "decode_audio"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("audio")
    lib.sk_decode_audio.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.sk_decode_audio.restype = ctypes.c_int
    lib.sk_audio_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.sk_audio_info.restype = ctypes.c_int
    lib.sk_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.sk_free.restype = None
    return lib


def decode_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """Any libav-readable audio file -> mono float32 at target_sr (downmixed
    and resampled by libswresample)."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.sk_decode_audio(path.encode(), target_sr, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    try:
        return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.sk_free(out)


def audio_info(path: str) -> Tuple[int, int]:
    """(frames at the native rate, sample rate) without decoding."""
    lib = _lib()
    frames, sr = ctypes.c_int64(), ctypes.c_int()
    rc = lib.sk_audio_info(path.encode(), ctypes.byref(frames), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"native info failed ({rc}) for {path}")
    return frames.value, sr.value


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False
