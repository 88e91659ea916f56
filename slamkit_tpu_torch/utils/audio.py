"""Host-side audio I/O: the native libav decoder, a WAV reader where it
cannot be built, WAV writing, resampling with scipy.

The counterpart of `slamkit_tpu/utils/audio.py` (`audio_info` :50,
`load_audio` :76, `_wav_load` :22, `save_wav` :62, `_resample_poly` :42), in
its order: the native decoder (`native/bindings.py`, built by g++ against
the system's libav at first use) reads every format libav reads, FLAC
included. Where it cannot be built (no g++, no libav), a WAV is read by the
Python reader below, which is logged once, and any other format raises with
the build's own error.
"""
from __future__ import annotations

import logging
import wave
from math import gcd
from typing import Tuple

import numpy as np

from ..native import bindings
from ..native.bindings import NativeUnavailable

logger = logging.getLogger(__name__)
_fallback_logged = False


def _native_unavailable(path: str, e: NativeUnavailable):
    """Log once that the WAV reader stands in; raise for any other format."""
    global _fallback_logged
    if not path.lower().endswith(".wav"):
        raise IOError(f"Cannot decode {path}: the native libav decoder is unavailable "
                      f"and only WAV has a Python reader ({e})") from e
    if not _fallback_logged:
        _fallback_logged = True
        logger.warning("native libav decoder unavailable, reading WAV in Python: %s", e)


def audio_info(path: str) -> Tuple[int, int]:
    """(num_frames at the native rate, sample_rate)."""
    try:
        return bindings.audio_info(path)
    except NativeUnavailable as e:
        _native_unavailable(path, e)
    with wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate()


def _wav_load(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr, n, width, ch = w.getframerate(), w.getnframes(), w.getsampwidth(), w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"Unsupported wav sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def resample_poly(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly as _resample

    g = gcd(sr, target_sr)
    return _resample(wav, target_sr // g, sr // g).astype(np.float32)


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """Mono float32 at target_sr (decode, downmix, resample)."""
    try:
        return bindings.decode_audio(path, target_sr)
    except NativeUnavailable as e:
        _native_unavailable(path, e)
    wav, sr = _wav_load(path)
    return resample_poly(wav, sr, target_sr) if sr != target_sr else wav


def save_wav(path: str, wav: np.ndarray, sample_rate: int = 16000):
    """Mono float32 in [-1, 1] as 16-bit PCM WAV."""
    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    pcm = (wav * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
