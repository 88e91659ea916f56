"""Host-side audio I/O: WAV read and write, resampling with scipy.

The WAV half of `slamkit_tpu/utils/audio.py` (`_wav_load`, `save_wav`,
`_resample_poly`). The JAX package decodes other formats (FLAC, ...) with its
native libav decoder, which is not ported: anything but a WAV raises.
"""
from __future__ import annotations

import wave
from math import gcd
from typing import Tuple

import numpy as np


def _check_wav(path: str):
    if not path.lower().endswith(".wav"):
        raise IOError(f"Cannot decode {path}: the port reads WAV only (the native "
                      f"decoder for other formats is not ported)")


def audio_info(path: str) -> Tuple[int, int]:
    """(num_frames at the native rate, sample_rate)."""
    _check_wav(path)
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
    _check_wav(path)
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
