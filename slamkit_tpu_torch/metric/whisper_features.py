"""Whisper's log-mel front end, without transformers.

`slamkit_tpu/metric/whisper_jax.py::JaxWhisperPipeline` (:405) takes its
features from transformers' `WhisperFeatureExtractor`, which computes them in
`_torch_extract_fbank_features` wherever torch imports; this module is that
branch, read from the checkpoint's `preprocessor_config.json`:

  * each clip is cut to `n_samples` (chunk_length x sampling_rate) and
    zero-padded to it;
  * a periodic Hann window of n_fft, `torch.stft` (centred, reflect-padded),
    the power spectrum `|X|^2` without the last frame;
  * the slaney mel filter bank, computed in float64 numpy as
    `transformers.audio_utils.mel_filter_bank(norm="slaney", mel_scale="slaney")`
    computes it, then float32;
  * `log10(clamp(mel, 1e-10))`, floored per clip at its max - 8, then
    (x + 4) / 4.

Everything after the numpy filter bank runs on the given device (the model's;
the card unless the caller names another).
`tests/test_torch_whisper.py` holds it to `WhisperFeatureExtractor`.
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence, Union

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device


def hertz_to_mel(freq: np.ndarray) -> np.ndarray:
    """The slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, np.float64)
    mels = 3.0 * freq / 200.0
    log = freq >= 1000.0
    mels[log] = 15.0 + np.log(freq[log] / 1000.0) * (27.0 / np.log(6.4))
    return mels


def mel_to_hertz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    freq = 200.0 * mels / 3.0
    log = mels >= 15.0
    freq[log] = 1000.0 * np.exp(np.log(6.4) / 27.0 * (mels[log] - 15.0))
    return freq


def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int, min_frequency: float,
                    max_frequency: float, sampling_rate: int) -> np.ndarray:
    """[num_frequency_bins, num_mel_filters] float64: triangular filters
    centred on slaney-mel-spaced frequencies, area-normalised (slaney)."""
    mel_freqs = np.linspace(hertz_to_mel(np.array([min_frequency]))[0],
                            hertz_to_mel(np.array([max_frequency]))[0], num_mel_filters + 2)
    filter_freqs = mel_to_hertz(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    filters = np.maximum(np.zeros(1), np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    return filters * enorm[None, :]


class WhisperFeatures:
    """`WhisperFeatureExtractor(...)(clips, sampling_rate=sr).input_features`
    as a torch computation: clips -> [B, feature_size, n_samples / hop]
    float32 on `device`."""

    def __init__(self, feature_size: int = 80, sampling_rate: int = 16000,
                 hop_length: int = 160, chunk_length: int = 30, n_fft: int = 400,
                 padding_value: float = 0.0, dither: float = 0.0,
                 device: Union[str, torch.device] = DEFAULT_DEVICE, **_unused):
        if dither:
            raise NotImplementedError(f"preprocessor dither={dither}: a dithered front end "
                                      f"draws noise; only dither 0 is ported")
        self.feature_size, self.sampling_rate = int(feature_size), int(sampling_rate)
        self.hop_length, self.n_fft = int(hop_length), int(n_fft)
        self.chunk_length = int(chunk_length)
        self.n_samples = self.chunk_length * self.sampling_rate
        self.padding_value = float(padding_value)
        self.device = resolve_device(device)
        filters = mel_filter_bank(1 + self.n_fft // 2, self.feature_size, 0.0, 8000.0,
                                  self.sampling_rate)
        self.mel_filters = torch.from_numpy(filters).to(self.device, torch.float32)
        self.window = torch.hann_window(self.n_fft, device=self.device)

    @classmethod
    def from_pretrained(cls, path: str, device: Union[str, torch.device] = DEFAULT_DEVICE
                        ) -> "WhisperFeatures":
        """From a checkpoint directory's `preprocessor_config.json`."""
        with open(os.path.join(path, "preprocessor_config.json")) as f:
            cfg = json.load(f)
        keys = ("feature_size", "sampling_rate", "hop_length", "chunk_length", "n_fft",
                "padding_value", "dither")
        return cls(device=device, **{k: cfg[k] for k in keys if k in cfg})

    def pad(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        """[B, n_samples] float32: each clip cut to n_samples, zero-padded."""
        out = np.full((len(clips), self.n_samples), self.padding_value, np.float32)
        for i, c in enumerate(clips):
            c = np.asarray(c, np.float32).reshape(-1)[:self.n_samples]
            out[i, :c.size] = c
        return out

    @torch.no_grad()
    def __call__(self, clips: List[np.ndarray]) -> torch.Tensor:
        wav = torch.from_numpy(self.pad(clips)).to(self.device)
        stft = torch.stft(wav, self.n_fft, self.hop_length, window=self.window,
                          return_complex=True)
        magnitudes = stft[..., :-1].abs() ** 2
        mel = self.mel_filters.T @ magnitudes
        log_spec = torch.clamp(mel, min=1e-10).log10()
        floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
        return (torch.maximum(log_spec, floor) + 4.0) / 4.0
