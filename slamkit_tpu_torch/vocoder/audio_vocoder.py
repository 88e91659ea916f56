"""AudioVocoder interface and factory (a copy of
`slamkit_tpu/vocoder/audio_vocoder.py`, with the device the vocoder runs on)."""
from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from ..utils.device import DEFAULT_DEVICE

_OPTIONAL_KEYS = ("vocoder_suffix", "speaker_meta", "style_meta", "bucket_frames",
                  "model_path", "config_path")


class AudioVocoder(ABC):
    @abstractmethod
    def vocode(self, tokens, **kwargs) -> np.ndarray:
        """Unit-id sequence -> waveform."""

    def vocode_batch(self, token_lists, **kwargs) -> list:
        """Many unit-id sequences -> waveforms (default: one at a time)."""
        return [self.vocode(t, **kwargs) for t in token_lists]


def vocoder_factory(cfg, device=DEFAULT_DEVICE):
    get = cfg.get if hasattr(cfg, "get") else (lambda k, d=None: getattr(cfg, k, d))
    kind = get("vocoder_type")
    if kind is None:
        return None
    if kind != "hifigan":
        raise ValueError(f"Unknown vocoder type: {kind}")
    from .hifi_gan_vocoder import HiFiGANVocoder

    return HiFiGANVocoder(dense_model_name=get("dense_model_name"),
                          quantizer_model_name=get("quantizer_model_name"),
                          vocab_size=get("vocab_size"), device=device,
                          **{k: get(k, None) for k in _OPTIONAL_KEYS})
