"""HiFiGANVocoder: a named (or explicit) CodeHiFiGAN checkpoint on a device.

Counterpart of `slamkit_tpu/vocoder/hifi_gan_vocoder.py`: duration
prediction is on when the checkpoint carries a VariancePredictor, negative
codes are dropped before synthesis, named speakers and styles resolve
through the checkpoint's metadata, and `vocode_batch` synthesises many
continuations through `synthesize_batch`. The checkpoint comes from the
local registry (`checkpoint_manager`), from explicit `model_path` /
`config_path`, or from weights in memory (`from_params`).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Union

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.tree import to_torch
from .audio_vocoder import AudioVocoder
from .checkpoint_manager import CHECKPOINT_MANAGER
from .hifigan import code_generator_forward, load_checkpoint, synthesize_batch

logger = logging.getLogger(__name__)


def _load_meta(path) -> Optional[List[str]]:
    if path is None:
        return None
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class HiFiGANVocoder(AudioVocoder):
    def __init__(self, dense_model_name: Optional[str] = None,
                 quantizer_model_name: Optional[str] = None,
                 vocab_size: Optional[int] = None, vocoder_suffix: Optional[str] = None,
                 speaker_meta=None, style_meta=None, bucket_frames: Optional[int] = None,
                 model_path: Optional[str] = None, config_path: Optional[str] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        device = resolve_device(device)
        speaker_path = style_path = None
        if model_path is None:
            name = f"{dense_model_name}-{quantizer_model_name}-{vocab_size}-hifigan"
            if vocoder_suffix is not None:
                name += "-" + vocoder_suffix
            model_path = CHECKPOINT_MANAGER.get_by_name(name)
            config_path = CHECKPOINT_MANAGER.get_by_name(f"{name}-config")
            speaker_path = (CHECKPOINT_MANAGER.get_by_name(f"{name}-speakers")
                            if speaker_meta else None)
            style_path = (CHECKPOINT_MANAGER.get_by_name(f"{name}-styles")
                          if style_meta else None)
        elif config_path is None:
            raise ValueError("an explicit model_path needs its config_path")
        params, cfg = load_checkpoint(str(model_path), str(config_path), device)
        self._setup(params, cfg, bucket_frames, _load_meta(speaker_path),
                    _load_meta(style_path))
        logger.info("CodeHiFiGAN loaded from %s", model_path)

    @classmethod
    def from_params(cls, params: dict, cfg: dict, bucket_frames: Optional[int] = None,
                    speakers: Optional[List[str]] = None, styles: Optional[List[str]] = None,
                    device: Union[str, torch.device] = DEFAULT_DEVICE) -> "HiFiGANVocoder":
        """A vocoder over a params tree in memory (numpy or torch leaves)."""
        voc = cls.__new__(cls)
        voc._setup(to_torch(params, resolve_device(device)), cfg, bucket_frames, speakers, styles)
        return voc

    def _setup(self, params, cfg, bucket_frames, speakers, styles):
        self.params, self.cfg = params, cfg
        self.speakers, self.styles = speakers, styles
        self.has_dur_predictor = "dur_predictor" in params
        # None = exact: same-length samples batch together, other lengths run
        # apart; N pads lengths to multiples of N (perturbs each tail)
        self.bucket_frames = bucket_frames

    @property
    def output_sample_rate(self) -> int:
        return self.cfg.get("sampling_rate", 16_000)

    def _resolve(self, value: Union[int, str], names: Optional[List[str]], kind: str) -> int:
        if isinstance(value, str):
            if not names:
                raise ValueError(f"named {kind} requested but this vocoder has no "
                                 f"{kind} metadata")
            return names.index(value)
        return int(value)

    def vocode(self, tokens, speaker_id: Union[int, str] = 0, style_id: Union[int, str] = 0,
               f0=None, **kwargs) -> np.ndarray:
        code = np.asarray(tokens).ravel()
        code = code[code >= 0]                 # drop invalid codes
        if code.size == 0:
            return np.asarray([], dtype=np.float32)
        return code_generator_forward(
            self.params, self.cfg, code[None], dur_prediction=self.has_dur_predictor,
            speaker_id=self._resolve(speaker_id, self.speakers, "speaker"),
            style_id=self._resolve(style_id, self.styles, "style"), f0=f0)

    def vocode_batch(self, token_lists, speaker_id: Union[int, str] = 0,
                     style_id: Union[int, str] = 0, f0=None, **kwargs) -> list:
        """Many continuations at once. speaker / style may be scalars
        (broadcast) or per-sample lists; f0 a per-sample list of contours or
        scalar pitches (or None)."""
        n = len(token_lists)
        if kwargs:
            raise TypeError(f"vocode_batch got unexpected kwargs: {sorted(kwargs)}")
        if f0 is not None:
            if np.isscalar(f0) or not hasattr(f0, "__len__") or len(f0) != n:
                raise ValueError(f"vocode_batch f0 must be a per-sample sequence (len {n}); "
                                 f"pass voc.vocode(tokens, f0=contour) for one sample")
            if isinstance(f0, np.ndarray) and f0.ndim == 1:
                raise ValueError(f"vocode_batch f0 got a single 1-D contour; pass a list "
                                 f"of {n} per-sample contours (or scalar pitches)")
        codes, keep = [], []
        for i, t in enumerate(token_lists):
            code = np.asarray(t).ravel()
            code = code[code >= 0]
            if code.size:
                codes.append(code[None])
                keep.append(i)

        def per_sample(v, kind):
            vals = list(v) if isinstance(v, (list, tuple)) else [v] * n
            if len(vals) != n:
                raise ValueError(f"{kind}_id list has {len(vals)} entries for {n} samples")
            names = self.speakers if kind == "speaker" else self.styles
            return [self._resolve(vals[i], names, kind) for i in keep]

        wavs = synthesize_batch(
            self.params, self.cfg, codes, dur_prediction=self.has_dur_predictor,
            speaker_ids=per_sample(speaker_id, "speaker"),
            style_ids=per_sample(style_id, "style"),
            f0s=[f0[i] for i in keep] if f0 is not None else None,
            bucket_frames=self.bucket_frames)
        out = [np.asarray([], dtype=np.float32)] * n
        for w, i in zip(wavs, keep):
            out[i] = w
        return out
