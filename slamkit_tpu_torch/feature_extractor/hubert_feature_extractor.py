"""HuBERT feature extractor: wav batch -> discrete unit ids on the device.

Counterpart of `slamkit_tpu/feature_extractor/hubert_feature_extractor.py`:
the wav is padded with 40 samples on each side before the forward (:155),
hidden_states[layer] is tapped (layer 9 for hubert-base L9, 11 for
mhubert-25hz), k-means assigns the units, and each sample's frames are
trimmed by its relative length ceil(lens / T * frames) (:178-186);
`load_config_only` builds a config-only extractor for the unit-duration
math; `HUBERT_CONFIG_PRESETS` (:49) knows the two checkpoints the configs
name. Batches pad to their longest wav (no attention mask, as the reference);
`bucket_samples` pads further, opt-in.

Weights come from local files only: a HF directory or a fairseq `.pt` for
HuBERT, `.npy` / `.npz` centroids (a URL is looked up in the cache directory,
never downloaded). `from_params` builds an extractor from weights in memory.
"""
from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.tree import to_torch
from .audio_feature_extractor import AudioFeatureExtractor
from .hubert import HubertConfig, config_from_fairseq, fairseq_model_cfg, forward, load_hubert
from .kmeans import assign_clusters, load_kmeans_centroids

logger = logging.getLogger(__name__)

#: samples of zero padding on each side of every wav before the forward
PAD_SAMPLES = 40

# Architecture facts of the checkpoints the configs name: hubert-base-ls960 is
# the HF default; mhubert-base-25hz (TWIST) adds one stride-2 conv, so frames
# come at 25 Hz (total stride 640, 0.04 s a unit).
HUBERT_CONFIG_PRESETS = {
    "facebook/hubert-base-ls960": {},
    "slprl/mhubert-base-25hz": {
        "conv_dim": (512,) * 8,
        "conv_kernel": (10, 3, 3, 3, 3, 2, 2, 2),
        "conv_stride": (5, 2, 2, 2, 2, 2, 2, 2),
    },
}


def _cache_dir(cache_path: Optional[str]) -> str:
    if cache_path is None:
        cache_path = os.environ.get("SLAMKIT_CACHE", os.path.expanduser("~/.cache/slamkit"))
    return cache_path


class HubertFeatureExtractor(AudioFeatureExtractor):
    def __init__(self, pretrained_model: str = "facebook/hubert-base-ls960",
                 kmeans_path: str = "https://dl.fbaipublicfiles.com/hubert/hubert_base_ls960_L9_km500.bin",
                 layer: int = 9, num_units: int = 500, compile: bool = False,
                 cache_path: Optional[str] = None, load_config_only: bool = False,
                 bucket_samples: Optional[int] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.layer = layer
        self.num_units = num_units
        self.bucket_samples = bucket_samples
        self.device = resolve_device(device)
        self.params = None
        self.centroids = None
        if load_config_only:
            self.config = self._load_config(pretrained_model)
            return
        self.params, self.config = load_hubert(pretrained_model, self.device)
        self._set_centroids(self._resolve_kmeans(kmeans_path, _cache_dir(cache_path)))

    @classmethod
    def from_params(cls, params: dict, config: HubertConfig, centroids, layer: int,
                    num_units: Optional[int] = None, bucket_samples: Optional[int] = None,
                    device: Union[str, torch.device] = DEFAULT_DEVICE) -> "HubertFeatureExtractor":
        """An extractor over weights in memory: `params` a HuBERT params tree
        (numpy or torch leaves), `centroids` [K, C]."""
        fe = cls.__new__(cls)
        fe.layer = layer
        fe.num_units = num_units if num_units is not None else int(np.shape(centroids)[0])
        fe.bucket_samples = bucket_samples
        fe.device = resolve_device(device)
        fe.config = config
        fe.params = to_torch(params, fe.device)
        fe._set_centroids(centroids)
        return fe

    def _set_centroids(self, centroids):
        self.centroids = to_torch(centroids, self.device)
        if self.centroids.shape[0] != self.num_units:
            logger.warning("kmeans has %d centroids but num_units=%d",
                           self.centroids.shape[0], self.num_units)

    @staticmethod
    def _load_config(pretrained_model: str) -> HubertConfig:
        if str(pretrained_model).endswith(".pt"):
            state = torch.load(pretrained_model, map_location="cpu", weights_only=False)
            return config_from_fairseq(fairseq_model_cfg(state))
        local = os.path.join(pretrained_model, "config.json")
        if os.path.isfile(local):
            with open(local) as f:
                return HubertConfig.from_hf_dict(json.load(f))
        if pretrained_model in HUBERT_CONFIG_PRESETS:
            return HubertConfig(**HUBERT_CONFIG_PRESETS[pretrained_model])
        raise FileNotFoundError(f"no HuBERT config for {pretrained_model!r}: not a local "
                                f"directory, a .pt, or one of {sorted(HUBERT_CONFIG_PRESETS)}")

    @staticmethod
    def _resolve_kmeans(kmeans_path: str, cache_path: str) -> np.ndarray:
        """A local file, or a URL's cached copy (the JAX package's cache names:
        `<sha256(url)[:12]>-<basename>`, then the legacy `kmeans_model.bin`)."""
        if not kmeans_path.startswith(("http://", "https://")):
            return load_kmeans_centroids(kmeans_path)
        tag = hashlib.sha256(kmeans_path.encode()).hexdigest()[:12]
        base = os.path.basename(kmeans_path.rstrip("/")) or "kmeans_model.bin"
        cached = os.path.join(cache_path, f"{tag}-{base}")
        legacy = os.path.join(cache_path, "kmeans_model.bin")
        for cand in (cached + ".npy", cached, legacy + ".npy", legacy):
            if os.path.exists(cand):
                return load_kmeans_centroids(cand)
        raise FileNotFoundError(f"k-means centroids for {kmeans_path} are expected at "
                                f"{cached}.npy (or {cached}); nothing is downloaded")

    def _bucket(self, t: int) -> int:
        b = self.bucket_samples
        if not b:
            return t
        return max(((t + b - 1) // b) * b, b)

    @torch.inference_mode()
    def features(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] wav on the device -> the tapped hidden states [B, T', C]."""
        padded = F.pad(wav.float(), (PAD_SAMPLES, PAD_SAMPLES))
        return forward(self.params, self.config, padded, tap_layer=self.layer)

    def extract(self, wav, lens=None) -> List[np.ndarray]:
        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        t = wav.shape[1]
        bucketed = self._bucket(t)
        if bucketed != t:
            wav = np.pad(wav, ((0, 0), (0, bucketed - t)))
        with torch.inference_mode():
            hidden = self.features(torch.from_numpy(wav).to(self.device))
            toks = assign_clusters(hidden, self.centroids).to(torch.int32).cpu().numpy()
        if lens is not None:
            # relative trim against the original (pre-bucket) wav length,
            # scaled to the frames that length gives
            rel_l = np.ceil(np.asarray(lens, dtype=np.float64) / t
                            * self._n_frames(t)).astype(int)
        else:
            rel_l = [self._n_frames(t)] * len(toks)
        return [tk[:n] for tk, n in zip(toks, rel_l)]

    def _n_frames(self, wav_len: int) -> int:
        """Conv-stack output length for a wav of wav_len (+80 pad) samples."""
        t = wav_len + 2 * PAD_SAMPLES
        for k, s in zip(self.config.conv_kernel, self.config.conv_stride):
            t = (t - k) // s + 1
        return t

    def get_unit_duration(self) -> float:
        return math.prod(self.config.conv_stride) / self.sample_rate

    @property
    def sample_rate(self) -> int:
        return 16_000
