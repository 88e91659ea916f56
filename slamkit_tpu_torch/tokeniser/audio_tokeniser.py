"""AudioTokeniser interface and factory.

Counterpart of `slamkit_tpu/tokeniser/audio_tokeniser.py`: the shared
feature-extractor-to-representation step `_represent` with run-length dedup
(:69) and `tokeniser_factory` (:94), which copies the feature extractor's
`num_units` into the tokeniser's params. The factory takes the composed
tokeniser config as nested mappings (or a node with `to_container`) and the
device the feature extractor runs on; `tokeniser_type` picks the unit or
the interleaving tokeniser.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Union

import numpy as np

from ..utils.device import DEFAULT_DEVICE
from . import unit_codec


class AudioTokeniser(ABC):
    @abstractmethod
    def audio_represent(self, wav: np.ndarray, lens: Optional[np.ndarray] = None) -> List[Dict]:
        """Batch of audio -> list of {'units': [...], 'duration': [...]} dicts."""

    @abstractmethod
    def stringify_representation(self, reps: List[Dict], mode: str = "test") -> List[str]:
        """Representation dicts -> '<Un17>...' strings."""

    @abstractmethod
    def tokenise(self, wav: np.ndarray, lens: Optional[np.ndarray] = None) -> dict:
        """Audio batch -> padded token batch (right pads)."""

    @abstractmethod
    def build_prompt(self, wav: np.ndarray, lens: Optional[np.ndarray] = None,
                     output_modality: Optional[str] = None) -> dict:
        """Audio batch -> generation prompt (no trailing eos, left pads)."""

    @abstractmethod
    def decode_sample(self, tokens, output_modality: str = "SPEECH") -> Union[np.ndarray, str]:
        """Token ids -> unit array (SPEECH), dropping specials."""

    @abstractmethod
    def get_ignore_tokens(self, used_token_modality: Optional[str]) -> Optional[List[int]]:
        """Token ids excluded from likelihood scoring / generation."""

    def audio_stringify(self, wav, lens=None) -> List[str]:
        return self.stringify_representation(self.audio_represent(wav, lens))

    @staticmethod
    def _represent(feature_extractor, wav, lens, dedup: bool) -> List[Dict]:
        """Feature extractor -> {'units', 'duration'} per sample, run-length
        deduplicated when `dedup`."""
        out = []
        for t in feature_extractor.extract(wav, lens):
            if dedup:
                units, duration = unit_codec.run_length_encode(t)
            else:
                units = np.asarray(t).astype(int).tolist()
                duration = [1] * len(units)
            out.append({"units": units, "duration": duration})
        return out


def _plain(node) -> dict:
    if hasattr(node, "to_container"):
        return node.to_container()
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in dict(node).items()}


def _init_feature_extractor(fe_type: str, cfg: dict, device):
    if fe_type == "hubert":
        from ..feature_extractor.hubert_feature_extractor import HubertFeatureExtractor

        return HubertFeatureExtractor(**cfg, device=device)
    raise ValueError(f"Unknown speech tokeniser type: {fe_type}")


def tokeniser_factory(cfg, device=DEFAULT_DEVICE) -> AudioTokeniser:
    cfg = _plain(cfg)
    fe_cfg = dict(cfg["feature_extractor"])
    # the vocabulary always follows the feature extractor's unit count
    params = {**cfg.get("params", {}), "num_units": fe_cfg["num_units"]}
    feature_extractor = None
    if params.get("load_fe", True):
        feature_extractor = _init_feature_extractor(cfg["feature_extractor_type"], fe_cfg,
                                                    device)
    if cfg["tokeniser_type"] == "unit":
        from .unit_tokeniser import UnitTokeniser

        return UnitTokeniser(feature_extractor, **params)
    if cfg["tokeniser_type"] == "interleave":
        from .interleaving_tokeniser import InterleavingTokeniser

        return InterleavingTokeniser(feature_extractor, **params)
    raise ValueError(f"Unknown tokeniser type: {cfg['tokeniser_type']}")
