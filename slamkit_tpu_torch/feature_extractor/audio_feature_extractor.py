"""AudioFeatureExtractor interface (a copy of
`slamkit_tpu/feature_extractor/audio_feature_extractor.py`)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np


class AudioFeatureExtractor(ABC):
    @abstractmethod
    def extract(self, wav: np.ndarray, lens: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Batch wav [B, T] (+ per-sample lengths) -> list of unit-id arrays."""

    @abstractmethod
    def get_unit_duration(self) -> float:
        """Seconds of audio per discrete unit."""

    @property
    @abstractmethod
    def sample_rate(self) -> int:
        ...
