"""TokenLM: the interface every token LM of the port satisfies.

Counterpart of `slamkit_tpu/models/token_lm.py`; `UnitLM` is the one
concrete implementation, and `tlm_factory` is re-exported from here as
there."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional


class TokenLM(ABC):
    @abstractmethod
    def log_likelihood(self, tokens, mean_nll: bool = True,
                       ignore_tokens: Optional[List[int]] = None):
        """Per-sequence log likelihood of a padded token batch."""

    @abstractmethod
    def generate(self, input_ids, attention_mask=None, **kwargs):
        """Sampling continuation of left-padded prompts."""


from .unit_lm import tlm_factory  # noqa: E402  (re-export, as the JAX module does)

__all__ = ["TokenLM", "tlm_factory"]
