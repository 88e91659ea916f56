"""Likelihood helpers (counterpart of `slamkit_tpu/utils/calculation_utils.py`
`token_nll` and `calc_nll`; the training loss waits for the training port)."""
from __future__ import annotations

import torch


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log likelihood. logits [.., V] float32, targets [..].

    Invalid targets (< 0) are looked up at index 0 and must be masked by the
    caller."""
    logz = torch.logsumexp(logits, dim=-1)
    safe_t = targets.clamp(min=0).long()
    gold = torch.gather(logits, -1, safe_t[..., None])[..., 0]
    return logz - gold


def calc_nll(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             len_norm: bool = True) -> torch.Tensor:
    """Masked per-sequence NLL, mean (len_norm) or sum over tokens."""
    mask = mask.to(logits.dtype)
    ll = (token_nll(logits, target) * mask).sum(dim=-1)
    if len_norm:
        return ll / mask.sum(dim=-1).clamp(min=1)
    return ll
