"""Likelihood and loss helpers (counterpart of
`slamkit_tpu/utils/calculation_utils.py` `token_nll`, `calc_nll` and
`cross_entropy_loss`)."""
from __future__ import annotations

from typing import Optional, Union

import torch

IGNORE_INDEX = -100


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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_items_in_batch: Optional[Union[torch.Tensor, int]] = None,
                       ignore_index: int = IGNORE_INDEX,
                       pre_shifted: bool = False) -> torch.Tensor:
    """Shifted causal-LM loss: the mean NLL over valid targets, or their sum
    over `num_items_in_batch` when the caller gives the accumulation group's
    global count (so microbatch losses add up to the group's mean).

    pre_shifted=True: labels[t] is already the target of logits[t]."""
    if pre_shifted:
        shift_logits, shift_labels = logits, labels
    else:
        shift_logits, shift_labels = logits[..., :-1, :], labels[..., 1:]
    valid = shift_labels != ignore_index
    nll = (token_nll(shift_logits, shift_labels) * valid).sum()
    if num_items_in_batch is not None:
        return nll / num_items_in_batch
    return nll / valid.sum().clamp(min=1)
