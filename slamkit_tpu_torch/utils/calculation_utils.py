"""Likelihood and loss helpers (counterpart of
`slamkit_tpu/utils/calculation_utils.py` `token_nll`, `calc_nll` and
`cross_entropy_loss`), and copies of its text-repetition measures
`calc_ngram` and `calc_auto_bleu` (:58-72), which the DPO data's repetition
filter reads. Each helper takes the `tp` of a decoder split over 'model'
(`parallel/tensor.py`), whose logits are the rank's vocab columns: the NLL
is then `parallel.tensor.vocab_nll`."""
from __future__ import annotations

from typing import List, Optional, Union

import torch

IGNORE_INDEX = -100


def token_nll(logits: torch.Tensor, targets: torch.Tensor, tp=None) -> torch.Tensor:
    """Per-token negative log likelihood. logits [.., V] float32, targets [..].

    Invalid targets (< 0) are looked up at index 0 and must be masked by the
    caller. tp: the decoder's `TensorParallel` (vocab-sharded logits) or None."""
    if tp is not None and tp.vocab is not None:
        from ..parallel.tensor import vocab_nll

        return vocab_nll(logits, targets, tp)
    logz = torch.logsumexp(logits, dim=-1)
    safe_t = targets.clamp(min=0).long()
    gold = torch.gather(logits, -1, safe_t[..., None])[..., 0]
    return logz - gold


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """The sum of x * mask over `dim` (all dims if None), where a masked-out
    entry adds exactly 0 whatever x holds there: an ignored vocab id's -inf
    logit makes its target's NLL +inf, and +inf * 0 would be NaN. (XLA
    rewrites the JAX package's product by a boolean mask as this select.)"""
    picked = torch.where(mask.to(torch.bool), x * mask, 0.0)
    return picked.sum() if dim is None else picked.sum(dim=dim)


def calc_nll(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             len_norm: bool = True, tp=None) -> torch.Tensor:
    """Masked per-sequence NLL, mean (len_norm) or sum over tokens."""
    ll = masked_sum(token_nll(logits, target, tp), mask, dim=-1)
    if len_norm:
        return ll / mask.to(logits.dtype).sum(dim=-1).clamp(min=1)
    return ll


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_items_in_batch: Optional[Union[torch.Tensor, int]] = None,
                       ignore_index: int = IGNORE_INDEX,
                       pre_shifted: bool = False, tp=None) -> torch.Tensor:
    """Shifted causal-LM loss: the mean NLL over valid targets, or their sum
    over `num_items_in_batch` when the caller gives the accumulation group's
    global count (so microbatch losses add up to the group's mean).

    pre_shifted=True: labels[t] is already the target of logits[t]."""
    if pre_shifted:
        shift_logits, shift_labels = logits, labels
    else:
        shift_logits, shift_labels = logits[..., :-1, :], labels[..., 1:]
    valid = shift_labels != ignore_index
    nll = masked_sum(token_nll(shift_logits, shift_labels, tp), valid)
    if num_items_in_batch is not None:
        return nll / num_items_in_batch
    return nll / valid.sum().clamp(min=1)


def calc_ngram(text: str, tokenizer, n: int) -> List[str]:
    tokens = tokenizer.tokenize(text) if hasattr(tokenizer, "tokenize") else text.split()
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def calc_auto_bleu(text: str, tokenizer, n: int) -> float:
    """Fraction of n-grams repeated elsewhere in the same text."""
    ngrams = calc_ngram(text, tokenizer, n)
    if len(ngrams) == 0:
        return 0
    counts = {}
    for g in ngrams:
        counts[g] = counts.get(g, 0) + 1
    return sum(1 for g in ngrams if counts[g] > 1) / len(ngrams)
