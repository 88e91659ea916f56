"""The preference-optimization (DPO) dataset: {prompt, chosen, rejected} rows.

A copy of `slamkit_tpu/data/preference.py` (`get_repetition_filter_fn`,
`init_preference_optimization_dataset`), copied because the JAX package's
data package imports jax; `tests/test_torch_dpo.py` holds the two equal. Rows
load from jsonl; with `repetition_filter` a row whose prompt_text +
chosen_text repeats itself (auto-BLEU >= max_auto_bleu) is dropped. The words
come from NLTK's word tokenizer where nltk imports, and from a whitespace
split where it does not, as in the JAX package, so both take the same branch
on the same host.
"""
from __future__ import annotations

import logging
from typing import Dict, List

from ..utils.calculation_utils import calc_auto_bleu
from .dataset import load_jsonl_rows

logger = logging.getLogger(__name__)


class _WhitespaceTokenizer:
    def tokenize(self, text):
        return text.split()


def get_repetition_filter_fn(auto_bleu_n: int, max_auto_bleu: float):
    """A row filter: True keeps the row (NLTK word tokenizer when available)."""
    try:
        from nltk.tokenize import NLTKWordTokenizer

        tokenizer = NLTKWordTokenizer()
    except ImportError:
        tokenizer = _WhitespaceTokenizer()

    def filter_fn(x):
        text = x["prompt_text"] + " " + x["chosen_text"]
        return calc_auto_bleu(text, tokenizer, auto_bleu_n) < max_auto_bleu

    return filter_fn


def init_preference_optimization_dataset(cfg) -> Dict[str, List[dict]]:
    """-> {'train': [...], 'validation': [...]} rows keeping only
    prompt/chosen/rejected; cfg is the composed `data` node (train_path,
    val_path, repetition_filter, auto_bleu_n, max_auto_bleu)."""
    splits = {"train": cfg["train_path"]}
    if cfg.get("val_path", None) is not None:
        splits["validation"] = cfg["val_path"]
    out = {}
    for name, path in splits.items():
        rows = list(load_jsonl_rows(path))
        if cfg.get("repetition_filter", False):
            fn = get_repetition_filter_fn(cfg["auto_bleu_n"], cfg["max_auto_bleu"])
            n0 = len(rows)
            rows = [r for r in rows if fn(r)]
            logger.info("repetition filter kept %d/%d %s rows", len(rows), n0, name)
        out[name] = [{k: r[k] for k in ("prompt", "chosen", "rejected")} for r in rows]
    return out
