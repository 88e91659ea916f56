"""Stage-2 token preparation: features jsonl -> tokens jsonl.

A copy of `slamkit_tpu/data/prepare.py` (`process_feature_line` :22,
`prepare_tokens_file` :45), copied because the JAX package's data package
imports jax. Each line's feature record is parsed, optionally merged with its
per-file metadata (aligned text for interleaving), stringified in 'train'
mode, and stripped of the raw fields. The output key order (file_name,
audio_repr, ...) and the `json.dumps` formatting are kept, so the tokens.jsonl
is byte-identical to the JAX package's (`tests/test_torch_prep_cli.py`).
"""
from __future__ import annotations

import json
import logging
import os
from functools import partial
from multiprocessing.pool import ThreadPool
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_RAW_FIELDS = ("units", "duration", "text", "aligned_text", "split_sentence")


def process_feature_line(line: str, tokeniser, requires_meta: bool = False,
                         meta_path: Optional[str] = None) -> Optional[str]:
    """One features.jsonl line as a tokens.jsonl line (None skips it)."""
    try:
        cur = json.loads(line)
        if requires_meta:
            stem = (f"{meta_path}/{Path(cur['file_name']).stem}" if meta_path
                    else os.path.splitext(cur["file_name"])[0])
            meta_file = stem + ".json"
            if not os.path.exists(meta_file):
                logger.warning("%s does not exist. Skipping", meta_file)
                return None
            with open(meta_file, "r") as f:
                cur.update(json.load(f))
        cur["audio_repr"] = tokeniser.stringify_representation([cur], mode="train")[0]
        for field in _RAW_FIELDS:
            cur.pop(field, None)
        return json.dumps(cur)
    except Exception as e:  # a line that fails is skipped, the run goes on
        logger.warning("Failed to process %s. Error: %s, skipping", line, e)
        return None


def prepare_tokens_file(in_path: str, out_path: str, tokeniser,
                        requires_meta: bool = False, meta_path: Optional[str] = None,
                        n_threads: int = 32) -> int:
    """Stream a features jsonl through `process_feature_line` on a thread
    pool, appending to out_path in input order; returns the lines written."""
    fn = partial(process_feature_line, tokeniser=tokeniser,
                 requires_meta=requires_meta, meta_path=meta_path)
    written = 0
    with open(in_path, "r") as f_in, open(out_path, "a+") as f_out:
        with ThreadPool(n_threads) as pool:
            for jsonl in pool.imap(fn, f_in):
                if jsonl:
                    f_out.write(jsonl + "\n")
                    written += 1
    return written
