"""Row assignment for packing whole sequences into fixed-length rows.

A copy of `slamkit_tpu/native/pack.py` (`greedy_pack` :60, `bestfit_pack`
:89, `greedy_pack_count` :138): each takes the C++ recurrence
(`native/pack.cpp`) where g++ builds it, and otherwise the Python loop here,
whose tie-breaking matches the C++ multimap bit for bit (logged once);
`tests/test_torch_native.py` holds both paths equal to each other and to the
JAX package's.
"""
from __future__ import annotations

import bisect
import logging
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)

_native = None


def _get_native():
    """The native packer module, or False where it does not build."""
    global _native
    if _native is None:
        from ..native import pack

        try:
            pack._lib()
            _native = pack
        except pack.NativeUnavailable as e:
            logger.info("native packer unavailable, using the Python path: %s", e)
            _native = False
    return _native


def greedy_pack(lens: np.ndarray, context_len: int, row0: int = 0,
                col0: int = 0) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """In-order (row, col) per sequence: a sequence that does not fit the
    current row opens the next one. Returns (rows, cols, row, col), the last
    two being the carry into the next slab."""
    if _get_native():
        return _native.greedy_pack(lens, context_len, row0, col0)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = lens.size
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    row, col = row0, col0
    for i in range(n):
        ln = int(lens[i])
        if col + ln > context_len:
            row += 1
            col = 0
        rows[i] = row
        cols[i] = col
        col += ln
    return rows, cols, row, col


def bestfit_pack(lens: np.ndarray, context_len: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Best-fit-decreasing: (rows, cols, n_rows) per original sequence index.
    Longest first (stable), each into the open row with the least room that
    still fits it; among equal rooms the earliest-opened row wins."""
    if _get_native():
        return _native.bestfit_pack(lens, context_len)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = lens.size
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    order = np.argsort(-lens, kind="stable")
    caps: list = []      # sorted (remaining capacity, insertion sequence number)
    cap_row: list = []   # row id aligned with caps
    n_rows = 0
    for seq, i in enumerate(order):
        ln = int(lens[i])
        j = bisect.bisect_left(caps, (ln, -1))
        if j < len(caps):
            (rem, _), row = caps.pop(j), cap_row.pop(j)
            rows[i] = row
            cols[i] = context_len - rem
            entry = (rem - ln, seq)
        else:
            row = n_rows
            rows[i] = row
            cols[i] = 0
            entry = (context_len - ln, seq)
            n_rows += 1
        k = bisect.bisect_left(caps, entry)
        caps.insert(k, entry)
        cap_row.insert(k, row)
    return rows, cols, n_rows


def greedy_pack_count(lens: np.ndarray, context_len: int) -> int:
    """Number of rows the greedy rule makes (no assembly)."""
    if _get_native():
        return _native.greedy_pack_count(lens, context_len)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    lens = lens[lens > 0]
    if lens.size == 0:
        return 0
    _, _, row, _ = greedy_pack(lens, context_len)
    return row + 1
