"""Unit-string codec: the `<UnN>` pseudo-word representation.

A copy of `slamkit_tpu/tokeniser/unit_codec.py` without its native fast
path: token ids ARE unit indices plus an offset, run-length encoding is one
`np.diff` pass (itertools.groupby semantics), and regex appears only at the
string boundary.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Sequence

import numpy as np

_UNIT_RE = re.compile(r"<Un(\d+)>")


def units_to_string(units: Iterable[int]) -> str:
    """[3, 49, 7] -> '<Un3><Un49><Un7>'."""
    return "".join(f"<Un{int(u)}>" for u in units)


def string_to_units(text: str) -> np.ndarray:
    """'<Un3><Un49>' -> array([3, 49]); other characters are ignored."""
    return np.asarray([int(m) for m in _UNIT_RE.findall(text)], dtype=np.int32)


def tokenise_unit_string(text: str, offset: int) -> List[int]:
    """'<Un3><Un49>' -> [3 + offset, 49 + offset]; other characters are ignored."""
    return [int(m) + offset for m in _UNIT_RE.findall(text)]


def run_length_encode(tokens) -> tuple[List[int], List[int]]:
    """Deduplicate consecutive repeats -> (units, durations):
    [7, 7, 3, 3, 3, 9] -> ([7, 3, 9], [2, 3, 1])."""
    t = np.asarray(tokens).ravel()
    if t.size == 0:
        return [], []
    boundaries = np.flatnonzero(np.diff(t) != 0) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [t.size]))
    return t[starts].astype(int).tolist(), (ends - starts).astype(int).tolist()


def run_length_decode(units: Sequence[int], durations: Sequence[int]) -> np.ndarray:
    return np.repeat(np.asarray(units, dtype=np.int32), np.asarray(durations))


def decode_ids_to_units(ids: Sequence[int], offset: int, num_units: int) -> np.ndarray:
    """Token ids -> unit indices, dropping out-of-range (special) ids."""
    a = np.asarray(ids, dtype=np.int64) - offset
    return a[(a >= 0) & (a < num_units)].astype(np.int32)
