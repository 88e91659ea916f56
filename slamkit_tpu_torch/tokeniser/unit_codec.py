"""Unit-string codec: the `<UnN>` pseudo-word representation.

A copy of `slamkit_tpu/tokeniser/unit_codec.py`: token ids ARE unit indices
plus an offset, run-length encoding is one `np.diff` pass (itertools.groupby
semantics), and regex appears only at the string boundary. Bulk encode and
decode take the C++ codec (`native/codec.cpp`) where g++ builds it, as the
JAX package selects it (:19-48); where it does not, the Python path, which
gives the same strings and units, runs, and this is logged once.
"""
from __future__ import annotations

import logging
import re
from typing import Iterable, List, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_UNIT_RE = re.compile(r"<Un(\d+)>")

_native = None


def _get_native():
    """The native codec module, or False where it does not build."""
    global _native
    if _native is None:
        from ..native import codec

        try:
            codec._lib()
            _native = codec
        except codec.NativeUnavailable as e:
            logger.info("native codec unavailable, using the Python path: %s", e)
            _native = False
    return _native


def units_to_string(units: Iterable[int]) -> str:
    """[3, 49, 7] -> '<Un3><Un49><Un7>'."""
    native = _get_native()
    if native:
        return native.units_to_string(units)
    return "".join(f"<Un{int(u)}>" for u in units)


def string_to_units(text: str) -> np.ndarray:
    """'<Un3><Un49>' -> array([3, 49]); other characters are ignored."""
    native = _get_native()
    if native:
        return native.string_to_units(text)
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
