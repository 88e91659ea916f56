"""ctypes binding for the C++ unit-string codec (`codec.cpp`).

A copy of `slamkit_tpu/native/codec.py` (`units_to_string` :69,
`string_to_units` :83), built by `_build.py`; `tokeniser/unit_codec.py`
takes it as its fast path where it builds.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterable

import numpy as np

from . import _build
from ._build import NativeUnavailable

__all__ = ["NativeUnavailable", "string_to_units", "units_to_string"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("codec")
    lib.sk_units_to_string.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.sk_units_to_string.restype = ctypes.c_void_p
    lib.sk_string_to_units.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.sk_string_to_units.restype = ctypes.c_void_p
    lib.sk_codec_free.argtypes = [ctypes.c_void_p]
    lib.sk_codec_free.restype = None
    return lib


def units_to_string(units: Iterable[int]) -> str:
    """[3, 49, 7] -> '<Un3><Un49><Un7>'."""
    lib = _lib()
    arr = np.ascontiguousarray(
        units if isinstance(units, np.ndarray) else list(units), dtype=np.int32)
    ptr = lib.sk_units_to_string(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), arr.size)
    if not ptr:
        raise MemoryError("sk_units_to_string could not allocate its output")
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.sk_codec_free(ptr)


def string_to_units(text: str) -> np.ndarray:
    """'<Un3><Un49>' -> array([3, 49]) int32; other characters are skipped."""
    lib = _lib()
    n = ctypes.c_int64()
    ptr = lib.sk_string_to_units(text.encode(), ctypes.byref(n))
    try:
        if not n.value:
            return np.empty(0, np.int32)
        buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32))
        return np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.sk_codec_free(ptr)
