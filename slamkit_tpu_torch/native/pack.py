"""ctypes binding for the packing recurrences (`pack.cpp`).

The C++ half of `slamkit_tpu/native/pack.py` (`greedy_pack` :60,
`bestfit_pack` :89, `greedy_pack_count` :138), built by `_build.py`;
`data/pack.py` takes it as its fast path where it builds and keeps the
Python loops, which give the same assignments, beside it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from . import _build
from ._build import NativeUnavailable

__all__ = ["NativeUnavailable", "bestfit_pack", "greedy_pack",
           "greedy_pack_count"]

_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pack")
    lib.sk_greedy_pack.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, _I64P, _I64P, _I64P]
    lib.sk_greedy_pack.restype = None
    lib.sk_greedy_pack_count.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64]
    lib.sk_greedy_pack_count.restype = ctypes.c_int64
    lib.sk_bestfit_pack.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P]
    lib.sk_bestfit_pack.restype = ctypes.c_int64
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def greedy_pack(lens: np.ndarray, context_len: int, row0: int = 0,
                col0: int = 0) -> Tuple[np.ndarray, np.ndarray, int, int]:
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    rows, cols = np.empty(lens.size, np.int64), np.empty(lens.size, np.int64)
    state = np.empty(2, np.int64)
    _lib().sk_greedy_pack(_ptr(lens), lens.size, context_len, row0, col0, _ptr(rows),
                          _ptr(cols), _ptr(state))
    return rows, cols, int(state[0]), int(state[1])


def bestfit_pack(lens: np.ndarray, context_len: int) -> Tuple[np.ndarray, np.ndarray, int]:
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    rows, cols = np.empty(lens.size, np.int64), np.empty(lens.size, np.int64)
    n_rows = _lib().sk_bestfit_pack(_ptr(lens), lens.size, context_len, _ptr(rows), _ptr(cols))
    return rows, cols, int(n_rows)


def greedy_pack_count(lens: np.ndarray, context_len: int) -> int:
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    return int(_lib().sk_greedy_pack_count(_ptr(lens), lens.size, context_len))
