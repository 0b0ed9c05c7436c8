"""ctypes surface of the native hashing-trick kernels (native/src/hashkernels.cc).

Port of flink_ml_tpu/native/hashkernels.py. The library is built at first
use (`load_hashkernels`), and a failed build raises. A helper returns None
only where an input falls outside the kernel's envelope (a column name
longer than 64 UTF-16 units or outside the BMP, more than 64 columns); the
caller then takes the numpy form, which computes the same function
(FeatureHasher's `_combine_hashed`, the batched murmur3 of
`utils/hashing.py`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from . import load_hashkernels

MAX_PREFIX = 64  # fh_hash_categorical_doubles renders into a 96-unit buffer
MAX_COLS = 64  # fh_combine's per-row scratch


def _prefix_units(prefix: str) -> Optional[np.ndarray]:
    ords = [ord(c) for c in prefix]
    if len(ords) > MAX_PREFIX or any(o > 0xFFFF for o in ords):
        return None
    return np.array(ords, dtype=np.uint16)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def hash_categorical_doubles(values: np.ndarray, prefix: str,
                             num_features: int) -> Optional[np.ndarray]:
    """Bucketed murmur3 of ``prefix + Double.toString(v)`` per row, int32."""
    pre = _prefix_units(prefix)
    if pre is None:
        return None
    lib = load_hashkernels()
    values = np.ascontiguousarray(values, dtype=np.float64)
    out = np.empty(len(values), dtype=np.int32)
    lib.fh_hash_categorical_doubles(_ptr(values), ctypes.c_long(len(values)), _ptr(pre),
                                    ctypes.c_long(len(pre)), ctypes.c_int32(num_features),
                                    _ptr(out))
    return out


def hash_categorical_strings(values: np.ndarray, prefix: str,
                             num_features: int) -> Optional[np.ndarray]:
    """Bucketed murmur3 of ``prefix + s`` per row of a numpy '<U' column, int32."""
    pre = _prefix_units(prefix)
    if pre is None:
        return None
    lib = load_hashkernels()
    S = np.asarray(values)
    if S.dtype.kind != "U":
        S = S.astype(str)
    if S.dtype.itemsize == 0:
        S = S.astype("U1")
    width, n = S.dtype.itemsize // 4, S.shape[0]
    buf = np.ascontiguousarray(S).view(np.uint32).reshape(n, width)
    out = np.empty(n, dtype=np.int32)
    lib.fh_hash_categorical_utf32(_ptr(buf), ctypes.c_long(n), ctypes.c_long(width), _ptr(pre),
                                  ctypes.c_long(len(pre)), ctypes.c_int32(num_features),
                                  _ptr(out))
    return out


def combine_hashed(idxs: np.ndarray,
                   vals: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-row sort and duplicate sum of (bucket, value) pairs: padded CSR,
    indices ascending, -1 padding; equal buckets sum in column order."""
    n, k = idxs.shape
    if k > MAX_COLS:
        return None
    lib = load_hashkernels()
    idxs = np.ascontiguousarray(idxs, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    out_idx = np.empty((n, k), dtype=np.int32)
    out_val = np.empty((n, k), dtype=np.float64)
    lib.fh_combine(_ptr(idxs), _ptr(vals), ctypes.c_long(n), ctypes.c_long(k),
                   _ptr(out_idx), _ptr(out_val))
    return out_idx, out_val
