"""Column conversion functions between vector and array layouts.

Port of flink_ml_tpu/functions.py (the reference's Table-API scalar UDFs
`Functions.vectorToArray` / `Functions.arrayToVector`,
flink-ml-lib/src/main/java/org/apache/flink/ml/Functions.java:10-38). The
conversion is columnar: the dense layout of both vectors and arrays is an
(n, d) numeric matrix, host or tensor, so uniform widths pass through
(a tensor stays where it is) and only ragged or object columns become
per-row objects. Nothing here computes, so nothing needs a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .linalg import DenseVector, Vector
from .table import SparseBatch

__all__ = ["vector_to_array", "array_to_vector"]


def vector_to_array(col):
    """Vector column -> array column (VectorToArrayFunction.eval).

    Dense (n, d) batches (numpy or a tensor) pass through unchanged: they
    already are the columnar array layout. A SparseBatch densifies on the
    host; object columns of Vector values become per-row float lists
    (ragged widths stay ragged).
    """
    if isinstance(col, SparseBatch):
        return col.to_dense()
    if isinstance(col, torch.Tensor) and col.ndim == 2:
        return col
    arr = col
    if isinstance(arr, np.ndarray) and arr.dtype != object:
        if arr.ndim == 2:
            return arr
        raise ValueError("vector_to_array expects an (n, d) vector column")
    out_rows = []
    for v in arr:
        if isinstance(v, Vector):
            out_rows.append(np.asarray(v.to_array(), dtype=np.float64))
        else:
            out_rows.append(np.asarray(v, dtype=np.float64))
    widths = {r.shape[0] for r in out_rows}
    if len(widths) == 1:
        return np.stack(out_rows)
    out = np.empty(len(out_rows), dtype=object)
    for i, r in enumerate(out_rows):
        out[i] = r.tolist()
    return out


def array_to_vector(col):
    """Array column -> DenseVector column (ArrayToVectorFunction.eval).

    Uniform-width numeric input (lists, (n, d) arrays, tensors) becomes or
    stays the (n, d) dense batch; ragged object input becomes an object
    column of DenseVector values.
    """
    if isinstance(col, torch.Tensor) and col.ndim == 2:
        return col
    arr = col
    if isinstance(arr, np.ndarray) and arr.dtype != object:
        if arr.ndim == 2:
            return arr.astype(np.float64, copy=False)
        raise ValueError("array_to_vector expects an (n, d) array column")
    rows = [np.asarray(v, dtype=np.float64) for v in arr]
    widths = {r.shape[0] for r in rows}
    if len(widths) == 1:
        return np.stack(rows)
    out = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        out[i] = DenseVector(r)
    return out
