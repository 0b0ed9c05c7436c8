"""Columnar Table: the data plane of the port.

Port of the bounded half of flink_ml_tpu/table.py. A Table is a dict of
named columns. Numeric columns are (n,) or (n, d) numpy arrays or torch
tensors; a tensor column stays on the device it lives on, and stages
return their outputs there (device in, device out). A SparseBatch holds
padded-CSR rows: (n, k) int32 indices with -1 padding and (n, k) values.

Unbounded data (`StreamTable`) and dictionary-encoded token columns are
later ROADMAP items.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch

from .linalg import DenseVector, SparseVector, Vector

__all__ = ["Table", "SparseBatch", "StreamTable", "as_dense_matrix"]


class SparseBatch:
    """Padded-CSR batch of sparse vectors.

    `indices`: (n, k) int32, padding entries = -1; `values`: (n, k) float.
    Host arrays are normalized to int32/float64 numpy; torch tensors are
    kept as they are, on their device."""

    __slots__ = ("size", "indices", "values")

    def __init__(self, size: int, indices, values):
        self.size = int(size)
        if isinstance(indices, torch.Tensor) or isinstance(values, torch.Tensor):
            if not (isinstance(indices, torch.Tensor) and isinstance(values, torch.Tensor)):
                raise TypeError("SparseBatch indices and values must both be tensors or both host arrays")
            if indices.device != values.device:
                raise ValueError("SparseBatch indices and values must share a device")
            self.indices = indices
            self.values = values
        else:
            self.indices = np.asarray(indices, dtype=np.int32)
            self.values = np.asarray(values, dtype=np.float64)
        if tuple(self.indices.shape) != tuple(self.values.shape) or self.indices.ndim != 2:
            raise ValueError("SparseBatch requires matching (n, k) indices/values")

    @property
    def n(self) -> int:
        return int(self.indices.shape[0])

    def to_dense(self) -> np.ndarray:
        indices, values = _to_numpy(self.indices), _to_numpy(self.values)
        out = np.zeros((self.n, self.size), dtype=np.float64)
        rows, cols = np.nonzero(indices >= 0)
        out[rows, indices[rows, cols]] = values[rows, cols]
        return out

    def row(self, i: int) -> SparseVector:
        indices, values = _to_numpy(self.indices[i]), _to_numpy(self.values[i])
        mask = indices >= 0
        return SparseVector(self.size, indices[mask], values[mask])

    def __len__(self):
        return self.n


class StreamTable:
    """Unbounded input (online training) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StreamTable and online/stream training are not ported yet "
            "(ROADMAP A.8)"
        )


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize_column(values: Any):
    """Normalize a user-provided column into an internal representation."""
    if isinstance(values, (np.ndarray, SparseBatch, torch.Tensor)):
        return values
    values = list(values)
    if values and isinstance(values[0], Vector):
        if all(isinstance(v, DenseVector) for v in values):
            if len({v.size() for v in values}) == 1:
                return np.stack([v.values for v in values])
        if all(isinstance(v, SparseVector) for v in values):
            return _sparse_vectors_to_batch(values)
        return _object_array(values)
    try:
        arr = np.asarray(values)
    except (ValueError, TypeError):
        return _object_array(values)
    if arr.dtype == object or arr.dtype.kind in "US" or arr.shape[:1] != (len(values),):
        return _object_array(values)
    return arr


def _object_array(values: Sequence) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _sparse_vectors_to_batch(vectors: Sequence[SparseVector]) -> SparseBatch:
    size = max((v.size() for v in vectors), default=0)
    k = max((v.indices.size for v in vectors), default=1) or 1
    indices = np.full((len(vectors), k), -1, dtype=np.int32)
    values = np.zeros((len(vectors), k), dtype=np.float64)
    for i, v in enumerate(vectors):
        indices[i, : v.indices.size] = v.indices
        values[i, : v.indices.size] = v.values
    return SparseBatch(size, indices, values)


class Table:
    """A bounded, named-column table."""

    def __init__(self, data: Dict[str, Any]):
        self._columns: Dict[str, Any] = {}
        n = None
        for name, values in data.items():
            col = _normalize_column(values)
            rows = len(col) if isinstance(col, SparseBatch) else int(col.shape[0])
            if n is None:
                n = rows
            elif rows != n:
                raise ValueError(f"Column {name} has {rows} rows, expected {n}")
            self._columns[name] = col
        self._num_rows = n or 0

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def column(self, name: str):
        if name not in self._columns:
            raise KeyError(f"Column {name!r} not in table (have {self.column_names})")
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __len__(self) -> int:
        return self._num_rows

    def with_columns(self, updates: Dict[str, Any]) -> "Table":
        data = dict(self._columns)
        data.update(updates)
        return Table(data)

    def rows(self) -> Iterator[Dict[str, Any]]:
        """Row iterator for host-side consumption (tests, collect())."""
        host = {
            name: col if isinstance(col, SparseBatch) else _to_numpy(col)
            for name, col in self._columns.items()
        }
        for i in range(self._num_rows):
            row = {}
            for name, col in host.items():
                if isinstance(col, SparseBatch):
                    row[name] = col.row(i)
                else:
                    v = col[i]
                    if isinstance(v, np.ndarray) and v.ndim == 1 and v.dtype.kind in "fiu":
                        v = DenseVector(v)
                    row[name] = v
            yield row

    def collect(self) -> List[Dict[str, Any]]:
        return list(self.rows())

    def __repr__(self):
        return f"Table(rows={self._num_rows}, columns={self.column_names})"


def as_dense_matrix(col, allow_device: bool = False):
    """Coerce a features column to a dense (n, d) float matrix. float32
    host input stays float32. With `allow_device`, a torch tensor column is
    returned as a tensor on its own device (1-D becomes (n, 1)); without
    it, the column is copied to a host numpy array."""
    if isinstance(col, SparseBatch):
        return col.to_dense()
    if isinstance(col, torch.Tensor):
        if allow_device:
            return col if col.ndim > 1 else col[:, None]
        col = _to_numpy(col)
    arr = col
    if isinstance(arr, np.ndarray) and arr.dtype == object:
        rows = [
            np.asarray(v.to_array() if isinstance(v, Vector) else v, dtype=np.float64)
            for v in arr
        ]
        return np.stack(rows) if rows else np.zeros((0, 0), dtype=np.float64)
    arr = np.asarray(arr)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr
