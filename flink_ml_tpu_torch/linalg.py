"""Row-level vector value types (host-side, numpy-backed).

Port of the value types of flink_ml_tpu/linalg.py (the reference's
linalg/DenseVector.java, SparseVector.java, Vectors.java) that model data
needs: `get_model_data`/`set_model_data` carry a coefficient as a
DenseVector. Batched math lives in torch tensors elsewhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["Vector", "DenseVector", "SparseVector", "Vectors"]


class Vector:
    """Base vector type (linalg/Vector.java)."""

    def size(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> float:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        raise NotImplementedError

    def to_dense(self) -> "DenseVector":
        raise NotImplementedError


class DenseVector(Vector):
    """Dense double vector (linalg/DenseVector.java)."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != 1:
            raise ValueError("DenseVector requires a 1-D array")

    def size(self) -> int:
        return int(self.values.shape[0])

    def get(self, i: int) -> float:
        return float(self.values[i])

    def to_array(self) -> np.ndarray:
        return self.values

    def to_dense(self) -> "DenseVector":
        return self

    def __len__(self):
        return self.size()

    def __getitem__(self, i):
        return self.values[i]

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(self.values, other.values)

    def __hash__(self):
        return hash(self.values.tobytes())

    def __repr__(self):
        return f"DenseVector({self.values.tolist()})"


class SparseVector(Vector):
    """Sparse double vector with sorted, unique indices (linalg/SparseVector.java)."""

    __slots__ = ("n", "indices", "values")

    def __init__(self, size: int, indices, values):
        indices = np.asarray(indices, dtype=np.int32)
        values = np.asarray(values, dtype=np.float64)
        if indices.shape != values.shape or indices.ndim != 1:
            raise ValueError("indices and values must be 1-D arrays of equal length")
        if indices.size > 0:
            order = np.argsort(indices, kind="stable")
            indices = indices[order]
            values = values[order]
            if indices[0] < 0 or indices[-1] >= size:
                raise ValueError("index out of range")
            if np.any(np.diff(indices) == 0):
                raise ValueError("duplicate indices")
        self.n = int(size)
        self.indices = indices
        self.values = values

    def size(self) -> int:
        return self.n

    def get(self, i: int) -> float:
        pos = np.searchsorted(self.indices, i)
        if pos < self.indices.size and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def to_array(self) -> np.ndarray:
        arr = np.zeros(self.n, dtype=np.float64)
        arr[self.indices] = self.values
        return arr

    def to_dense(self) -> DenseVector:
        return DenseVector(self.to_array())

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.get(i)

    def __eq__(self, other):
        return (
            isinstance(other, SparseVector)
            and self.n == other.n
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.values, other.values)
        )

    def __hash__(self):
        return hash((self.n, self.indices.tobytes(), self.values.tobytes()))

    def __repr__(self):
        return f"SparseVector({self.n}, {self.indices.tolist()}, {self.values.tolist()})"


class Vectors:
    """Factory methods (linalg/Vectors.java)."""

    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(values)

    @staticmethod
    def sparse(size: int, indices: Sequence[int], values: Sequence[float]) -> SparseVector:
        return SparseVector(size, indices, values)
