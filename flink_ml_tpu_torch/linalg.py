"""Row-level vector and matrix value types (host-side, numpy-backed).

Port of flink_ml_tpu/linalg.py (the reference's linalg/DenseVector.java,
SparseVector.java, DenseMatrix.java, VectorWithNorm.java, Vectors.java and
BLAS.java:30-117). Model data carries these types (a coefficient as a
DenseVector; MinHashLSH's nearest-neighbour key as any Vector, read through
`to_sparse`), and BLAS is the reference's host facade over them. Batched
math lives in torch tensors elsewhere.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

__all__ = ["Vector", "DenseVector", "SparseVector", "DenseMatrix", "Vectors",
           "VectorWithNorm", "BLAS", "vectors_to_dense_batch"]


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

    def to_sparse(self) -> "SparseVector":
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

    def set(self, i: int, value: float) -> None:
        self.values[i] = value

    def to_array(self) -> np.ndarray:
        return self.values

    def to_dense(self) -> "DenseVector":
        return self

    def to_sparse(self) -> "SparseVector":
        (nz,) = np.nonzero(self.values)
        return SparseVector(self.size(), nz.astype(np.int32), self.values[nz])

    def clone(self) -> "DenseVector":
        return DenseVector(self.values.copy())

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

    def to_sparse(self) -> "SparseVector":
        return self

    def clone(self) -> "SparseVector":
        return SparseVector(self.n, self.indices.copy(), self.values.copy())

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


class DenseMatrix:
    """A dense double matrix (linalg/DenseMatrix.java), held as a row-major
    numpy array. `DenseMatrix(rows, cols)` is zeros; `DenseMatrix(rows,
    cols, values)` takes the reference's column-major flat values or a 2-D
    array; `DenseMatrix(array)` a 2-D array."""

    __slots__ = ("values",)

    def __init__(self, num_rows: int, num_cols: int = None, values=None):
        if values is None and num_cols is not None and not np.isscalar(num_cols):
            values, num_cols = num_cols, None
        if np.isscalar(num_rows) and num_cols is not None and values is None:
            self.values = np.zeros((int(num_rows), int(num_cols)), dtype=np.float64)
        elif values is not None:
            arr = np.asarray(values, dtype=np.float64)
            if arr.ndim == 1:
                arr = arr.reshape((int(num_cols), int(num_rows))).T
            self.values = np.ascontiguousarray(arr)
        else:
            arr = np.asarray(num_rows, dtype=np.float64)
            if arr.ndim != 2:
                raise ValueError("DenseMatrix requires a 2-D array")
            self.values = arr

    @property
    def num_rows(self) -> int:
        return int(self.values.shape[0])

    @property
    def num_cols(self) -> int:
        return int(self.values.shape[1])

    def get(self, i: int, j: int) -> float:
        return float(self.values[i, j])

    def set(self, i: int, j: int, value: float) -> None:
        self.values[i, j] = value

    def to_array(self) -> np.ndarray:
        return self.values

    def __eq__(self, other):
        return isinstance(other, DenseMatrix) and np.array_equal(self.values, other.values)

    def __repr__(self):
        return f"DenseMatrix({self.values.tolist()})"


class VectorWithNorm:
    """A vector with its L2 norm (linalg/VectorWithNorm.java)."""

    __slots__ = ("vector", "l2_norm")

    def __init__(self, vector: Vector, l2_norm: float = None):
        self.vector = vector
        if l2_norm is None:
            l2_norm = float(np.linalg.norm(vector.to_array()))
        self.l2_norm = float(l2_norm)


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


def _vals(x) -> np.ndarray:
    if isinstance(x, Vector):
        return x.to_array() if isinstance(x, SparseVector) else x.values
    return np.asarray(x, dtype=np.float64)


class BLAS:
    """The reference's BLAS facade (linalg/BLAS.java:30-117) over the host
    value types above, in numpy. Batched math does not go through here."""

    @staticmethod
    def asum(x) -> float:
        if isinstance(x, SparseVector):
            return float(np.abs(x.values).sum())
        return float(np.abs(_vals(x)).sum())

    @staticmethod
    def axpy(a: float, x, y: DenseVector, k: int = None) -> None:
        """y[:k] += a * x[:k] in place (BLAS.java:35 and its k-limited form)."""
        yv = y.values
        if isinstance(x, SparseVector):
            limit = x.indices.size if k is None else np.searchsorted(x.indices, k)
            yv[x.indices[:limit]] += a * x.values[:limit]
        else:
            xv = _vals(x)
            if k is None:
                k = xv.shape[0]
            yv[:k] += a * xv[:k]

    @staticmethod
    def dot(x, y) -> float:
        if isinstance(x, SparseVector) and isinstance(y, SparseVector):
            _, xi, yi = np.intersect1d(x.indices, y.indices, return_indices=True)
            return float(np.dot(x.values[xi], y.values[yi]))
        if isinstance(x, SparseVector):
            return float(np.dot(x.values, _vals(y)[x.indices]))
        if isinstance(y, SparseVector):
            return float(np.dot(y.values, _vals(x)[y.indices]))
        return float(np.dot(_vals(x), _vals(y)))

    @staticmethod
    def hdot(x, y: DenseVector) -> None:
        """y = x .* y elementwise, in place (BLAS.java hDot)."""
        if isinstance(x, SparseVector):
            mask = np.zeros(y.size(), dtype=np.float64)
            mask[x.indices] = x.values
            y.values *= mask
        else:
            y.values *= _vals(x)

    @staticmethod
    def norm2(x) -> float:
        if isinstance(x, SparseVector):
            return float(np.linalg.norm(x.values))
        return float(np.linalg.norm(_vals(x)))

    @staticmethod
    def scal(a: float, x: Vector) -> None:
        x.values *= a

    @staticmethod
    def gemv(alpha: float, matrix: DenseMatrix, trans_matrix: bool, x: Vector, beta: float,
             y: DenseVector) -> None:
        """y = alpha * op(matrix) @ x + beta * y (BLAS.java:117)."""
        mat = matrix.values.T if trans_matrix else matrix.values
        xv = x.to_array() if isinstance(x, SparseVector) else _vals(x)
        y.values[:] = alpha * (mat @ xv) + beta * y.values


def vectors_to_dense_batch(vectors: Sequence[Union[Vector, np.ndarray, Sequence[float]]]):
    """Per-row vectors stacked into a dense (n, d) float64 host array."""
    rows = [np.asarray(v.to_array() if isinstance(v, Vector) else v, dtype=np.float64)
            for v in vectors]
    return np.stack(rows) if rows else np.zeros((0, 0), dtype=np.float64)
