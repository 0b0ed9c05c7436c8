"""flink_ml_tpu_torch/table.py and linalg.py: columns, SparseBatch, vectors.

Checked against the JAX package's Table where the two share behaviour
(numpy columns, SparseBatch densification, vector columns).
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.table import as_dense_matrix as jax_as_dense_matrix
from flink_ml_tpu_torch import DenseVector, SparseBatch, SparseVector, Table, Vectors
from flink_ml_tpu_torch.table import as_dense_matrix


def _sparse():
    rng = np.random.default_rng(0)
    indices = rng.integers(0, 12, size=(9, 4)).astype(np.int32)
    indices[:, -1] = -1
    for row in indices:  # unique columns per row, as SparseVector requires
        row[:3] = rng.choice(12, 3, replace=False)
    return indices, rng.random((9, 4))


def test_sparse_batch_to_dense_matches_jax():
    indices, values = _sparse()
    np.testing.assert_array_equal(
        SparseBatch(12, indices, values).to_dense(), JaxSparseBatch(12, indices, values).to_dense()
    )


def test_sparse_batch_keeps_tensors_on_their_device():
    indices, values = _sparse()
    sb = SparseBatch(12, torch.from_numpy(indices), torch.from_numpy(values).float())
    assert isinstance(sb.indices, torch.Tensor) and sb.values.dtype == torch.float32
    np.testing.assert_allclose(sb.to_dense(), SparseBatch(12, indices, values).to_dense(), rtol=1e-6)
    assert sb.row(0) == SparseBatch(12, indices, values.astype(np.float32)).row(0)


@pytest.mark.parametrize(
    "indices,values",
    [(np.zeros((3, 2)), np.zeros((3, 3))), (np.zeros(3), np.zeros(3))],
    ids=["shape_mismatch", "not_2d"],
)
def test_sparse_batch_rejects_bad_shapes(indices, values):
    with pytest.raises(ValueError):
        SparseBatch(4, indices, values)


def test_sparse_batch_rejects_mixed_host_and_tensor():
    indices, values = _sparse()
    with pytest.raises(TypeError):
        SparseBatch(12, torch.from_numpy(indices), values)


@pytest.mark.parametrize(
    "column",
    [
        np.arange(6.0),
        np.arange(12.0).reshape(6, 2),
        np.arange(6, dtype=np.int64),
        [DenseVector([1.0, 2.0]), DenseVector([3.0, 4.0])],
    ],
    ids=["vector", "matrix", "int", "dense_vectors"],
)
def test_as_dense_matrix_matches_jax(column):
    port = as_dense_matrix(Table({"x": column}).column("x"))
    ref = jax_as_dense_matrix(JaxTable({"x": column}).column("x"))
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


def test_tensor_columns_stay_tensors():
    X = torch.arange(12.0).reshape(6, 2)
    t = Table({"features": X, "y": torch.zeros(6)})
    assert as_dense_matrix(t.column("features"), allow_device=True) is X
    assert as_dense_matrix(t.column("y"), allow_device=True).shape == (6, 1)
    np.testing.assert_array_equal(as_dense_matrix(t.column("features")), X.numpy())


def test_row_count_mismatch_raises():
    with pytest.raises(ValueError, match="rows"):
        Table({"a": np.zeros(3), "b": torch.zeros(4)})


def test_sparse_vector_column_becomes_sparse_batch():
    t = Table({"f": [Vectors.sparse(5, [1, 3], [1.0, 2.0]), SparseVector(5, [0], [4.0])]})
    col = t.column("f")
    assert isinstance(col, SparseBatch) and col.size == 5
    np.testing.assert_array_equal(col.to_dense(), [[0, 1, 0, 2, 0], [4, 0, 0, 0, 0]])
    assert t.collect()[0]["f"] == SparseVector(5, [1, 3], [1.0, 2.0])


def test_model_data_rows_surface_dense_vectors():
    t = Table({"coefficient": [DenseVector([1.0, 2.0, 3.0])]})
    (row,) = t.collect()
    assert row["coefficient"] == Vectors.dense(1.0, 2.0, 3.0)
