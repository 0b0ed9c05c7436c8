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


# -- C.24: Table.rows makes every non-string 1-D row a DenseVector ------------

def _row_value(v):
    """A row's value in a form both packages' values compare in."""
    if type(v).__name__ == "DenseVector":
        return ("DenseVector", v.values.dtype.str, v.values.tolist())
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.tolist())
    if isinstance(v, np.generic):
        return ("scalar", v.dtype.str, v.item())
    return (type(v).__name__, v)


def _rows(table):
    return [{k: _row_value(v) for k, v in row.items()} for row in table.collect()]


C24_ROWS = np.random.default_rng(24)
C24_COLUMNS = {
    "bool": C24_ROWS.random((5, 3)) > 0.5,
    "numeric_object": C24_ROWS.integers(-4, 4, (5, 3)).astype(object),
    "float": C24_ROWS.standard_normal((5, 3)),
    "unicode": np.array([["a", "bb", "c"]] * 5),
    "scalar_bool": C24_ROWS.random(5) > 0.5,
}


@pytest.mark.parametrize("kind", sorted(C24_COLUMNS))
def test_rows_match_jax_c24(kind):
    """Exact: every row value as the JAX package's Table gives it."""
    col = C24_COLUMNS[kind]
    assert _rows(Table({"x": col})) == _rows(JaxTable({"x": col}))


def test_torch_bool_tensor_rows_match_jax_c24():
    """A tensor column goes through the same rule after its host copy."""
    col = C24_COLUMNS["bool"]
    port = _rows(Table({"x": torch.from_numpy(col)}))
    assert port == _rows(JaxTable({"x": col}))
    assert port[0]["x"][0] == "DenseVector"


def test_string_object_rows_raise_as_in_jax_c24():
    col = np.array([["a", "b"], ["c", "d"]], dtype=object)
    with pytest.raises(ValueError):
        JaxTable({"x": col}).collect()
    with pytest.raises(ValueError):
        Table({"x": col}).collect()


# -- A.16: the JAX Table's constructors and column operations -----------------

def _columns(seed, device_kind):
    """Host or tensor columns made from one seed (the JAX side's
    counterparts of tensors are jax.Arrays, in float32)."""
    rng = np.random.default_rng(seed)
    host = {"f": rng.standard_normal((7, 3)), "y": rng.integers(0, 2, 7).astype(np.float64),
            "w": rng.random(7)}
    if device_kind == "host":
        return host, host
    import jax.numpy as jnp

    host = {k: v.astype(np.float32) for k, v in host.items()}  # a jax.Array is float32
    return ({k: torch.from_numpy(v) for k, v in host.items()},
            {k: jnp.asarray(v) for k, v in host.items()})


def _same_table(port, ref):
    assert port.column_names == ref.column_names and port.num_rows == ref.num_rows
    for name in port.column_names:
        np.testing.assert_array_equal(np.asarray(port.column(name)), np.asarray(ref.column(name)))


@pytest.mark.parametrize("device_kind", ["host", "tensor"])
def test_table_api_matches_jax(device_kind):
    """from_dict, with_column, select, drop, rename and head, exactly."""
    port_cols, jax_cols = _columns(16, device_kind)
    port, ref = Table.from_dict(port_cols), JaxTable.from_dict(jax_cols)
    _same_table(port, ref)
    extra = np.arange(7.0)
    _same_table(port.with_column("e", extra), ref.with_column("e", extra))
    _same_table(port.with_column("f", extra), ref.with_column("f", extra))
    _same_table(port.select("w", "f"), ref.select("w", "f"))
    _same_table(port.drop("y"), ref.drop("y"))
    _same_table(port.drop("y", "missing"), ref.drop("y", "missing"))
    _same_table(port.rename({"f": "features", "nope": "x"}), ref.rename({"f": "features", "nope": "x"}))
    for k in (0, 3, 7, 20):
        _same_table(port.head(k), ref.head(k))
    with pytest.raises(KeyError):
        port.select("missing")
    with pytest.raises(KeyError):
        ref.select("missing")


@pytest.mark.parametrize("device_kind", ["host", "tensor"])
def test_select_drop_rename_share_the_columns(device_kind):
    port_cols, _ = _columns(17, device_kind)
    table = Table(port_cols)
    assert table.select("f").column("f") is table.column("f")
    assert table.drop("y").column("w") is table.column("w")
    assert table.rename({"f": "g"}).column("g") is table.column("f")
    head = table.head(4)
    assert isinstance(head.column("f"), type(table.column("f")))
    if device_kind == "tensor":
        assert head.column("f").device == table.column("f").device


def test_from_rows_matches_jax():
    rows = [(1.0, "a", DenseVector([1.0, 2.0])), (2.0, "b", DenseVector([3.0, 4.0]))]
    from flink_ml_tpu.linalg import DenseVector as JaxDenseVector

    jax_rows = [(a, b, JaxDenseVector(v.values)) for a, b, v in rows]
    port = Table.from_rows(rows, ["x", "s", "v"])
    ref = JaxTable.from_rows(jax_rows, ["x", "s", "v"])
    assert port.column_names == ref.column_names == ["x", "s", "v"]
    assert _rows(port) == _rows(ref)


def test_head_of_sparse_and_token_columns_matches_jax():
    indices, values = _sparse()
    tokens = np.array([["a", "b"], ["c", "d"], ["e", "f"], ["a", "c"], ["b", "b"], ["d", "e"],
                       ["f", "a"], ["c", "c"], ["e", "e"]])
    port = Table({"s": SparseBatch(12, indices, values), "t": tokens}).head(4)
    ref = JaxTable({"s": JaxSparseBatch(12, indices, values), "t": tokens}).head(4)
    np.testing.assert_array_equal(port.column("s").indices, ref.column("s").indices)
    np.testing.assert_array_equal(port.column("s").values, ref.column("s").values)
    np.testing.assert_array_equal(port.column("t"), ref.column("t"))


# -- A.16: the module-level as_sparse_batch, with and without size ------------

def _sparse_columns():
    rng = np.random.default_rng(488)
    dense = rng.standard_normal((5, 4))
    dense[dense < 0] = 0.0
    indices, values = _sparse()
    vectors = [Vectors.sparse(6, [1, 4], [1.0, 2.0]), DenseVector([0.0, 3.0, 0.0, 0.0, 0.0, 5.0])]
    return {"dense": dense, "vectors": vectors, "sparse_batch": (indices, values)}


@pytest.mark.parametrize("size", [None, 9])
@pytest.mark.parametrize("kind", ["dense", "vectors", "sparse_batch", "dense_tensor"])
def test_as_sparse_batch_matches_jax(kind, size):
    from flink_ml_tpu import linalg as jax_linalg
    from flink_ml_tpu.table import as_sparse_batch as jax_as_sparse_batch
    from flink_ml_tpu_torch.table import as_sparse_batch

    cols = _sparse_columns()
    if kind == "sparse_batch":
        port_col, ref_col = SparseBatch(12, *cols[kind]), JaxSparseBatch(12, *cols[kind])
    elif kind == "vectors":
        port_col = Table({"v": cols[kind]}).column("v")
        ref_col = JaxTable({"v": [jax_linalg.Vectors.sparse(6, [1, 4], [1.0, 2.0]),
                                  jax_linalg.DenseVector([0.0, 3.0, 0.0, 0.0, 0.0, 5.0])]}).column("v")
    elif kind == "dense_tensor":
        port_col, ref_col = torch.from_numpy(cols["dense"]), cols["dense"]
    else:
        port_col, ref_col = cols[kind], cols[kind]
    port, ref = as_sparse_batch(port_col, size), jax_as_sparse_batch(ref_col, size)
    assert port.size == ref.size
    np.testing.assert_array_equal(np.asarray(port.indices), np.asarray(ref.indices))
    np.testing.assert_array_equal(np.asarray(port.values), np.asarray(ref.values))
    if kind == "dense_tensor":
        assert isinstance(port.indices, torch.Tensor)


def test_lsh_takes_as_sparse_batch_from_table():
    from flink_ml_tpu_torch import table
    from flink_ml_tpu_torch.models.feature import lsh

    assert lsh.as_sparse_batch is table.as_sparse_batch


def test_host_readable_is_a_view_numpy_reads():
    """`HostReadable` (ROADMAP C.41): numpy reads it through a host copy,
    as it reads a jax.Array on any device; it shares the wrapped tensor's
    memory; an op on it gives a plain tensor; it deep-copies and pickles
    as itself."""
    import copy
    import pickle

    from flink_ml_tpu_torch.table import HostReadable, host_readable

    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    col = host_readable(base)
    assert type(col) is HostReadable and host_readable(col) is col
    assert col.data_ptr() == base.data_ptr()
    np.testing.assert_array_equal(np.asarray(col), base.numpy())
    assert np.asarray(col, np.float64).dtype == np.float64
    for derived in (col * 2, col[0], col.view(3, 2), col.sum(), torch.cat([col, col])):
        assert type(derived) is torch.Tensor
    for copied in (copy.deepcopy(col), pickle.loads(pickle.dumps(col))):
        assert type(copied) is HostReadable and torch.equal(copied, base)
    assert copy.deepcopy(col).data_ptr() != base.data_ptr()
    not_tensors = (np.zeros(3), SparseBatch(4, np.zeros((1, 1), np.int32), np.ones((1, 1))))
    assert all(host_readable(c) is c for c in not_tensors)
