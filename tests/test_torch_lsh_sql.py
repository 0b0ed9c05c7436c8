"""JavaRandom, MinHashLSH and SQLTransformer of the port against the JAX
package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor). Every
comparison is exact:

- JavaRandom: the draws of next_int (bounded and not), next_long and
  next_double for seeds 0, -1, 2022 and 2^40;
- MinHashLSH: coefficients, hashes (the port's int64 torch against the
  JAX package's int64 numpy), nearest neighbours and similarity-join rows
  and distances, on SparseBatch (host and tensor), dense and vector
  columns; the empty-row and dimension errors; save/load both ways;
- SQLTransformer: each statement of the JAX package's own SQL tests
  (tests/test_feature_transformers.py, tests/test_feature_estimators.py),
  on host columns and on tensors, both paths (columnwise and sqlite).
"""

import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.linalg import Vectors as JaxVectors
from flink_ml_tpu.models.feature import lsh as jax_lsh
from flink_ml_tpu.models.feature import sqltransformer as jax_sql
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
from flink_ml_tpu.utils.javarandom import JavaRandom as JaxJavaRandom
from flink_ml_tpu_torch import SparseBatch, Table, Vectors, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.feature import lsh as port_lsh
from flink_ml_tpu_torch.models.feature import sqltransformer as port_sql
from flink_ml_tpu_torch.utils.javarandom import JavaRandom


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _host(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


# -- JavaRandom -----------------------------------------------------------------------

SEEDS = [0, -1, 2022, 2**40]


def _draws(rng):
    out = [rng.next_int() for _ in range(5)]
    out += [rng.next_int(b) for b in (1, 7, 16, 100, 2**30, 2038074742) for _ in range(3)]
    out += [rng.next_long() for _ in range(3)]
    out += [rng.next_double() for _ in range(3)]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_java_random_draws_equal_jax(seed):
    assert _draws(JavaRandom(seed)) == _draws(JaxJavaRandom(seed))


def test_java_random_golden_values():
    r = JavaRandom(0)
    assert r.next_int() == -1155484576  # new Random(0).nextInt()
    assert JavaRandom(0).next_long() == -4962768465676381896
    with pytest.raises(ValueError):
        JavaRandom(1).next_int(0)


# -- MinHashLSH -----------------------------------------------------------------------

DIM = 40


def _lsh_rows(n=300, k=6, seed=0):
    """Padded rows of distinct sorted indices (every row has one), values
    that include stored zeros, and a few near-duplicate rows."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.permuted(np.tile(np.arange(DIM), (n, 1)), axis=1)[:, :k], axis=1)
    idx = idx.astype(np.int32)
    drop = rng.random((n, k)) < 0.25
    drop[:, 0] = False
    idx = np.where(drop, -1, idx)
    vals = rng.random((n, k))
    vals[rng.random((n, k)) < 0.1] = 0.0
    idx[n // 2: n // 2 + 10] = idx[:10]
    return idx, vals


def _lsh_tables(layout, device=False, seed=0):
    idx, vals = _lsh_rows(seed=seed)
    n = idx.shape[0]
    ids = np.arange(n, dtype=np.int64)
    if layout == "sparse":
        jcol = JaxSparseBatch(DIM, idx, vals)
        pcol = (SparseBatch(DIM, torch.from_numpy(idx.copy()), torch.from_numpy(vals.copy()))
                if device else SparseBatch(DIM, idx.copy(), vals.copy()))
    elif layout == "dense":
        dense = np.zeros((n, DIM))
        rows, cols = np.nonzero(idx >= 0)
        dense[rows, idx[rows, cols]] = vals[rows, cols] + 1.0
        jcol = dense
        pcol = torch.from_numpy(dense.copy()) if device else dense.copy()
    else:  # an object column of vectors (DenseVector.to_sparse drops zeros)
        jcol = np.empty(n, dtype=object)
        pcol = np.empty(n, dtype=object)
        for i in range(n):
            keep = idx[i] >= 0
            jcol[i] = JaxVectors.sparse(DIM, idx[i][keep], vals[i][keep] + 1.0)
            pcol[i] = Vectors.sparse(DIM, idx[i][keep], vals[i][keep] + 1.0)
    return JaxTable({"vec": jcol, "id": ids}), Table({"vec": pcol, "id": ids.copy()})


def _lsh_estimators(tables=5, functions=3, seed=2022):
    return [m.MinHashLSH().set_input_col("vec").set_output_col("hashes").set_seed(seed)
            .set_num_hash_tables(tables).set_num_hash_functions_per_table(functions)
            for m in (jax_lsh, port_lsh)]


LSH_LAYOUTS = [("sparse", False), ("sparse", True), ("dense", False), ("dense", True),
               ("vectors", False)]


def _layout_id(case):
    layout, device = case
    return f"{layout}-{'device' if device else 'numpy'}"


@pytest.mark.parametrize("case", LSH_LAYOUTS, ids=_layout_id)
@pytest.mark.parametrize("shape", [(5, 3), (1, 1), (3, 7)])
def test_minhash_coefficients_and_hashes_equal_jax(shape, case):
    jax_table, port_table = _lsh_tables(*case)
    jax_est, port_est = _lsh_estimators(*shape)
    jax_model, port_model = jax_est.fit(jax_table), port_est.fit(port_table)
    np.testing.assert_array_equal(port_model.rand_coefficient_a, jax_model.rand_coefficient_a)
    np.testing.assert_array_equal(port_model.rand_coefficient_b, jax_model.rand_coefficient_b)
    assert port_model.rand_coefficient_a.dtype == np.int64
    want = jax_model.transform(jax_table)[0].column("hashes")
    got = port_model.transform(port_table)[0].column("hashes")
    assert got.dtype == object and len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == shape[0]
        for a, b in zip(g, w):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)


def test_min_hash_chunks_equal_one_pass(monkeypatch):
    idx, _ = _lsh_rows()
    a, b = port_lsh.draw_coefficients(7, 6)
    whole = port_lsh.min_hash(idx, a, b)
    monkeypatch.setattr(port_lsh, "HASH_CHUNK_BYTES", 8 * idx.shape[1] * 6 * 7)  # 7 rows a chunk
    assert torch.equal(port_lsh.min_hash(idx, a, b), whole)
    np.testing.assert_array_equal(whole.numpy().astype(np.float64), jax_lsh._min_hash(idx, a, b))


def test_minhash_reference_golden_hashes():
    """MinHashLSHTest.java:61-83 (seed 2022, 5 tables x 3 functions)."""
    expected = [
        [[1.73046954e8, 1.57275425e8, 6.90717571e8], [5.02301169e8, 7.967141e8, 4.06089319e8],
         [2.83652171e8, 1.97714719e8, 6.04731316e8], [5.2181506e8, 6.36933726e8, 6.13894128e8],
         [3.04301769e8, 1.113672955e9, 6.1388711e8]],
        [[1.73046954e8, 1.57275425e8, 6.7798584e7], [6.38582806e8, 1.78703694e8, 4.06089319e8],
         [6.232638e8, 9.28867e7, 9.92010642e8], [2.461064e8, 1.12787481e8, 1.92180297e8],
         [2.38162496e8, 1.552933319e9, 2.77995137e8]],
        [[1.73046954e8, 1.57275425e8, 6.90717571e8], [1.453197722e9, 7.967141e8, 4.06089319e8],
         [6.232638e8, 1.97714719e8, 6.04731316e8], [2.461064e8, 1.12787481e8, 1.92180297e8],
         [1.224130231e9, 1.113672955e9, 2.77995137e8]],
    ]
    table = Table({"id": [0, 1, 2], "vec": [Vectors.sparse(6, [0, 1, 2], [1.0] * 3),
                                            Vectors.sparse(6, [2, 3, 4], [1.0] * 3),
                                            Vectors.sparse(6, [0, 2, 4], [1.0] * 3)]})
    _, est = _lsh_estimators()
    out = est.fit(table).transform(table)[0]
    got = sorted(tuple(map(tuple, np.asarray(h))) for h in out.column("hashes"))
    assert got == sorted(tuple(map(tuple, e)) for e in expected)


KEYS = [("sparse", [1, 3, 5, 7]), ("sparse", [0]), ("dense", None), ("row", 4)]


@pytest.mark.parametrize("case", LSH_LAYOUTS, ids=_layout_id)
@pytest.mark.parametrize("key_kind", range(len(KEYS)))
@pytest.mark.parametrize("k", [1, 5, 50])
def test_nearest_neighbors_equal_jax(k, key_kind, case):
    jax_table, port_table = _lsh_tables(*case)
    jax_est, port_est = _lsh_estimators(5, 1)
    jax_model, port_model = jax_est.fit(jax_table), port_est.fit(port_table)
    kind, spec = KEYS[key_kind]
    if kind == "sparse":
        jkey, pkey = JaxVectors.sparse(DIM, spec, [1.0] * len(spec)), Vectors.sparse(
            DIM, spec, [1.0] * len(spec))
    elif kind == "dense":
        v = np.zeros(DIM)
        v[[2, 9, 11, 30]] = 1.0
        jkey, pkey = JaxVectors.dense(v), Vectors.dense(v)
    else:  # a row of the data itself, which has near-duplicates
        idx, _ = _lsh_rows()
        keep = idx[spec][idx[spec] >= 0]
        jkey, pkey = JaxVectors.sparse(DIM, keep, [1.0] * keep.size), Vectors.sparse(
            DIM, keep, [1.0] * keep.size)
    want = jax_model.approx_nearest_neighbors(jax_table, jkey, k)
    got = port_model.approx_nearest_neighbors(port_table, pkey, k)
    assert got.num_rows == want.num_rows
    np.testing.assert_array_equal(_host(got.column("id")), np.asarray(want.column("id")))
    np.testing.assert_array_equal(_host(got.column("distCol")), np.asarray(want.column("distCol")))
    if kind == "row" and case[0] != "dense":  # a dense row holds every index
        assert got.num_rows >= 1 and _host(got.column("distCol"))[0] == 0.0


@pytest.mark.parametrize("case", [("sparse", False), ("sparse", True), ("dense", False)],
                         ids=_layout_id)
@pytest.mark.parametrize("threshold", [0.0, 0.6, 1.0])
def test_similarity_join_equals_jax(threshold, case):
    jax_a, port_a = _lsh_tables(*case)
    jax_b, port_b = _lsh_tables(*case, seed=1)
    jax_est, port_est = _lsh_estimators(3, 2)
    jax_model, port_model = jax_est.fit(jax_a), port_est.fit(port_a)
    want = jax_model.approx_similarity_join(jax_a, jax_b, threshold, "id")
    got = port_model.approx_similarity_join(port_a, port_b, threshold, "id")
    assert got.column_names == want.column_names == ["idA", "idB", "distCol"]
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        np.testing.assert_array_equal(_host(got.column(name)), np.asarray(want.column(name)))


def test_an_empty_row_raises_as_in_jax():
    idx = np.asarray([[0, 1], [-1, -1]], np.int32)
    vals = np.ones((2, 2))
    jax_model = _lsh_estimators()[0].fit(JaxTable({"vec": JaxSparseBatch(4, idx, vals)}))
    port_model = _lsh_estimators()[1].fit(Table({"vec": SparseBatch(4, idx, vals)}))
    with pytest.raises(ValueError, match="Must have at least 1 non zero entry."):
        jax_model.transform(JaxTable({"vec": JaxSparseBatch(4, idx, vals)}))
    for col in (SparseBatch(4, idx, vals), SparseBatch(4, torch.from_numpy(idx), torch.ones(2, 2))):
        with pytest.raises(ValueError, match="Must have at least 1 non zero entry."):
            port_model.transform(Table({"vec": col}))


def test_a_stored_zero_still_hashes():
    """Only the indices count: a row whose only entry is a stored 0.0 hashes."""
    idx = np.asarray([[3, -1]], np.int32)
    vals = np.zeros((1, 2))
    jax_est, port_est = _lsh_estimators()
    want = jax_est.fit(JaxTable({"vec": JaxSparseBatch(8, idx, vals)})).transform(
        JaxTable({"vec": JaxSparseBatch(8, idx, vals)}))[0].column("hashes")
    got = port_est.fit(Table({"vec": SparseBatch(8, idx, vals)})).transform(
        Table({"vec": SparseBatch(8, idx, vals)}))[0].column("hashes")
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_a_dimension_above_the_prime_raises_as_in_jax():
    big = port_lsh.HASH_PRIME + 1
    idx, vals = np.asarray([[0]], np.int32), np.ones((1, 1))
    with pytest.raises(ValueError, match="exceeds the threshold") as jax_err:
        _lsh_estimators()[0].fit(JaxTable({"vec": JaxSparseBatch(big, idx, vals)}))
    with pytest.raises(ValueError, match="exceeds the threshold") as port_err:
        _lsh_estimators()[1].fit(Table({"vec": SparseBatch(big, idx, vals)}))
    assert str(port_err.value) == str(jax_err.value)


def test_model_data_round_trip():
    _, port_est = _lsh_estimators()
    jax_table, port_table = _lsh_tables("sparse")
    model = port_est.fit(port_table)
    twin = port_lsh.MinHashLSHModel().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(twin.rand_coefficient_a, model.rand_coefficient_a)
    jax_twin = jax_lsh.MinHashLSHModel().set_model_data(
        JaxTable({"randCoefficientA": [model.rand_coefficient_a.tolist()],
                  "randCoefficientB": [model.rand_coefficient_b.tolist()]}))
    np.testing.assert_array_equal(jax_twin.rand_coefficient_b, model.rand_coefficient_b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_minhash_save_load_both_ways(direction, tmp_path):
    jax_table, port_table = _lsh_tables("sparse")
    jax_est, port_est = _lsh_estimators()
    path = str(tmp_path / "lsh")
    if direction == "jax_to_port":
        jax_model = jax_est.fit(jax_table)
        jax_model.save(path)
        port_model = Stage.load(path)
        assert isinstance(port_model, port_lsh.MinHashLSHModel)
    else:
        port_model = port_est.fit(port_table)
        port_model.save(path)
        jax_model = jax_lsh.MinHashLSHModel.load(path)
    assert port_model.get_num_hash_tables() == 5
    assert jax_model.get_num_hash_functions_per_table() == 3
    want = jax_model.transform(jax_table)[0].column("hashes")
    got = port_model.transform(port_table)[0].column("hashes")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # the estimator's params too
    port_est.save(str(tmp_path / "est"))
    assert jax_lsh.MinHashLSH.load(str(tmp_path / "est")).get_seed() == 2022


def test_a_reference_format_directory_raises_naming_a15(tmp_path):
    port_model = _lsh_estimators()[1].fit(_lsh_tables("sparse")[1])
    path = tmp_path / "lsh"
    port_model.save(str(path))
    os.remove(path / "data" / "model_data.npz")
    (path / "data" / "part-0").write_bytes(b"\x00")
    # the reference's binary model data is read now (A.15): a part cut short is corrupt
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        Stage.load(str(path))
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        jax_lsh.MinHashLSHModel.load(str(path))


# -- SQLTransformer -------------------------------------------------------------------


def _sql_tables(cols, device):
    port_cols = {k: (torch.from_numpy(np.array(v)) if device and np.asarray(v).dtype.kind in "fiu"
                     else np.array(v)) for k, v in cols.items()}
    return JaxTable({k: np.array(v) for k, v in cols.items()}), Table(port_cols)


#: (statement, columns): the statements of the JAX package's SQL tests
#: (tests/test_feature_transformers.py:443-680 and test_feature_estimators.py
#: TestSQLTransformer), on their tables
SQL_CASES = {
    "star_plus_expression": ("SELECT *, ABS(v1) AS a, v1 + 2 * v2 AS b FROM __THIS__",
                             {"v1": [-1.0, 2.0, -3.0], "v2": [4.0, 5.0, 6.0]}),
    "vector_column_expression": ("SELECT ABS(vec) * 2 AS scaled FROM __THIS__",
                                 {"vec": [[1.0, -2.0], [3.0, -4.0]]}),
    "where_scalar_filter": ("SELECT v1 FROM __THIS__ WHERE v1 > 0",
                            {"v1": [-1.0, 2.0, -3.0], "v2": [4.0, 5.0, 6.0]}),
    "where_keeps_vector_columns": (
        "SELECT vec * 2 AS scaled, score FROM __THIS__ WHERE score >= 0.5",
        {"vec": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], "score": [0.1, 0.9, 0.5]}),
    "where_boolean_combinators": (
        "SELECT v1, v2 FROM __THIS__ WHERE (v1 > 0 AND v2 < 6) OR NOT v2 >= 5",
        {"v1": [-1.0, 2.0, -3.0], "v2": [4.0, 5.0, 6.0]}),
    "where_over_vector_column": ("SELECT vec FROM __THIS__ WHERE vec > 0",
                                 {"vec": [[1.0, -2.0], [3.0, 4.0]]}),
    "string_column_expression": ("SELECT v + 1 AS w FROM __THIS__",
                                 {"name": ["a", "b"], "v": [1.0, 2.0]}),
    "string_column_sqlite": ("SELECT name, v FROM __THIS__", {"name": ["a", "b"], "v": [1.0, 2.0]}),
    "division_by_zero_sqlite": ("SELECT v1, 1/0 AS x FROM __THIS__", {"v1": [1.0, 2.0]}),
    "select_sum": ("SELECT *, (v1 + v2) AS v3 FROM __THIS__",
                   {"id": [1, 2], "v1": [1.0, 2.0], "v2": [3.0, 4.0]}),
    "group_by": ("SELECT g, SUM(v) AS s FROM __THIS__ GROUP BY g", {"g": [1, 1, 2], "v": [1.0, 3.0, 10.0]}),
    "integer_division_sqlite": ("SELECT g, g / 2 AS h FROM __THIS__", {"g": [1, 4, 7], "v": [1.0, 2.0, 3.0]}),
    "star_with_vector_sqlite": ("SELECT * FROM __THIS__ WHERE g > 1",
                                {"g": [1, 2, 3], "vec": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]}),
    "constant": ("SELECT v, 2.5 AS c, EXP(v) AS e, LN(v) AS l, SQRT(v) AS s FROM __THIS__",
                 {"v": [1.0, 4.0, -1.0]}),
    "distinct": ("SELECT DISTINCT g FROM __THIS__", {"g": [1, 2, 2, 3], "v": [1.0, 2.0, 3.0, 4.0]}),
}
NAN_TABLE = {"x": [1.0, np.nan, 5.0, np.nan, 7.0], "y": [0.0, 1.0, np.nan, 2.0, 3.0],
             "vec": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0], [9.0, 10.0]]}
for _i, _stmt in enumerate(("SELECT x FROM __THIS__ WHERE x != 5",
                            "SELECT x FROM __THIS__ WHERE NOT x > 2",
                            "SELECT x, vec FROM __THIS__ WHERE x > 0 OR y > 0",
                            "SELECT x FROM __THIS__ WHERE NOT (x > 2 AND y < 1)",
                            "SELECT x, y FROM __THIS__ WHERE (x + 1) > 2 AND y = y")):
    SQL_CASES[f"where_nan_{_i}"] = (_stmt, NAN_TABLE)


def _same_sql_output(got, want):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = _host(got.column(name)), np.asarray(want.column(name))
        if w.dtype == object or g.dtype == object:
            assert [None if v is None else v for v in g.tolist()] == w.tolist(), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("device", [False, True], ids=["numpy", "device"])
@pytest.mark.parametrize("case", sorted(SQL_CASES))
def test_sql_statements_equal_jax(case, device):
    statement, cols = SQL_CASES[case]
    jax_table, port_table = _sql_tables(cols, device)
    try:
        want = jax_sql.SQLTransformer().set_statement(statement).transform(jax_table)[0]
    except ValueError as err:  # neither path can take it: the port refuses it alike
        with pytest.raises(ValueError, match=str(err)):
            port_sql.SQLTransformer().set_statement(statement).transform(port_table)
        want = None
    if want is not None:
        got = port_sql.SQLTransformer().set_statement(statement).transform(port_table)[0]
        _same_sql_output(got, want)
    fast = port_sql._try_vectorized_projection(statement, port_table)
    assert (fast is None) == (jax_sql._try_vectorized_projection(statement, jax_table) is None)
    if fast is not None and device:  # the columnwise path keeps tensors on their device
        for name in fast.column_names:
            if isinstance(port_table.column(name) if name in port_table else None, torch.Tensor):
                assert isinstance(fast.column(name), torch.Tensor), name


@pytest.mark.parametrize("case", ["star_plus_expression", "where_boolean_combinators",
                                  "where_nan_0", "where_nan_1", "where_nan_3", "where_nan_4"])
def test_columnwise_path_equals_the_sqlite_path(case, monkeypatch):
    statement, cols = SQL_CASES[case]
    _, port_table = _sql_tables(cols, True)
    fast = port_sql.SQLTransformer().set_statement(statement).transform(port_table)[0]
    monkeypatch.setattr(port_sql, "_try_vectorized_projection", lambda *_: None)
    slow = port_sql.SQLTransformer().set_statement(statement).transform(port_table)[0]
    for name in slow.column_names:
        np.testing.assert_allclose(_host(fast.column(name)).astype(np.float64),
                                   np.asarray(slow.column(name), np.float64), err_msg=name)


def test_a_constant_takes_the_tables_device_and_dtype():
    table = Table({"v": torch.tensor([1.0, 2.0], dtype=torch.float32)})
    out = port_sql.SQLTransformer().set_statement("SELECT *, 3 AS c FROM __THIS__").transform(table)[0]
    assert out.column("c").dtype == torch.float32 and torch.equal(out.column("c"),
                                                                  torch.full((2,), 3.0))
    host = Table({"v": np.asarray([1.0, 2.0])})
    out = port_sql.SQLTransformer().set_statement("SELECT *, 3 AS c FROM __THIS__").transform(host)[0]
    assert isinstance(out.column("c"), np.ndarray) and out.column("c").dtype == np.float64


def test_statement_must_name_this(tmp_path):
    with pytest.raises(ValueError):
        port_sql.SQLTransformer().set_statement("SELECT 1")
    with pytest.raises(ValueError, match="must be set"):
        port_sql.SQLTransformer().transform(Table({"v": [1.0]}))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sql_save_load_both_ways(direction, tmp_path):
    statement = "SELECT *, ABS(v1) AS v2 FROM __THIS__"
    path = str(tmp_path / "sql")
    if direction == "jax_to_port":
        jax_sql.SQLTransformer().set_statement(statement).save(path)
        stage = Stage.load(path)
        assert isinstance(stage, port_sql.SQLTransformer)
        assert stage.get_statement() == statement
    else:
        port_sql.SQLTransformer().set_statement(statement).save(path)
        assert jax_sql.SQLTransformer.load(path).get_statement() == statement


def test_a_token_column_passes_through_the_sqlite_path():
    """ROADMAP C.14: the JAX package's sqlite path takes `np.asarray` of a
    DictTokenMatrix column for a scalar column and fails on it; the port
    treats a token column as non-scalar and passes it through a star
    select by row identity, as it does a vector column."""
    from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
    from flink_ml_tpu_torch.table import DictTokenMatrix

    vocab, ids = np.asarray(["a", "b"]), np.asarray([[0, 1], [1, -1], [0, 0]], np.int32)
    statement = "SELECT * FROM __THIS__ WHERE g > 1"
    with pytest.raises(TypeError):
        jax_sql.SQLTransformer().set_statement(statement).transform(
            JaxTable({"g": np.array([1, 1, 2]), "tok": JaxDictTokenMatrix(vocab, ids)}))
    for held in (ids, torch.from_numpy(ids)):
        out = port_sql.SQLTransformer().set_statement(statement).transform(
            Table({"g": np.array([1, 1, 2]), "tok": DictTokenMatrix(vocab, held)}))[0]
        assert out.collect() == [{"g": 2, "tok": ["a", "a"]}]


def test_a_dense_row_counts_its_zero_entries_as_in_jax():
    """ROADMAP C.13: a dense column's rows hash every index 0..d-1, zeros
    included (the JAX package's `as_sparse_batch`), while the key goes
    through `to_sparse`, which drops them; so a dense row equal to the key
    is at distance 1/3 here, not 0. The port keeps the JAX package's rule."""
    X = np.array([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]])
    jax_est, port_est = [e.set_num_hash_tables(1).set_num_hash_functions_per_table(1)
                         for e in _lsh_estimators()]
    jax_table, port_table = JaxTable({"vec": X, "id": [0, 1]}), Table({"vec": X.copy(), "id": [0, 1]})
    want = jax_est.fit(jax_table).approx_nearest_neighbors(jax_table, JaxVectors.dense(X[0]), 2)
    got = port_est.fit(port_table).approx_nearest_neighbors(port_table, Vectors.dense(X[0]), 2)
    np.testing.assert_array_equal(_host(got.column("distCol")), np.asarray(want.column("distCol")))
    np.testing.assert_array_equal(_host(got.column("distCol")), [1 - 2 / 3] * 2)
