"""The port's quantile machinery against the JAX package and numpy.

- `common/quantilesummary.py`, the port's copy of the Greenwald-Khanna
  sketch, gives the JAX package's summaries and answers on the cases of
  tests/test_quantile.py (equal: the same numpy code on the same data);
- `ops/quantile.py`: `jnp_quantile` equals `jnp.quantile` in float32 and
  `numpy_quantile` equals `np.quantile` in float64, bit for bit, at
  several row counts, with NaN columns, and above 2^24 rows, where
  `torch.quantile` refuses; `count_distinct` equals the distinct counts;
- `utils/datastream.py`: `sample` keeps the JAX package's rows for the
  same seed, and `Table.concat` joins host and tensor columns.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.common import quantilesummary as jax_qs
from flink_ml_tpu.utils import datastream as jax_ds
from flink_ml_tpu_torch import SparseBatch, StreamTable, Table, config
from flink_ml_tpu_torch.common import quantilesummary as port_qs
from flink_ml_tpu_torch.ops import quantile as port_q
from flink_ml_tpu_torch.utils import datastream as port_ds

PS = np.array([0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0])


def _both(eps, chunks, compress_threshold=None):
    """The same chunks through the JAX sketch and the port's."""
    out = []
    for module in (jax_qs, port_qs):
        kwargs = {} if compress_threshold is None else {"compress_threshold": compress_threshold}
        s = module.QuantileSummary(eps, **kwargs)
        for c in chunks:
            s.insert_batch(c)
        out.append(s.compress())
    return out


def _same_summary(a, b):
    assert a.count == b.count
    np.testing.assert_array_equal(a._values, b._values)
    np.testing.assert_array_equal(a._g, b._g)
    np.testing.assert_array_equal(a._delta, b._delta)


@pytest.mark.parametrize("eps,dist,n,parts", [
    (0.001, "normal", 200_000, 23),
    (0.01, "random", 500, 1),
    (0.005, "exponential", 120_000, 7),
    (0.05, "arange", 1000, 1),
    (0.01, "random", 600_000, 10),
    (1e-4, "random", 150_000, 3),
])
def test_sketch_matches_jax(eps, dist, n, parts):
    rng = np.random.default_rng(0)
    data = {"normal": lambda: rng.normal(size=n), "random": lambda: rng.random(n),
            "exponential": lambda: rng.exponential(size=n),
            "arange": lambda: np.arange(float(n))}[dist]()
    jax_s, port_s = _both(eps, np.array_split(data, parts))
    _same_summary(jax_s, port_s)
    np.testing.assert_array_equal(port_s.query(PS), jax_s.query(PS))
    sorted_d = np.sort(data)
    for p, v in zip(PS[1:-1], port_s.query(PS[1:-1])):
        rank = np.searchsorted(sorted_d, v, side="left")
        assert abs(rank - p * n) / n <= 2 * eps


def test_sketch_merge_matches_jax():
    rng = np.random.default_rng(2)
    data = rng.exponential(size=120_000)
    merged = []
    for module in (jax_qs, port_qs):
        parts = []
        for part in np.array_split(data, 7):
            s = module.QuantileSummary(0.005)
            s.insert_batch(part)
            parts.append(s.compress())
        m = parts[0]
        for s in parts[1:]:
            m = m.merge(s)
        merged.append(m)
    _same_summary(*merged)
    np.testing.assert_array_equal(merged[1].query(PS), merged[0].query(PS))
    empty = port_qs.QuantileSummary(0.01)
    assert empty.merge(merged[1]).query(0.5) == merged[1].query(0.5)


def test_sketch_single_inserts_and_errors():
    data = np.random.default_rng(1).random(500)
    a, b = port_qs.QuantileSummary(0.01), port_qs.QuantileSummary(0.01)
    for x in data:
        a.insert(float(x))
    b.insert_batch(data)
    assert a.compress().query(0.5) == b.compress().query(0.5)
    s = port_qs.QuantileSummary(0.01)
    with pytest.raises(ValueError):
        s.query(0.5)  # empty
    s.insert_batch(np.arange(10.0))
    with pytest.raises(ValueError):
        s.query(0.5)  # not compressed
    with pytest.raises(ValueError):
        s.merge(b)
    s.compress()
    with pytest.raises(ValueError):
        s.query(1.5)


def test_column_sketches_with_mask_match_jax():
    X = np.random.default_rng(3).random((5000, 3))
    X[::7, 1] = np.nan
    mask = ~np.isnan(X)
    out = []
    for module in (jax_qs, port_qs):
        sketches = module.column_sketches(3, 0.01)
        module.update_column_sketches(sketches, X, mask=mask)
        out.append([s.compress() for s in sketches])
    for a, b in zip(*out):
        _same_summary(a, b)
    assert out[1][1].count == mask[:, 1].sum()


# -- column quantiles ---------------------------------------------------------------

def _jnp_quantile(X, qs):
    return np.asarray(jax.jit(lambda a, q: jnp.quantile(a, q, axis=0))(
        jax.device_put(X), jnp.asarray(qs, X.dtype)))


@pytest.mark.parametrize("n", [1, 2, 3, 10, 999, 100_000])
@pytest.mark.parametrize("qs", [np.linspace(0, 1, 6), [0.5, 0.25, 0.75], [0.0, 1.0, 0.333]])
def test_jnp_quantile_equals_jax(n, qs):
    X = np.random.default_rng(n).random((n, 7)).astype(np.float32)
    X[:, 2] = 0.5  # constant
    X[:, 4] = np.round(X[:, 4] * 3)  # ties
    got = port_q.jnp_quantile(torch.from_numpy(X), qs).numpy()
    np.testing.assert_array_equal(got, _jnp_quantile(X, qs))


@pytest.mark.parametrize("n", [1, 2, 3, 10, 999, 100_000])
@pytest.mark.parametrize("qs", [np.linspace(0, 1, 6), [0.5, 0.25, 0.75], [0.0, 1.0, 0.333]])
def test_numpy_quantile_equals_numpy(n, qs):
    X = np.random.default_rng(n + 1).normal(size=(n, 5))
    X[:, 3] = np.round(X[:, 3])
    got = port_q.numpy_quantile(torch.from_numpy(X), qs).numpy()
    np.testing.assert_array_equal(got, np.quantile(X, qs, axis=0))


def test_quantile_of_a_column_with_nan_is_nan():
    X = np.random.default_rng(4).random((50, 3))
    X[7, 1] = np.nan
    qs = [0.5, 0.9]
    j = port_q.jnp_quantile(torch.from_numpy(X.astype(np.float32)), qs).numpy()
    np.testing.assert_array_equal(j, _jnp_quantile(X.astype(np.float32), qs))
    n = port_q.numpy_quantile(torch.from_numpy(X), qs).numpy()
    np.testing.assert_array_equal(n, np.quantile(X, qs, axis=0))
    assert np.isnan(j[:, 1]).all() and not np.isnan(j[:, [0, 2]]).any()


def test_quantile_above_2_24_rows():
    """torch.quantile refuses more than 2^24 elements along the reduced
    dimension; the port's column quantile does not, and equals jnp.quantile
    there (where float32 cannot hold n - 1 exactly)."""
    n = (1 << 24) + 1_000_003
    gen = torch.Generator().manual_seed(5)
    X = torch.rand((n, 1), generator=gen)
    qs = [0.5, 0.25, 0.75, 0.1]
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(X, torch.tensor(qs), dim=0)
    got = port_q.jnp_quantile(X, qs).numpy()
    np.testing.assert_array_equal(got, _jnp_quantile(X.numpy(), qs))


def test_sorted_rows_in_blocks_of_columns(monkeypatch):
    monkeypatch.setattr(port_q, "SORT_BLOCK_ELEMENTS", 3000)  # 3 columns a block
    X = np.random.default_rng(6).random((1000, 8))
    rows = [0, 10, 999, 500]
    got = port_q.sorted_rows(torch.from_numpy(X), rows).numpy()
    np.testing.assert_array_equal(got, np.sort(X, axis=0)[rows])
    np.testing.assert_array_equal(port_q.numpy_quantile(torch.from_numpy(X), PS).numpy(),
                                  np.quantile(X, PS, axis=0))


def test_count_distinct():
    rng = np.random.default_rng(7)
    X = rng.integers(0, 5, (300, 4)).astype(np.float64)
    X[:, 3] = rng.random(300)
    X[:3, 0] = np.nan
    got = port_q.count_distinct(torch.from_numpy(X), nan_equal=True).numpy()
    np.testing.assert_array_equal(got, [np.unique(X[:, j]).size for j in range(4)])
    assert port_q.count_distinct(torch.from_numpy(X)).numpy()[0] == got[0] + 2
    from flink_ml_tpu.models.feature import vectorindexer as jax_vi

    want = np.asarray(jax_vi._nunique_per_column(jax.device_put(X.astype(np.float32))))
    got32 = port_q.count_distinct(torch.from_numpy(X.astype(np.float32))).numpy()
    np.testing.assert_array_equal(got32, want)


# -- reservoir sample and Table.concat --------------------------------------------------

@pytest.mark.parametrize("k,parts", [(100, 13), (40, 1), (1000, 3), (5, 50)])
def test_sample_keeps_the_jax_rows(k, parts):
    X = np.random.default_rng(8).random((5000, 2))
    rows = np.arange(5000.0)
    splits = np.array_split(np.arange(5000), parts)
    jax_out = jax_ds.sample(JaxStreamTable.from_batches(
        [JaxTable({"x": X[s], "r": rows[s]}) for s in splits]), k, seed=7)
    port_out = port_ds.sample(StreamTable.from_batches(
        [Table({"x": X[s], "r": rows[s]}) for s in splits]), k, seed=7)
    assert port_out.num_rows == min(k, 5000)
    np.testing.assert_array_equal(port_out.column("r"), np.asarray(jax_out.column("r")))
    np.testing.assert_array_equal(port_out.column("x"), np.asarray(jax_out.column("x")))


def test_sample_of_tensor_batches_stays_on_their_device():
    X = torch.rand((300, 3), generator=torch.Generator().manual_seed(9))
    batches = [Table({"x": X[i:i + 50]}) for i in range(0, 300, 50)]
    out = port_ds.sample(StreamTable.from_batches(batches), 20, seed=1)
    assert isinstance(out.column("x"), torch.Tensor) and out.num_rows == 20
    host = port_ds.sample(StreamTable.from_batches(
        [Table({"x": X[i:i + 50].numpy()}) for i in range(0, 300, 50)]), 20, seed=1)
    np.testing.assert_array_equal(out.column("x").numpy(), host.column("x"))
    assert port_ds.sample(Table({"x": np.arange(5.0)}), 100).num_rows == 5
    with pytest.raises(ValueError):
        port_ds.sample(StreamTable.from_batches([]), 3)


def test_table_concat_device_in_device_out():
    with config.use_device("cpu"):
        a = Table({"x": torch.arange(3.0), "s": SparseBatch(
            5, np.array([[0, -1], [1, 2], [4, -1]], np.int32), np.ones((3, 2)))})
        b = Table({"x": np.arange(3.0, 5.0), "s": SparseBatch(
            5, np.array([[3, 2, 1], [0, -1, -1]], np.int32), np.ones((2, 3)))})
        out = a.concat(b)
    assert isinstance(out.column("x"), torch.Tensor)
    np.testing.assert_array_equal(out.column("x").numpy(), np.arange(5.0))
    s = out.column("s")
    assert s.indices.shape == (5, 3) and s.indices[0, 2] == -1
    np.testing.assert_array_equal(s.to_dense(), np.vstack([a.column("s").to_dense(),
                                                           b.column("s").to_dense()]))
    host = Table({"x": np.arange(2.0)}).concat(Table({"x": np.arange(2.0)}))
    assert isinstance(host.column("x"), np.ndarray)
