"""Out-of-core stream fits in flink_ml_tpu_torch against the JAX package.

The same seeded chunks go through both packages as a StreamTable; the JAX
side on a one-device mesh, the port on the CPU. Held to:

- LogisticRegression, LinearSVC and LinearRegression stream fits against
  the JAX package's stream fits, allclose (rtol 1e-4, atol 1e-6, the
  linear models' tolerance), and against the port's own bounded fit of the
  concatenated rows bit for bit (same batches, same epoch arithmetic);
- a fit whose data cache spills to disk bit for bit against the same fit
  held in memory;
- KMeans stream fits against the JAX package's stream fits (rtol 1e-5,
  atol 1e-5, counts equal), from the bounded fit's init rows.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import linearsvc as jax_svc
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.models.regression import linearregression as jax_linreg
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import StreamTable, Table, config
from flink_ml_tpu_torch.models import _linear
from flink_ml_tpu_torch.models.classification import linearsvc as port_svc
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.clustering import kmeans as port_kmeans
from flink_ml_tpu_torch.models.regression import linearregression as port_linreg
from flink_ml_tpu_torch.ops import losses
from flink_ml_tpu_torch.ops.optimizer import SGD

LINEAR_TOL = dict(rtol=1e-4, atol=1e-6)
KMEANS_TOL = dict(rtol=1e-5, atol=1e-5)
# name -> (JAX module, port module, estimator class)
MODELS = {
    "lr": (jax_lr, port_lr, "LogisticRegression"),
    "svc": (jax_svc, port_svc, "LinearSVC"),
    "linreg": (jax_linreg, port_linreg, "LinearRegression"),
}


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _data(kind, seed=0, n=530, d=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    dots = X @ rng.standard_normal(d)
    y = dots + 0.1 * rng.standard_normal(n) if kind == "linreg" else (dots > 0).astype(np.float64)
    return X, y, rng.random(n) + 0.5


def _chunks(X, y, w, rows, table_cls):
    """Tables of `rows` rows (the last shorter), with a weight column if w."""
    out = []
    for i in range(0, X.shape[0], rows):
        cols = {"features": X[i:i + rows], "label": y[i:i + rows]}
        if w is not None:
            cols["weight"] = w[i:i + rows]
        out.append(table_cls(cols))
    return out


def _estimator(module, cls, weighted, max_iter=15, batch=100):
    est = getattr(module, cls)().set_max_iter(max_iter).set_global_batch_size(batch)
    return est.set_weight_col("weight") if weighted else est


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_stream_fit_matches_jax_stream_fit(both_on_one_device, name, weighted):
    jax_module, port_module, cls = MODELS[name]
    X, y, w = _data(name)
    w = w if weighted else None
    # 96-row chunks against 100-row batches: the remainder carries over
    want = _estimator(jax_module, cls, weighted).fit(
        JaxStreamTable.from_batches(_chunks(X, y, w, 96, JaxTable))).coefficient
    got = _estimator(port_module, cls, weighted).fit(
        StreamTable.from_batches(_chunks(X, y, w, 96, Table))).coefficient
    np.testing.assert_allclose(got, np.asarray(want), **LINEAR_TOL)


@pytest.mark.parametrize("chunk", [33, 100, 530])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_stream_fit_equals_bounded_fit_bit_for_bit(both_on_one_device, name, chunk):
    _, port_module, cls = MODELS[name]
    X, y, w = _data(name, seed=1)
    bounded = _estimator(port_module, cls, True).fit(Table({"features": X, "label": y, "weight": w}))
    stream = _estimator(port_module, cls, True).fit(
        StreamTable.from_batches(_chunks(X, y, w, chunk, Table)))
    np.testing.assert_array_equal(stream.coefficient, bounded.coefficient)


def _optimize_stream(X, y, w, budget, tmp_path, tol=1e-6, batch=64):
    sgd = SGD(max_iter=25, learning_rate=0.1, global_batch_size=batch, tol=tol)
    chunks = ((X[i:i + 50], y[i:i + 50], w[i:i + 50]) for i in range(0, X.shape[0], 50))
    return sgd.optimize_stream(None, chunks, losses.BINARY_LOGISTIC_LOSS,
                               memory_budget_bytes=budget, spill_dir=str(tmp_path))


def test_spilled_fit_equals_in_memory_fit(both_on_one_device, tmp_path):
    """20 segments of 256 x (100 + 2) float32, 104 KB each, against a 1 MiB
    budget: the eleventh and later spill to the file."""
    X, y, w = _data("lr", seed=2, n=5000, d=100)
    c_mem, loss_mem, ep_mem, stats_mem = _optimize_stream(X, y, w, 64 << 20, tmp_path, batch=256)
    c_disk, loss_disk, ep_disk, stats_disk = _optimize_stream(X, y, w, 1 << 20, tmp_path, batch=256)
    assert stats_mem["spilledSegments"] == 0
    assert stats_disk["spilledSegments"] == 10
    assert stats_mem["numSegments"] == stats_disk["numSegments"] == 20  # 5000 rows / 256
    np.testing.assert_array_equal(c_disk, c_mem)
    assert (loss_disk, ep_disk) == (loss_mem, ep_mem)
    assert list(tmp_path.iterdir()) == []  # the spill file is removed


def test_stream_fit_keeps_the_tol_stop(both_on_one_device, tmp_path):
    """A tol that the criteria reach stops the stream fit where the bounded
    fit stops."""
    X, y, w = _data("lr", seed=3, n=256)
    X = X * 40.0  # separable and steep: the loss falls fast
    coeff, loss, epochs, _ = _optimize_stream(X, y, w, 64 << 20, tmp_path, tol=0.05)
    sgd = SGD(max_iter=25, learning_rate=0.1, global_batch_size=64, tol=0.05)
    b_coeff, b_loss, b_epochs = sgd.optimize(np.zeros(X.shape[1]), X, y, w, losses.BINARY_LOGISTIC_LOSS)
    assert epochs == b_epochs < 25
    assert loss == b_loss <= 0.05
    np.testing.assert_array_equal(coeff, b_coeff)


def test_stream_labels_are_validated_per_chunk(both_on_one_device):
    X, y, _ = _data("lr")
    y = y.copy()
    y[400] = 2.0
    with pytest.raises(ValueError, match="Multinomial"):
        port_lr.LogisticRegression().fit(StreamTable.from_batches(_chunks(X, y, None, 96, Table)))


def test_empty_stream_raises(both_on_one_device):
    with pytest.raises(ValueError, match="empty stream"):
        port_lr.LogisticRegression().fit(StreamTable([]))


def test_stream_of_tensor_and_sparse_chunks(both_on_one_device):
    """Tensor columns come to the host, a SparseBatch is densified: the fit
    equals the one on dense host chunks."""
    from flink_ml_tpu_torch import SparseBatch

    X, y, w = _data("lr", seed=4, n=200)
    dense = _estimator(port_lr, "LogisticRegression", False).fit(
        StreamTable.from_batches(_chunks(X, y, None, 64, Table))).coefficient
    idx = np.tile(np.arange(X.shape[1], dtype=np.int32), (X.shape[0], 1))
    mixed = [
        Table({"features": torch.from_numpy(X[:64]), "label": torch.from_numpy(y[:64])}),
        Table({"features": SparseBatch(X.shape[1], idx[64:], X[64:]), "label": y[64:]}),
    ]
    got = _estimator(port_lr, "LogisticRegression", False).fit(StreamTable.from_batches(mixed))
    np.testing.assert_array_equal(got.coefficient, dense)


def _blobs(seed=0, n=600, d=5, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 6
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("chunk", [70, 600])
@pytest.mark.parametrize("measure", ["euclidean", "manhattan", "cosine"])
def test_kmeans_stream_fit_matches_jax_stream_fit(both_on_one_device, measure, chunk):
    X = _blobs()

    def est(module):
        return (module.KMeans().set_k(4).set_max_iter(6).set_seed(5)
                .set_distance_measure(measure))

    want = est(jax_kmeans).fit(JaxStreamTable.from_batches(
        [JaxTable({"features": X[i:i + chunk]}) for i in range(0, 600, chunk)]))
    got = est(port_kmeans).fit(StreamTable.from_batches(
        [Table({"features": X[i:i + chunk]}) for i in range(0, 600, chunk)]))
    np.testing.assert_allclose(got.centroids, want.centroids, **KMEANS_TOL)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.cache_stats["numSegments"] == -(-600 // chunk)


@pytest.mark.parametrize("max_iter", [1, 4])
def test_kmeans_stream_fit_follows_the_bounded_fit(both_on_one_device, max_iter):
    """The stream fit starts from the bounded fit's init rows and makes its
    epochs: the same counts, centroids equal up to the order of the sums."""
    X = _blobs(seed=1)
    est = lambda: port_kmeans.KMeans().set_k(4).set_max_iter(max_iter).set_seed(9)  # noqa: E731
    stream = est().fit(StreamTable.from_batches([Table({"features": X[i:i + 50]})
                                                 for i in range(0, 600, 50)]))
    bounded = est().fit(Table({"features": X}))
    np.testing.assert_allclose(stream.centroids, bounded.centroids, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(stream.weights, bounded.weights)


def test_kmeans_stream_needs_k_points(both_on_one_device):
    with pytest.raises(ValueError, match="less than k"):
        port_kmeans.KMeans().set_k(5).fit(StreamTable.from_batches(
            [Table({"features": np.zeros((2, 3))}), Table({"features": np.ones((2, 3))})]))


def test_sample_without_replacement_matches_jax():
    for n, k in ((100, 7), (20_000_000, 5)):
        got = port_kmeans._sample_without_replacement(np.random.RandomState(4), n, k)
        want = jax_kmeans._sample_without_replacement(np.random.RandomState(4), n, k)
        np.testing.assert_array_equal(got, want)


def test_stream_chunks_come_to_the_host_as_float():
    batch = Table({"features": torch.ones((3, 2)), "label": torch.tensor([0, 1, 1])})
    (X, y, w), = _linear._stream_chunks([batch], "features", "label", None, True)
    assert isinstance(X, np.ndarray) and X.shape == (3, 2)
    assert y.dtype == np.float64 and w is None
