"""OnlineLogisticRegression (FTRL) and OnlineKMeans in flink_ml_tpu_torch
against the JAX package.

Seeded numpy streams go through both packages; the JAX side on a
one-device mesh, the port on the CPU, both in float32. Held to:

- `_ftrl_step` and every published FTRL version allclose (rtol 1e-5,
  atol 1e-6), on rows that hold zeros, so the per-feature non-zero count
  is exercised. A coordinate whose |z| lies within NEAR_THRESHOLD of l1 is
  zeroed or kept by rounding alone; such coordinates are counted and left
  out, and must stay few;
- every OnlineKMeans version allclose (rtol 1e-5, atol 1e-5), weights
  allclose, with decay 0 and 0.5, on clusters with no point near a tie;
- models saved by either package load in the other and predict alike,
  the modelVersion column included.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import Stage as JaxStage
from flink_ml_tpu.linalg import DenseVector as JaxDenseVector
from flink_ml_tpu.models.classification import onlinelogisticregression as jax_olr
from flink_ml_tpu.models.clustering import onlinekmeans as jax_okm
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import StreamTable, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.linalg import DenseVector
from flink_ml_tpu_torch.models.classification import onlinelogisticregression as port_olr
from flink_ml_tpu_torch.models.clustering import onlinekmeans as port_okm

FTRL_TOL = dict(rtol=1e-5, atol=1e-6)
KMEANS_TOL = dict(rtol=1e-5, atol=1e-5)
NEAR_THRESHOLD = 1e-6
D = 9


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _lr_data(seed=0, n=640, zero_share=0.3):
    """Rows with a share of exact zeros and labels of a planted hyperplane."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)) * (rng.random((n, D)) > zero_share)
    y = (X @ rng.standard_normal(D) > 0).astype(np.float64)
    return X, y


def _lr_stream(X, y, rows, table_cls, stream_cls):
    return stream_cls.from_batches([
        table_cls({"features": X[i:i + rows], "label": y[i:i + rows]})
        for i in range(0, X.shape[0], rows)])


def _olr(module, vector_cls, table_cls, reg, elastic_net, batch=32):
    return (module.OnlineLogisticRegression().set_global_batch_size(batch)
            .set_reg(reg).set_elastic_net(elastic_net)
            .set_initial_model_data(table_cls({"coefficient": [vector_cls(np.zeros(D))]})))


def _versions(model):
    out = []
    while True:
        before = model.model_version
        if model.process_updates(1) == before:
            return out
        out.append((model.model_version, np.array(model.coefficient)))


def _ftrl64(X, y, batch, reg, elastic_net, alpha=0.1, beta=0.1):
    """A float64 replay of FTRL; returns |z| - l1 after each batch."""
    l1, l2 = elastic_net * reg, (1.0 - elastic_net) * reg
    coeff, z, n = np.zeros(D), np.zeros(D), np.zeros(D)
    margins = []
    for i in range(0, X.shape[0] - batch + 1, batch):
        Xb, yb = X[i:i + batch], y[i:i + batch]
        p = 1.0 / (1.0 + np.exp(-(Xb @ coeff)))
        cnt = np.sum(Xb != 0.0, axis=0)
        g = np.where(cnt > 0, (Xb.T @ (p - yb)) / np.maximum(cnt, 1), 0.0)
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / alpha
        z = z + g - sigma * coeff
        n = n + g * g
        coeff = np.where(np.abs(z) <= l1, 0.0, (np.sign(z) * l1 - z) / ((beta + np.sqrt(n)) / alpha + l2))
        margins.append(np.abs(z) - l1)
    return margins


def test_ftrl_step_matches_jax():
    rng = np.random.default_rng(1)
    X, y = _lr_data(seed=1, n=200)
    coeff = rng.standard_normal(D) * 0.1
    z, n = rng.standard_normal(D) * 0.05, rng.random(D)
    args = [a.astype(np.float32) for a in (coeff, z, n, X, y)]
    hyper = (0.1, 0.1, 0.01, 0.02)
    got = port_olr._ftrl_step(*map(torch.from_numpy, args), *hyper)
    want = jax_olr._ftrl_step(*map(jnp.asarray, args), *hyper)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FTRL_TOL)


@pytest.mark.parametrize("reg,elastic_net", [(0.0, 0.0), (0.1, 0.5), (0.2, 1.0)])
def test_every_ftrl_version_matches_jax(both_on_one_device, reg, elastic_net):
    X, y = _lr_data()
    want = _olr(jax_olr, JaxDenseVector, JaxTable, reg, elastic_net).fit(
        _lr_stream(X, y, 48, JaxTable, JaxStreamTable))
    got = _olr(port_olr, DenseVector, Table, reg, elastic_net).fit(
        _lr_stream(X, y, 48, Table, StreamTable))
    want_versions, got_versions = _versions(want), _versions(got)
    assert [v for v, _ in got_versions] == [v for v, _ in want_versions] == list(range(1, 21))
    near = 0
    for (_, g), (_, w), margin in zip(got_versions, want_versions, _ftrl64(X, y, 32, reg, elastic_net)):
        clear = np.abs(margin) > NEAR_THRESHOLD
        near += int(np.sum(~clear))
        np.testing.assert_allclose(g[clear], w[clear], **FTRL_TOL)
    assert near <= 2, f"{near} near-threshold coordinates"


def test_ftrl_fit_is_lazy_and_stamps_versions(both_on_one_device):
    X, y = _lr_data(seed=2)
    read = []

    def source():
        for i in range(0, 640, 64):
            read.append(i)
            yield Table({"features": X[i:i + 64], "label": y[i:i + 64]})

    model = _olr(port_olr, DenseVector, Table, 0.1, 0.5).fit(StreamTable(source()))
    assert read == [] and model.model_version == 0
    np.testing.assert_array_equal(model.coefficient, np.zeros(D))
    assert model.process_updates(3) == 3
    assert model.process_updates() == 20
    host = model.transform(Table({"features": X}))[0]
    np.testing.assert_array_equal(host.column("modelVersion"), np.full(640, 20))
    assert host.column("prediction").dtype == np.float64
    assert host.column("rawPrediction").shape == (640, 2)
    dev = model.transform(Table({"features": torch.from_numpy(X)}))[0]
    assert dev.column("modelVersion").dtype == torch.int32
    assert torch.equal(dev.column("modelVersion"), torch.full((640,), 20, dtype=torch.int32))
    np.testing.assert_array_equal(dev.column("prediction").numpy(), host.column("prediction"))
    accuracy = np.mean(host.column("prediction") == y)
    assert accuracy > 0.8


@pytest.mark.parametrize("module", [port_olr, port_okm], ids=["lr", "kmeans"])
def test_online_fit_errors(both_on_one_device, module):
    est = module.OnlineLogisticRegression() if module is port_olr else module.OnlineKMeans()
    with pytest.raises(ValueError, match="initial model data"):
        est.fit(StreamTable([]))
    with pytest.raises(TypeError, match="StreamTable"):
        est.fit(Table({"features": np.zeros((2, 2))}))


def _blobs(seed=0, n=480, d=4, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 8
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("decay", [0.0, 0.5])
def test_every_online_kmeans_version_matches_jax(both_on_one_device, decay):
    X = _blobs()

    def fit(module, table_cls, stream_cls):
        est = (module.OnlineKMeans().set_k(3).set_global_batch_size(40).set_decay_factor(decay)
               .set_initial_model_data(module.generate_random_model_data(3, 4, 2.0, seed=7)))
        return est.fit(stream_cls.from_batches(
            [table_cls({"features": X[i:i + 50]}) for i in range(0, 480, 50)]))

    want, got = fit(jax_okm, JaxTable, JaxStreamTable), fit(port_okm, Table, StreamTable)
    for version in range(1, 13):
        assert want.process_updates(1) == got.process_updates(1) == version
        np.testing.assert_allclose(got.centroids, want.centroids, **KMEANS_TOL)
        np.testing.assert_allclose(got.weights, want.weights, **KMEANS_TOL)
    assert got.process_updates() == 12  # the last 30 rows make no batch


def test_generate_random_model_data_matches_jax():
    got = port_okm._extract_model_data(port_okm.generate_random_model_data(4, 3, 1.5, seed=11))
    want = jax_okm._extract_model_data(jax_okm.generate_random_model_data(4, 3, 1.5, seed=11))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_update_keeps_an_empty_cluster():
    centroids = torch.tensor([[0.0, 0.0], [100.0, 100.0]])
    X = torch.tensor([[1.0, 1.0], [3.0, 1.0]])
    new, weights = port_okm._batch_update(centroids, torch.tensor([2.0, 5.0]), X, 0.5, "euclidean")
    # centroid 0: (0 * 1 + mean(2, 1) * 2) / 3; centroid 1 chose no point
    torch.testing.assert_close(new, torch.tensor([[4.0 / 3.0, 2.0 / 3.0], [100.0, 100.0]]))
    torch.testing.assert_close(weights, torch.tensor([3.0, 2.5]))


def _trained(kind, package):
    """A model of `kind` trained a few versions by `package`."""
    if kind == "lr":
        X, y = _lr_data(seed=3)
        if package == "jax":
            model = _olr(jax_olr, JaxDenseVector, JaxTable, 0.1, 0.5).fit(
                _lr_stream(X, y, 64, JaxTable, JaxStreamTable))
        else:
            model = _olr(port_olr, DenseVector, Table, 0.1, 0.5).fit(
                _lr_stream(X, y, 64, Table, StreamTable))
        model.process_updates(5)
        return model, X
    X = _blobs(seed=4)
    module, table_cls, stream_cls = (
        (jax_okm, JaxTable, JaxStreamTable) if package == "jax" else (port_okm, Table, StreamTable))
    model = (module.OnlineKMeans().set_k(3).set_global_batch_size(60).set_decay_factor(0.5)
             .set_initial_model_data(module.generate_random_model_data(3, 4, 1.0, seed=2))
             .fit(stream_cls.from_batches([table_cls({"features": X[i:i + 60]})
                                           for i in range(0, 480, 60)])))
    model.process_updates(4)
    return model, X


JAVA_MODELS = {
    "lr": "org.apache.flink.ml.classification.onlinelogisticregression.OnlineLogisticRegressionModel",
    "kmeans": "org.apache.flink.ml.clustering.onlinekmeans.OnlineKMeansModel",
}


@pytest.mark.parametrize("saved_by", ["jax", "port"])
@pytest.mark.parametrize("kind", ["lr", "kmeans"])
def test_models_load_across_packages(both_on_one_device, tmp_path, kind, saved_by):
    model, X = _trained(kind, saved_by)
    path = str(tmp_path / "m")
    model.save(path)
    if saved_by == "port":
        with open(tmp_path / "m" / "metadata") as f:
            assert json.load(f)["className"] == JAVA_MODELS[kind]
    jax_model, port_model = JaxStage.load(path), Stage.load(path)
    assert port_model.model_version == jax_model.model_version == (5 if kind == "lr" else 4)
    got = port_model.transform(Table({"features": X}))[0]
    want = jax_model.transform(JaxTable({"features": X}))[0]
    if kind == "lr":
        np.testing.assert_array_equal(got.column("prediction"), np.asarray(want.column("prediction")))
        np.testing.assert_allclose(got.column("rawPrediction"),
                                   np.asarray(want.column("rawPrediction")), rtol=1e-12)
        np.testing.assert_array_equal(got.column("modelVersion"), np.asarray(want.column("modelVersion")))
    else:
        np.testing.assert_array_equal(got.column("prediction"), np.asarray(want.column("prediction")))
    port_data = port_model.get_model_data()[0].collect()[0]
    jax_data = jax_model.get_model_data()[0].collect()[0]
    assert sorted(port_data) == sorted(jax_data)


def test_model_data_round_trip(both_on_one_device):
    model, X = _trained("lr", "port")
    twin = port_olr.OnlineLogisticRegressionModel().set_model_data(*model.get_model_data())
    assert twin.model_version == 5
    np.testing.assert_array_equal(twin.coefficient, model.coefficient)
    km, _ = _trained("kmeans", "port")
    twin = port_okm.OnlineKMeansModel().set_model_data(*km.get_model_data())
    np.testing.assert_array_equal(twin.centroids, km.centroids)
    np.testing.assert_array_equal(twin.weights, km.weights)
