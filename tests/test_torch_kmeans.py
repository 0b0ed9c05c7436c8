"""KMeans and the distance measures in flink_ml_tpu_torch against the JAX package.

Seeded numpy inputs go through both packages; the JAX side on a
one-device mesh, the port on the CPU, both in float32. Held to: pairwise
distances allclose (rtol 1e-5, atol 1e-5), equal nearest centroids; the
fit starts from the same rows, its centroids allclose (rtol 1e-5,
atol 1e-5: the port sums with a matmul, the JAX package in reduce form),
its counts and the transform's assignments equal. Models saved by either
package load in the other and assign the same.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import Stage as JaxStage
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.ops import distance as jax_distance
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.clustering import kmeans as port_kmeans
from flink_ml_tpu_torch.ops import distance

MEASURES = ["euclidean", "manhattan", "cosine"]
TOL = dict(rtol=1e-5, atol=1e-5)
JAVA_MODEL = "org.apache.flink.ml.clustering.kmeans.KMeansModel"


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _blobs(seed=0, n=240, d=5, k=4):
    """k well-separated clusters, so no point lies near a tie."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 6
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("name", MEASURES)
def test_pairwise_and_find_closest_match_jax(name):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((50, 7)).astype(np.float32)
    C = rng.standard_normal((6, 7)).astype(np.float32)
    port = distance.DistanceMeasure.get_instance(name)
    ref = jax_distance.DistanceMeasure.get_instance(name)
    got = port.pairwise(torch.from_numpy(X), torch.from_numpy(C))
    assert got.shape == (50, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.pairwise(jnp.asarray(X), jnp.asarray(C))), **TOL)
    closest = port.find_closest(torch.from_numpy(X), torch.from_numpy(C))
    assert closest.dtype == torch.int32
    np.testing.assert_array_equal(closest.numpy(), np.asarray(ref.find_closest(jnp.asarray(X), jnp.asarray(C))))
    np.testing.assert_allclose(
        float(port.distance(torch.from_numpy(X[0]), torch.from_numpy(C[0]))),
        float(ref.distance(jnp.asarray(X[0]), jnp.asarray(C[0]))), **TOL)


def test_unknown_measure_raises():
    with pytest.raises(ValueError, match="Unsupported distance measure"):
        distance.DistanceMeasure.get_instance("chebyshev")


@pytest.mark.parametrize("rows", [0, 1, 37])
def test_manhattan_blocks_give_the_unblocked_result(monkeypatch, rows):
    """Blocks of rows (here 3 at a time) add up to the one-shot (n, k, d)
    form, for any row count."""
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((rows, 4)))
    C = torch.from_numpy(rng.standard_normal((5, 4)))
    monkeypatch.setattr(distance, "MANHATTAN_BLOCK_ELEMENTS", 3 * 5 * 4)
    got = distance.ManhattanDistanceMeasure().pairwise(X, C)
    assert got.shape == (rows, 5)
    torch.testing.assert_close(got, torch.sum(torch.abs(X[:, None, :] - C[None, :, :]), dim=-1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,k,seed", [(240, 4, 0), (10, 10, 7), (1000, 3, 2**32 + 5)])
def test_init_rows_match_jax(n, k, seed):
    want = jax_kmeans._sample_without_replacement(np.random.RandomState(seed % (2**32)), n, k)
    np.testing.assert_array_equal(port_kmeans.init_rows(n, k, seed), want)


def _estimators(**params):
    pair = []
    for module in (jax_kmeans, port_kmeans):
        est = module.KMeans().set_k(4).set_max_iter(6).set_seed(3)
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        pair.append(est)
    return pair


def _assert_same_model(port_model, jax_model):
    np.testing.assert_allclose(port_model.centroids, np.asarray(jax_model.centroids), **TOL)
    np.testing.assert_array_equal(port_model.weights, np.asarray(jax_model.weights))


@pytest.mark.parametrize("name", MEASURES)
def test_fit_transform_matches_jax(both_on_one_device, name):
    X = _blobs()
    jax_est, port_est = _estimators(distance_measure=name)
    jax_model = jax_est.fit(JaxTable({"features": X}))
    port_model = port_est.fit(Table({"features": X}))
    _assert_same_model(port_model, jax_model)
    assert port_model.get_distance_measure() == name and port_model.get_k() == 4
    got = port_model.transform(Table({"features": X}))[0].column("prediction")
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jax_model.transform(JaxTable({"features": X}))[0].column("prediction")))


def test_one_epoch_starts_from_the_same_rows(both_on_one_device):
    """maxIter 1 centroids are the means of the init rows' cells: equal only
    if both packages drew the same rows."""
    X = np.random.default_rng(4).random((97, 3)).astype(np.float32)
    jax_est, port_est = _estimators(max_iter=1, seed=11)
    _assert_same_model(port_est.fit(Table({"features": X})), jax_est.fit(JaxTable({"features": X})))


def test_empty_cluster_keeps_its_centroid(both_on_one_device):
    """Duplicate rows: at least two init centroids coincide, ties go to the
    lowest index, so the other cluster stays empty and keeps its centroid."""
    X = np.array([[0.0, 0.0]] * 10 + [[10.0, 10.0]] * 2, dtype=np.float32)
    jax_est, port_est = _estimators(k=3)
    port_model = port_est.fit(Table({"features": X}))
    _assert_same_model(port_model, jax_est.fit(JaxTable({"features": X})))
    assert (port_model.weights == 0).any()
    assert port_model.weights.sum() == 12


def test_fewer_points_than_k_raises(both_on_one_device):
    with pytest.raises(ValueError, match=r"Number of points \(3\) is less than k \(4\)"):
        _estimators()[1].fit(Table({"features": np.zeros((3, 2))}))


def test_seed_defaults_to_zero():
    est = port_kmeans.KMeans()
    assert est.get_seed() == 0 and est.get_k() == 2 and est.get_max_iter() == 20
    assert est.get_distance_measure() == "euclidean" and est.get_init_mode() == "random"


def test_tensor_columns_give_tensor_outputs(both_on_one_device):
    X = _blobs(seed=5)
    _, est = _estimators()
    host_model = est.fit(Table({"features": X}))
    model = est.fit(Table({"features": torch.from_numpy(X)}))
    np.testing.assert_array_equal(model.centroids, host_model.centroids)
    out = model.transform(Table({"features": torch.from_numpy(X)}))[0].column("prediction")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), host_model.transform(Table({"features": X}))[0].column("prediction"))


def test_refit_is_bit_identical(both_on_one_device):
    X = np.random.default_rng(6).random((300, 8)).astype(np.float32)
    _, est = _estimators()
    a, b = est.fit(Table({"features": X})), est.fit(Table({"features": X}))
    np.testing.assert_array_equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.weights, b.weights)


def test_jax_saved_model_loads_in_port(both_on_one_device, tmp_path):
    X = _blobs(seed=8)
    jax_est, _ = _estimators(distance_measure="manhattan")
    jax_model = jax_est.fit(JaxTable({"features": X}))
    jax_model.save(str(tmp_path / "m"))
    loaded = Stage.load(str(tmp_path / "m"))
    assert isinstance(loaded, port_kmeans.KMeansModel)
    assert loaded.get_distance_measure() == "manhattan"
    np.testing.assert_array_equal(loaded.centroids, np.asarray(jax_model.centroids))
    np.testing.assert_array_equal(
        loaded.transform(Table({"features": X}))[0].column("prediction"),
        np.asarray(jax_model.transform(JaxTable({"features": X}))[0].column("prediction")))


def test_port_saved_model_loads_in_jax(both_on_one_device, tmp_path):
    X = _blobs(seed=9)
    _, port_est = _estimators(distance_measure="cosine")
    port_model = port_est.fit(Table({"features": X}))
    port_model.save(str(tmp_path / "m"))
    with open(tmp_path / "m" / "metadata") as f:
        assert json.load(f)["className"] == JAVA_MODEL
    loaded = JaxStage.load(str(tmp_path / "m"))
    assert isinstance(loaded, jax_kmeans.KMeansModel)
    np.testing.assert_array_equal(np.asarray(loaded.weights), port_model.weights)
    np.testing.assert_array_equal(
        port_model.transform(Table({"features": X}))[0].column("prediction"),
        np.asarray(loaded.transform(JaxTable({"features": X}))[0].column("prediction")))


def test_model_data_round_trip(both_on_one_device, tmp_path):
    X = _blobs(seed=10)
    _, est = _estimators()
    model = est.fit(Table({"features": X}))
    copy = port_kmeans.KMeansModel().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(copy.centroids, model.centroids)
    np.testing.assert_array_equal(copy.weights, model.weights)
    model.save(str(tmp_path / "m"))
    reloaded = port_kmeans.KMeansModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(reloaded.centroids, model.centroids)
    np.testing.assert_array_equal(reloaded.weights, model.weights)


def test_fleet_fit_is_a_later_item(both_on_one_device):
    """The fleet fit is ported now (A.11, tests/test_torch_fleet.py): one
    call trains every member, each as its solo Lloyd from its init rows to
    its own maxIter, in one packed (N, k * d + k) result."""
    X = torch.from_numpy(_blobs(seed=12))
    inits = torch.stack([X[torch.as_tensor(port_kmeans.init_rows(X.shape[0], 4, seed))]
                         for seed in (1, 2)])
    packed = port_kmeans._lloyd_fleet_train(X, inits, [6, 2], "euclidean")
    assert packed.shape == (2, 4 * 5 + 4)
    for m, max_iter in enumerate((6, 2)):
        centroids, counts = port_kmeans._lloyd_train(X, inits[m], max_iter, "euclidean")
        torch.testing.assert_close(packed[m, :20].reshape(4, 5), centroids, rtol=0, atol=0)
        torch.testing.assert_close(packed[m, 20:], counts, rtol=0, atol=0)
