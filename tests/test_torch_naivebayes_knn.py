"""NaiveBayes and Knn of the port against the JAX package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor).
Tolerances: none. NaiveBayes' model data (theta, pi, labels) is equal
exactly, fitted on a device or a host column, and so are its predictions,
on data full of near and exact ties that the gap rule rescores on the host
in float64; both packages raise the same errors and keep the same models
on the host. Knn's predictions are equal on separated clusters, and its
neighbours come in `lax.top_k`'s order among exactly equal distances
(duplicated training rows). Models load across the packages.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import Stage as JaxStage
from flink_ml_tpu.models.classification import knn as jax_knn
from flink_ml_tpu.models.classification import naivebayes as jax_nb
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.classification import knn as port_knn
from flink_ml_tpu_torch.models.classification import naivebayes as port_nb


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _tables(X, y, layout):
    """(JAX table, port table) of the same columns: numpy on the host,
    or float32 device columns."""
    if layout == "host":
        return JaxTable({"features": X, "label": y}), Table({"features": X.copy(), "label": y.copy()})
    X32, y32 = np.asarray(X, np.float32), np.asarray(y, np.float32)
    return (JaxTable({"features": jax.device_put(X32), "label": jax.device_put(y32)}),
            Table({"features": torch.from_numpy(X32.copy()), "label": torch.from_numpy(y32.copy())}))


def _host(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


# -- NaiveBayes ------------------------------------------------------------------


def _nb_data(seed=0, n=2_000, d=6, arity=5, labels=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, labels, n).astype(np.float64)
    X = rng.integers(0, arity, (n, d)).astype(np.float64)
    X[:, 0] = np.where(rng.random(n) < 0.6, y, X[:, 0])  # one informative column
    return X, y


def _tied_nb_data(seed=1, n=1_500, d=8, arity=4, extra=7):
    """Every row twice, under labels 0 and 1, so both labels' counts are
    equal (exact score ties), plus `extra` rows of label 1 that move its
    counts a little (a few rows then fall within the gap rule's bound)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, arity, (n, d)).astype(np.float64)
    X = np.vstack([base, base, base[:extra]])
    y = np.concatenate([np.zeros(n), np.ones(n), np.ones(extra)])
    return X, y


def _assert_same_model(got, want):
    assert len(got.theta) == len(want.theta)
    for g_label, w_label in zip(got.theta, want.theta):
        assert len(g_label) == len(w_label)
        for g, w in zip(g_label, w_label):
            assert list(g.items()) == list(w.items())  # keys, values and order
    np.testing.assert_array_equal(got.pi, np.asarray(want.pi))
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    assert got.pi.dtype == np.float64 and got.labels.dtype == np.float64


@pytest.mark.parametrize("smoothing", [1.0, 0.5])
@pytest.mark.parametrize("layout", ["host", "device"])
@pytest.mark.parametrize("seed", [0, 1])
def test_naivebayes_model_data_equals_jax(seed, layout, smoothing):
    X, y = _nb_data(seed)
    jax_table, port_table = _tables(X, y, layout)
    want = jax_nb.NaiveBayes().set_smoothing(smoothing).fit(jax_table)
    got = port_nb.NaiveBayes().set_smoothing(smoothing).fit(port_table)
    _assert_same_model(got, want)


def test_naivebayes_device_fit_equals_host_fit():
    X, y = _nb_data(2, labels=4)
    _, host_table = _tables(X, y, "host")
    _, device_table = _tables(X, y, "device")
    port_nb.HOST_COUNTS.clear()
    on_device = port_nb.NaiveBayes().fit(device_table)
    assert not port_nb.HOST_COUNTS  # the device path ran
    _assert_same_model(on_device, port_nb.NaiveBayes().fit(host_table))


def test_naivebayes_device_fit_counts_across_chunks(monkeypatch):
    X, y = _nb_data(3)
    _, table = _tables(X, y, "device")
    whole = port_nb.NaiveBayes().fit(table)
    monkeypatch.setattr(port_nb, "_COUNT_BUDGET", 6 * 77)  # 77-row chunks
    _assert_same_model(port_nb.NaiveBayes().fit(table), whole)


@pytest.mark.parametrize("layout", ["host", "device"])
@pytest.mark.parametrize("data", ["random", "tied", "near"])
def test_naivebayes_predictions_equal_jax_and_the_float64_argmax(data, layout, monkeypatch):
    X, y = {"random": lambda: _nb_data(4), "tied": lambda: _tied_nb_data(extra=0),
            "near": lambda: _tied_nb_data(extra=7)}[data]()
    jax_table, port_table = _tables(X, y, layout)
    jax_model = jax_nb.NaiveBayes().fit(jax_table)
    port_model = port_nb.NaiveBayes().fit(port_table)
    port_nb.HOST_COUNTS.clear()
    if layout == "device":
        monkeypatch.setattr(port_nb, "_CHUNK_BUDGET", 700 * 6 * 4)  # several predict chunks
    got = _host(port_model.transform(port_table)[0].column("prediction"))
    want = _host(jax_model.transform(jax_table)[0].column("prediction"))
    exact = port_model._predict_host(np.asarray(X, np.float64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, exact)
    rescored = port_nb.HOST_COUNTS["NaiveBayes rows rescored on the host"]
    if layout == "device" and data == "tied":
        assert rescored == X.shape[0]  # every exact tie went to the host
    elif layout == "device" and data == "near":
        assert 0 < rescored < X.shape[0]
    else:
        assert rescored == 0


def test_naivebayes_device_predictions_are_float32_on_the_device():
    X, y = _nb_data(5)
    _, table = _tables(X, y, "device")
    pred = port_nb.NaiveBayes().fit(table).transform(table)[0].column("prediction")
    assert isinstance(pred, torch.Tensor) and pred.dtype == torch.float32


@pytest.mark.parametrize("layout", ["host", "device"])
@pytest.mark.parametrize("where", ["label", "feature"])
def test_naivebayes_nan_errors_are_jax_s(where, layout):
    X, y = _nb_data(6)
    if where == "label":
        y[17] = np.nan
    else:
        X[40, 2] = np.nan
    messages = []
    for stage, table in zip((jax_nb.NaiveBayes(), port_nb.NaiveBayes()), _tables(X, y, layout)):
        with pytest.raises(ValueError) as err:
            stage.fit(table)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("layout", ["host", "device"])
def test_naivebayes_unseen_value_errors_are_jax_s(layout):
    X, y = _nb_data(7)
    jax_table, port_table = _tables(X, y, layout)
    jax_model, port_model = jax_nb.NaiveBayes().fit(jax_table), port_nb.NaiveBayes().fit(port_table)
    Xt = X[:300].copy()
    Xt[123, 4] = 9.0
    jax_test, port_test = _tables(Xt, y[:300], layout)
    messages = []
    for model, table in ((jax_model, jax_test), (port_model, port_test)):
        with pytest.raises(ValueError, match="was not seen during training") as err:
            model.transform(table)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_naivebayes_infinite_category_stays_on_the_host():
    """+inf is the device path's padding: a trained +inf category sends
    the fit and every predict to the host, as in the JAX package."""
    X, y = _nb_data(8)
    X[::9, 1] = np.inf
    jax_table, port_table = _tables(X, y, "device")
    port_nb.HOST_COUNTS.clear()
    jax_model, port_model = jax_nb.NaiveBayes().fit(jax_table), port_nb.NaiveBayes().fit(port_table)
    _assert_same_model(port_model, jax_model)
    assert port_nb.HOST_COUNTS["NaiveBayes fit on the host: a +inf feature value"] == 1
    got = _host(port_model.transform(port_table)[0].column("prediction"))
    np.testing.assert_array_equal(got, _host(jax_model.transform(jax_table)[0].column("prediction")))
    assert port_nb.HOST_COUNTS["NaiveBayes predict on the host: a category that is not finite"] == 1
    assert isinstance(got, np.ndarray) and got.dtype == np.float64


def test_naivebayes_category_cap_takes_the_host_path():
    X, y = _nb_data(9, n=3_000)
    X[:, 3] = np.arange(X.shape[0]) % (port_nb.DEVICE_MAX_CATEGORIES + 5)
    jax_table, port_table = _tables(X, y, "device")
    port_nb.HOST_COUNTS.clear()
    port_model = port_nb.NaiveBayes().fit(port_table)
    _assert_same_model(port_model, jax_nb.NaiveBayes().fit(jax_table))
    assert port_nb.HOST_COUNTS[
        f"NaiveBayes fit on the host: more than {port_nb.DEVICE_MAX_CATEGORIES} categories in a column"] == 1
    assert port_nb.DEVICE_MAX_CATEGORIES == jax_nb.DEVICE_MAX_CATEGORIES


@pytest.mark.parametrize("labels", [[0.1, 0.7], [1.0, 16777217.0]])
def test_naivebayes_labels_not_exact_in_float32_stay_on_the_host(labels):
    X, y = _nb_data(10, labels=2)
    y = np.asarray(labels)[y.astype(np.int64)]
    jax_table = JaxTable({"features": jax.device_put(X.astype(np.float32)), "label": y})
    port_table = Table({"features": torch.from_numpy(X.astype(np.float32)), "label": y.copy()})
    port_nb.HOST_COUNTS.clear()
    jax_model, port_model = jax_nb.NaiveBayes().fit(jax_table), port_nb.NaiveBayes().fit(port_table)
    _assert_same_model(port_model, jax_model)
    assert port_nb.HOST_COUNTS["NaiveBayes fit on the host: labels not exact in float32"] == 1
    got = _host(port_model.transform(port_table)[0].column("prediction"))
    np.testing.assert_array_equal(got, _host(jax_model.transform(jax_table)[0].column("prediction")))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_naivebayes_model_loads_across_packages(tmp_path, direction):
    X, y = _nb_data(11)
    jax_table, port_table = _tables(X, y, "device")
    path = str(tmp_path / "m")
    if direction == "jax_to_port":
        saved = jax_nb.NaiveBayes().set_smoothing(0.25).fit(jax_table)
        saved.save(path)
        loaded = Stage.load(path)
        assert type(loaded) is port_nb.NaiveBayesModel
        got = _host(loaded.transform(port_table)[0].column("prediction"))
    else:
        saved = port_nb.NaiveBayes().set_smoothing(0.25).fit(port_table)
        saved.save(path)
        loaded = jax_nb.NaiveBayesModel.load(path)
        got = _host(loaded.transform(jax_table)[0].column("prediction"))
    _assert_same_model(loaded, saved)
    np.testing.assert_array_equal(got, _host(saved.transform(
        jax_table if direction == "jax_to_port" else port_table)[0].column("prediction")))


def test_naivebayes_model_data_table_round_trip():
    X, y = _nb_data(12)
    _, table = _tables(X, y, "device")
    model = port_nb.NaiveBayes().fit(table)
    fresh = port_nb.NaiveBayesModel().set_model_data(*model.get_model_data())
    _assert_same_model(fresh, model)
    np.testing.assert_array_equal(_host(fresh.transform(table)[0].column("prediction")),
                                  _host(model.transform(table)[0].column("prediction")))


# -- Knn --------------------------------------------------------------------------------


def _clusters(seed=0, n=600, d=5, classes=3, spread=0.2):
    """Planted, well separated clusters: every nearest neighbour of a point
    is far closer than any point of another cluster."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)) * 10
    y = rng.integers(0, classes, n).astype(np.float64)
    X = centers[y.astype(np.int64)] + spread * rng.standard_normal((n, d))
    return X.astype(np.float32).astype(np.float64), y


@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("layout", ["host", "device"])
def test_knn_predictions_equal_jax(layout, k):
    X, y = _clusters()
    Xt, _ = _clusters(seed=1)
    jax_table, port_table = _tables(X, y, layout)
    jax_test, port_test = _tables(Xt, np.zeros(len(Xt)), layout)
    jax_model = jax_knn.Knn().set_k(k).fit(jax_table)
    port_model = port_knn.Knn().set_k(k).fit(port_table)
    got = port_model.transform(port_test)[0].column("prediction")
    want = jax_model.transform(jax_test)[0].column("prediction")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))


def test_knn_fit_keeps_a_device_column_on_the_device():
    X, y = _clusters()
    _, table = _tables(X, y, "device")
    model = port_knn.Knn().fit(table)
    assert isinstance(model.features, torch.Tensor) and isinstance(model.labels, torch.Tensor)


def test_knn_tie_order_on_duplicated_rows():
    """Six copies of one point (exactly equal distances) under labels
    2, 2, 1, 1, 1, 0: k = 3 takes the three lowest indices (labels 2, 2, 1,
    vote 2), as lax.top_k does; another order would vote 1."""
    point = np.asarray([[0.5, -1.0, 2.0]])
    far = point + 100.0 + np.arange(4)[:, None]
    X = np.vstack([np.repeat(point, 6, axis=0), far])
    y = np.asarray([2, 2, 1, 1, 1, 0, 0, 0, 0, 0], np.float64)
    for layout in ("host", "device"):
        jax_table, port_table = _tables(X, y, layout)
        queries = np.vstack([point, point + 1e-3])
        jax_test, port_test = _tables(queries, np.zeros(2), layout)
        got = port_knn.Knn().set_k(3).fit(port_table).transform(port_test)[0].column("prediction")
        want = jax_knn.Knn().set_k(3).fit(jax_table).transform(jax_test)[0].column("prediction")
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, [2.0, 2.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knn_top_k_order_equals_lax_top_k(seed):
    """Training rows drawn from a few distinct points (many exact ties),
    queries among them too: the index lists equal lax.top_k's."""
    rng = np.random.default_rng(seed)
    points = rng.integers(-3, 4, (6, 4)).astype(np.float32)
    train = points[rng.integers(0, 6, 200)]
    test = points[rng.integers(0, 6, 50)]
    got = port_knn.top_k_indices(torch.from_numpy(test), torch.from_numpy(train), 17).numpy()
    want = np.asarray(jax_knn._top_k_indices(jax.device_put(test), jax.device_put(train), 17))
    np.testing.assert_array_equal(got, want)


def test_knn_top_k_across_chunks(monkeypatch):
    X, _ = _clusters(seed=3, n=300)
    X32 = torch.from_numpy(X.astype(np.float32))
    whole = port_knn.top_k_indices(X32, X32, 4)
    monkeypatch.setattr(port_knn, "_CHUNK_BYTES", 24 * 300 * 7)  # 7-row chunks
    np.testing.assert_array_equal(port_knn.top_k_indices(X32, X32, 4).numpy(), whole.numpy())


def test_ordered_keys_sort_as_the_distances():
    d = torch.tensor([[3.0, -0.0, 0.0, -2.5, -1e-30, 1e-30, float("inf"), -float("inf"), 3.0]])
    keys = port_knn.ordered_keys(d)
    order = torch.argsort(keys, dim=1).numpy()[0]
    np.testing.assert_array_equal(order, [7, 3, 4, 1, 2, 5, 0, 8, 6])


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_majority_vote_is_jax_s(seed):
    labels = np.random.default_rng(seed).integers(0, 4, (500, 7)).astype(np.float64)
    np.testing.assert_array_equal(port_knn._majority_vote(labels), jax_knn._majority_vote(labels))
    np.testing.assert_array_equal(port_knn._majority_vote(np.asarray([[3.0, 1.0, 3.0, 1.0]])), [1.0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_knn_model_loads_across_packages(tmp_path, direction):
    X, y = _clusters(seed=4)
    Xt, _ = _clusters(seed=5, n=100)
    jax_table, port_table = _tables(X, y, "device")
    jax_test, port_test = _tables(Xt, np.zeros(100), "device")
    path = str(tmp_path / "m")
    if direction == "jax_to_port":
        saved = jax_knn.Knn().set_k(4).fit(jax_table)
        saved.save(path)
        loaded = Stage.load(path)
        assert type(loaded) is port_knn.KnnModel and loaded.get_k() == 4
        got = loaded.transform(port_test)[0].column("prediction")
        want = saved.transform(jax_test)[0].column("prediction")
    else:
        saved = port_knn.Knn().set_k(4).fit(port_table)
        saved.save(path)
        loaded = jax_knn.KnnModel.load(path)
        got = saved.transform(port_test)[0].column("prediction")
        want = loaded.transform(jax_test)[0].column("prediction")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_knn_model_data_table_round_trip():
    X, y = _clusters(seed=6)
    _, table = _tables(X, y, "host")
    model = port_knn.Knn().fit(table)
    fresh = port_knn.KnnModel().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(fresh.transform(table)[0].column("prediction"),
                                  model.transform(table)[0].column("prediction"))


@pytest.mark.parametrize("name", ["naivebayes", "knn"])
def test_load_without_the_npz_container_names_a15(tmp_path, name):
    X, y = _nb_data(13) if name == "naivebayes" else _clusters(seed=7)
    _, table = _tables(X, y, "device")
    stage = port_nb.NaiveBayes() if name == "naivebayes" else port_knn.Knn()
    stage.fit(table).save(str(tmp_path / "m"))
    data = tmp_path / "m" / "data"
    (data / "model_data.npz").rename(data / "part-0")
    # the reference's binary model data is read now (A.15): an npz is no such part file
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        Stage.load(str(tmp_path / "m"))
    if name == "naivebayes":  # the JAX codec reads Knn's bogus matrix size as a length
        with pytest.raises(IOError, match="Corrupt reference model data file"):
            JaxStage.load(str(tmp_path / "m"))
