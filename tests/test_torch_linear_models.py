"""LinearSVC and LinearRegression in flink_ml_tpu_torch against the JAX package.

Seeded numpy inputs go through both packages' fit -> transform, dense and
sparse (with -1 padding and an index >= d, which the row dot clamps and
the gradient drops); the JAX side on a one-device mesh, the port on the
CPU. Held to: coefficients allclose (rtol 1e-4, atol 1e-6), raw
predictions allclose (atol 1e-5), equal predictions. Models saved by
either package load in the other and predict the same.
"""

import json

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import Stage as JaxStage
from flink_ml_tpu.models.classification import linearsvc as jax_svc
from flink_ml_tpu.models.regression import linearregression as jax_linreg
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.classification import linearsvc as port_svc
from flink_ml_tpu_torch.models.regression import linearregression as port_linreg

D = 12
SPARSE_D = 40
# name -> (JAX module, port module, estimator class, Java model class name)
MODELS = {
    "svc": (jax_svc, port_svc, "LinearSVC",
            "org.apache.flink.ml.classification.linearsvc.LinearSVCModel"),
    "linreg": (jax_linreg, port_linreg, "LinearRegression",
               "org.apache.flink.ml.regression.linearregression.LinearRegressionModel"),
}


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _labels(kind, dots, rng):
    if kind == "svc":
        return (dots > 0).astype(np.float64)
    return dots + 0.1 * rng.standard_normal(dots.shape[0])


def _dense(kind, seed=0, n=300):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    y = _labels(kind, X @ rng.standard_normal(D), rng)
    w = rng.random(n) + 0.5
    return X, y, w


def _sparse(kind, seed=1, n=320, nnz=6):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, SPARSE_D, size=(n, nnz)).astype(np.int32)
    indices[rng.random((n, nnz)) < 0.2] = -1
    indices[rng.random((n, nnz)) < 0.03] = SPARSE_D + 2  # clamped in the dot, dropped in the gradient
    values = rng.random((n, nnz))
    truth = rng.standard_normal(SPARSE_D)
    dots = np.where(indices >= 0, values * truth[np.clip(indices, 0, SPARSE_D - 1)], 0).sum(1)
    return indices, values, _labels(kind, dots, rng)


def _estimators(kind, **params):
    jax_mod, port_mod, cls, _ = MODELS[kind]
    pair = []
    for module in (jax_mod, port_mod):
        est = getattr(module, cls)().set_max_iter(8).set_global_batch_size(64)
        est.set_learning_rate(0.2 if kind == "svc" else 0.1)
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        pair.append(est)
    return pair


def _assert_same_predictions(kind, port_out, jax_out, pred="prediction", raw="rawPrediction"):
    if kind == "svc":
        np.testing.assert_array_equal(port_out.column(pred), np.asarray(jax_out.column(pred)))
        np.testing.assert_allclose(
            port_out.column(raw), np.asarray(jax_out.column(raw)), atol=1e-5)
    else:
        np.testing.assert_allclose(
            port_out.column(pred), np.asarray(jax_out.column(pred)), atol=1e-5)


def _tables(X, **cols):
    return JaxTable({"features": X, **cols}), Table({"features": X, **cols})


def _sparse_tables(indices, values, **cols):
    return (JaxTable({"features": JaxSparseBatch(SPARSE_D, indices, values), **cols}),
            Table({"features": SparseBatch(SPARSE_D, indices, values), **cols}))


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize(
    "params",
    [{}, {"weight_col": "weight", "reg": 0.05, "elastic_net": 0.5}],
    ids=["plain", "weighted_elasticnet"],
)
def test_dense_fit_transform_matches_jax(both_on_one_device, kind, params):
    X, y, w = _dense(kind)
    jax_est, port_est = _estimators(kind, **params)
    jax_train, port_train = _tables(X, label=y, weight=w)
    jax_model, port_model = jax_est.fit(jax_train), port_est.fit(port_train)
    np.testing.assert_allclose(port_model.coefficient, jax_model.coefficient, rtol=1e-4, atol=1e-6)
    jax_in, port_in = _tables(X)
    port_out = port_model.transform(port_in)[0]
    assert port_out.column("prediction").dtype == np.float64
    if kind == "svc":
        assert port_out.column("rawPrediction").shape == (X.shape[0], 2)
    _assert_same_predictions(kind, port_out, jax_model.transform(jax_in)[0])


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_sparse_fit_transform_matches_jax(both_on_one_device, kind):
    indices, values, y = _sparse(kind)
    jax_est, port_est = _estimators(kind)
    jax_train, port_train = _sparse_tables(indices, values, label=y)
    jax_model, port_model = jax_est.fit(jax_train), port_est.fit(port_train)
    np.testing.assert_allclose(port_model.coefficient, jax_model.coefficient, rtol=1e-4, atol=1e-6)
    jax_in, port_in = _sparse_tables(indices, values)
    _assert_same_predictions(kind, port_model.transform(port_in)[0], jax_model.transform(jax_in)[0])


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_tensor_columns_give_tensor_outputs(both_on_one_device, kind):
    """Device in, device out, and the same fit as from host columns."""
    X, y, _ = _dense(kind, seed=5)
    _, est = _estimators(kind)
    host_model = est.fit(Table({"features": X, "label": y}))
    model = est.fit(Table({"features": torch.from_numpy(X), "label": torch.from_numpy(y)}))
    np.testing.assert_array_equal(model.coefficient, host_model.coefficient)
    out = model.transform(Table({"features": torch.from_numpy(X).float()}))[0]
    assert isinstance(out.column("prediction"), torch.Tensor)
    host_out = host_model.transform(Table({"features": X}))[0]
    col = "rawPrediction" if kind == "svc" else "prediction"
    np.testing.assert_allclose(out.column(col).numpy(), host_out.column(col), atol=1e-6)


@pytest.mark.parametrize("threshold", [-0.5, 0.3, 1e9])
def test_svc_threshold_matches_jax(both_on_one_device, threshold):
    X, y, _ = _dense("svc", seed=7)
    jax_est, port_est = _estimators("svc", threshold=threshold)
    jax_train, port_train = _tables(X, label=y)
    jax_model, port_model = jax_est.fit(jax_train), port_est.fit(port_train)
    assert port_model.get_threshold() == threshold
    jax_in, port_in = _tables(X)
    port_out = port_model.transform(port_in)[0]
    _assert_same_predictions("svc", port_out, jax_model.transform(jax_in)[0])
    if threshold == 1e9:
        assert not port_out.column("prediction").any()


@pytest.mark.parametrize("labels", ["numpy", "tensor"])
def test_svc_non_binomial_labels_raise(both_on_one_device, labels):
    X, y, _ = _dense("svc", seed=6, n=100)
    y[7] = 2.0
    label_col = torch.from_numpy(y) if labels == "tensor" else y
    _, est = _estimators("svc")
    with pytest.raises(ValueError, match="Multinomial classification is not supported"):
        est.fit(Table({"features": X, "label": label_col}))


def test_linreg_takes_any_real_label(both_on_one_device):
    X, y, _ = _dense("linreg", seed=6, n=100)
    assert not np.all((y == 0) | (y == 1))
    _, est = _estimators("linreg")
    assert np.all(np.isfinite(est.fit(Table({"features": X, "label": y})).coefficient))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_jax_saved_model_loads_in_port(both_on_one_device, tmp_path, kind):
    X, y, _ = _dense(kind, seed=2)
    jax_est, _ = _estimators(kind)
    jax_model = jax_est.fit(JaxTable({"features": X, "label": y}))
    jax_model.set_prediction_col("pred")
    jax_model.save(str(tmp_path / "m"))
    loaded = Stage.load(str(tmp_path / "m"))
    assert isinstance(loaded, getattr(MODELS[kind][1], MODELS[kind][2] + "Model"))
    assert loaded.get_prediction_col() == "pred"
    np.testing.assert_array_equal(loaded.coefficient, np.asarray(jax_model.coefficient))
    jax_in, port_in = _tables(X)
    _assert_same_predictions(kind, loaded.transform(port_in)[0], jax_model.transform(jax_in)[0],
                             pred="pred")


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_port_saved_model_loads_in_jax(both_on_one_device, tmp_path, kind):
    indices, values, y = _sparse(kind, seed=3)
    _, port_est = _estimators(kind)
    port_model = port_est.fit(Table({"features": SparseBatch(SPARSE_D, indices, values), "label": y}))
    port_model.save(str(tmp_path / "m"))
    with open(tmp_path / "m" / "metadata") as f:
        assert json.load(f)["className"] == MODELS[kind][3]
    loaded = JaxStage.load(str(tmp_path / "m"))
    assert isinstance(loaded, getattr(MODELS[kind][0], MODELS[kind][2] + "Model"))
    jax_in, port_in = _sparse_tables(indices, values)
    _assert_same_predictions(kind, port_model.transform(port_in)[0], loaded.transform(jax_in)[0])


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_model_data_round_trip(both_on_one_device, tmp_path, kind):
    X, y, _ = _dense(kind, seed=4)
    _, est = _estimators(kind, reg=0.1)
    est.save(str(tmp_path / "est"))
    loaded_est = Stage.load(str(tmp_path / "est"))
    assert type(loaded_est) is type(est) and loaded_est.get_reg() == 0.1
    model = loaded_est.fit(Table({"features": X, "label": y}))
    cls = type(model)
    copy = cls().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(copy.coefficient, model.coefficient)
    model.save(str(tmp_path / "model"))
    reloaded = cls.load(str(tmp_path / "model"))
    np.testing.assert_array_equal(reloaded.coefficient, model.coefficient)


@pytest.mark.parametrize("keep_sparse", [None, False, True])
def test_extract_train_data_keeps_sparse_only_when_asked(both_on_one_device, keep_sparse):
    """`extract_train_data(..., keep_sparse=False)` has the JAX package's
    parameter and default: a SparseBatch column is densified unless the
    caller keeps it sparse, as the bounded fits and the fleet do (ROADMAP
    C.38); the stream fit densifies, as the JAX stream path does."""
    from flink_ml_tpu.models import _linear as jax_linear
    from flink_ml_tpu_torch.models import _linear as port_linear

    indices, values, y = _sparse("svc", seed=3, n=20)
    indices[indices >= SPARSE_D] = -1  # densifying needs indices in range
    kwargs = {} if keep_sparse is None else {"keep_sparse": keep_sparse}
    got = port_linear.extract_train_data(
        Table({"f": SparseBatch(SPARSE_D, indices, values), "y": y}), "f", "y", None, **kwargs)
    want = jax_linear.extract_train_data(
        JaxTable({"f": JaxSparseBatch(SPARSE_D, indices, values), "y": y}), "f", "y", None,
        **kwargs)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] is None and want[2] is None
    if keep_sparse:
        assert isinstance(got[0], tuple) and got[0][2] == want[0][2] == SPARSE_D
        for g, w in zip(got[0][:2], want[0][:2]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    else:
        assert not isinstance(got[0], tuple) and got[0].shape == (20, SPARSE_D)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
