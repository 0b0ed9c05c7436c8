"""LogisticRegression in flink_ml_tpu_torch against the JAX package.

Seeded numpy inputs go through both packages' fit -> transform, dense and
sparse; the JAX side on a one-device mesh, the port on the CPU. Held to:
coefficients allclose (rtol 1e-4, atol 1e-6), rawPrediction allclose
(atol 1e-5), equal predictions. Models saved by either package load in
the other and predict the same.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import Stage as JaxStage
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.utils import read_write

JAVA_MODEL = "org.apache.flink.ml.classification.logisticregression.LogisticRegressionModel"


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _dense(seed=0, n=300, d=10):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = (X @ rng.standard_normal(d) > 0).astype(np.float64)
    w = rng.random(n) + 0.5
    return X, y, w


def _sparse(seed=1, n=320, d=40, nnz=6):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    indices[rng.random((n, nnz)) < 0.2] = -1
    values = rng.random((n, nnz))
    truth = rng.standard_normal(d)
    y = (np.where(indices >= 0, values * truth[indices], 0).sum(1) > 0).astype(np.float64)
    return indices, values, y


def _estimators(**params):
    pair = []
    for module in (jax_lr, port_lr):
        est = module.LogisticRegression().set_max_iter(8).set_global_batch_size(64)
        est.set_learning_rate(0.5)
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        pair.append(est)
    return pair


def _assert_same_predictions(port_out, jax_out):
    np.testing.assert_array_equal(port_out.column("prediction"), np.asarray(jax_out.column("prediction")))
    np.testing.assert_allclose(
        port_out.column("rawPrediction"), np.asarray(jax_out.column("rawPrediction")), atol=1e-5
    )


@pytest.mark.parametrize(
    "params",
    [{}, {"weight_col": "weight", "reg": 0.05, "elastic_net": 0.5}],
    ids=["plain", "weighted_elasticnet"],
)
def test_dense_fit_transform_matches_jax(both_on_one_device, params):
    X, y, w = _dense()
    jax_est, port_est = _estimators(**params)
    jax_model = jax_est.fit(JaxTable({"features": X, "label": y, "weight": w}))
    port_model = port_est.fit(Table({"features": X, "label": y, "weight": w}))
    np.testing.assert_allclose(port_model.coefficient, jax_model.coefficient, rtol=1e-4, atol=1e-6)
    port_out = port_model.transform(Table({"features": X}))[0]
    jax_out = jax_model.transform(JaxTable({"features": X}))[0]
    assert port_out.column("prediction").dtype == np.float64
    assert port_out.column("rawPrediction").shape == (X.shape[0], 2)
    _assert_same_predictions(port_out, jax_out)


def test_sparse_fit_transform_matches_jax(both_on_one_device):
    indices, values, y = _sparse()
    jax_est, port_est = _estimators()
    jax_model = jax_est.fit(JaxTable({"features": JaxSparseBatch(40, indices, values), "label": y}))
    port_model = port_est.fit(Table({"features": SparseBatch(40, indices, values), "label": y}))
    np.testing.assert_allclose(port_model.coefficient, jax_model.coefficient, rtol=1e-4, atol=1e-6)
    port_out = port_model.transform(Table({"features": SparseBatch(40, indices, values)}))[0]
    jax_out = jax_model.transform(JaxTable({"features": JaxSparseBatch(40, indices, values)}))[0]
    _assert_same_predictions(port_out, jax_out)


def test_tensor_columns_give_tensor_outputs(both_on_one_device):
    """Device in, device out: tensor features train and predict without a
    host round trip of the data, and match the host-column run."""
    X, y, _ = _dense(seed=5)
    _, est = _estimators()
    host_model = est.fit(Table({"features": X, "label": y}))
    model = est.fit(Table({"features": torch.from_numpy(X), "label": torch.from_numpy(y)}))
    np.testing.assert_array_equal(model.coefficient, host_model.coefficient)
    out = model.transform(Table({"features": torch.from_numpy(X).float()}))[0]
    assert isinstance(out.column("prediction"), torch.Tensor)
    np.testing.assert_allclose(
        out.column("rawPrediction").numpy(),
        host_model.transform(Table({"features": X}))[0].column("rawPrediction"),
        atol=1e-6,
    )


@pytest.mark.parametrize("labels", ["numpy", "tensor"])
def test_non_binary_labels_raise(both_on_one_device, labels):
    X, y, _ = _dense(seed=6, n=100)
    y[7] = 2.0
    label_col = torch.from_numpy(y) if labels == "tensor" else y
    _, est = _estimators()
    with pytest.raises(ValueError, match="Multinomial classification is not supported"):
        est.fit(Table({"features": X, "label": label_col}))


def test_multinomial_param_raises(both_on_one_device):
    X, y, _ = _dense(seed=6, n=50)
    _, est = _estimators(multi_class="multinomial")
    with pytest.raises(ValueError, match="Multinomial"):
        est.fit(Table({"features": X, "label": y}))


def test_jax_saved_model_loads_in_port(both_on_one_device, tmp_path):
    X, y, _ = _dense(seed=2)
    jax_est, _ = _estimators()
    jax_model = jax_est.fit(JaxTable({"features": X, "label": y}))
    jax_model.set_prediction_col("pred")
    jax_model.save(str(tmp_path / "m"))
    loaded = Stage.load(str(tmp_path / "m"))
    assert isinstance(loaded, port_lr.LogisticRegressionModel)
    assert loaded.get_prediction_col() == "pred"
    np.testing.assert_array_equal(loaded.coefficient, np.asarray(jax_model.coefficient))
    port_out = loaded.transform(Table({"features": X}))[0]
    jax_out = jax_model.transform(JaxTable({"features": X}))[0]
    np.testing.assert_array_equal(port_out.column("pred"), np.asarray(jax_out.column("pred")))


def test_port_saved_model_loads_in_jax(both_on_one_device, tmp_path):
    indices, values, y = _sparse(seed=3)
    _, port_est = _estimators(raw_prediction_col="raw")
    port_model = port_est.fit(Table({"features": SparseBatch(40, indices, values), "label": y}))
    port_model.save(str(tmp_path / "m"))
    with open(tmp_path / "m" / "metadata") as f:
        assert json.load(f)["className"] == JAVA_MODEL
    assert os.path.exists(tmp_path / "m" / "data" / "model_data.npz")
    loaded = JaxStage.load(str(tmp_path / "m"))
    assert isinstance(loaded, jax_lr.LogisticRegressionModel)
    assert loaded.get_raw_prediction_col() == "raw"
    port_out = port_model.transform(Table({"features": SparseBatch(40, indices, values)}))[0]
    jax_out = loaded.transform(JaxTable({"features": JaxSparseBatch(40, indices, values)}))[0]
    np.testing.assert_array_equal(port_out.column("prediction"), np.asarray(jax_out.column("prediction")))
    np.testing.assert_allclose(port_out.column("raw"), np.asarray(jax_out.column("raw")), atol=1e-5)


def test_port_round_trip_and_model_data(both_on_one_device, tmp_path):
    X, y, _ = _dense(seed=4)
    _, est = _estimators(reg=0.1)
    est.save(str(tmp_path / "est"))
    loaded_est = read_write.load_stage(str(tmp_path / "est"))
    assert isinstance(loaded_est, port_lr.LogisticRegression)
    assert loaded_est.get_reg() == 0.1 and loaded_est.get_global_batch_size() == 64
    model = loaded_est.fit(Table({"features": X, "label": y}))
    model.save(str(tmp_path / "model"))
    reloaded = port_lr.LogisticRegressionModel.load(str(tmp_path / "model"))
    np.testing.assert_array_equal(reloaded.coefficient, model.coefficient)
    copy = port_lr.LogisticRegressionModel().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(copy.coefficient, model.coefficient)
    a = model.transform(Table({"features": X}))[0]
    b = reloaded.transform(Table({"features": X}))[0]
    np.testing.assert_array_equal(a.column("rawPrediction"), b.column("rawPrediction"))


def test_reference_binary_model_data_is_a_later_item(tmp_path):
    stage_dir = tmp_path / "m"
    (stage_dir / "data").mkdir(parents=True)
    (stage_dir / "data" / "part-0").write_bytes(b"\x00")
    with open(stage_dir / "metadata", "w") as f:
        json.dump({"className": JAVA_MODEL, "paramMap": {}}, f)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Stage.load(str(stage_dir))
