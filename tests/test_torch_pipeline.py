"""StandardScaler, OneHotEncoder, VectorAssembler and the Pipeline in
flink_ml_tpu_torch against the JAX package.

Seeded numpy inputs go through both packages; the JAX side on a
one-device mesh, the port on the CPU. Held to: the scaler's mean and std
allclose (rtol 1e-5, atol 1e-6: float32 column sums in another order) and
its transform allclose to the same (host arithmetic is float64 on both
sides); the encoder's and the assembler's outputs equal, with the same
invalid-input errors; the Scaler + Encoder + Assembler + LogisticRegression
pipeline to LogisticRegression's tolerances (coefficients rtol 1e-4,
atol 1e-6; rawPrediction atol 1e-5; equal predictions). A pipeline saved
by either package loads in the other and predicts the same.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Pipeline as JaxPipeline
from flink_ml_tpu import PipelineModel as JaxPipelineModel
from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.feature import onehotencoder as jax_ohe
from flink_ml_tpu.models.feature import standardscaler as jax_ss
from flink_ml_tpu.models.feature import vectorassembler as jax_va
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import Pipeline, PipelineModel, SparseBatch, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.feature import onehotencoder as port_ohe
from flink_ml_tpu_torch.models.feature import standardscaler as port_ss
from flink_ml_tpu_torch.models.feature import vectorassembler as port_va
from flink_ml_tpu_torch.utils import read_write

STATS_TOL = dict(rtol=1e-5, atol=1e-6)
PIPELINE_MODEL = "org.apache.flink.ml.builder.PipelineModel"


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _data(seed=0, n=300, d=6, arity=5):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)) * 4 + 1
    cat = rng.integers(0, arity, n).astype(np.float64)
    y = ((X[:, 0] - 3) + 0.8 * (cat - 2) + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    return X, cat, y


# -- StandardScaler ------------------------------------------------------------

@pytest.mark.parametrize("with_mean,with_std", [(False, True), (True, True), (True, False)])
def test_scaler_matches_jax(both_on_one_device, with_mean, with_std):
    X, _, _ = _data()
    X[:, 2] = 7.0  # zero std: scaled by 1
    models = []
    for module, table in ((jax_ss, JaxTable), (port_ss, Table)):
        est = module.StandardScaler().set_input_col("x").set_output_col("out")
        est.set_with_mean(with_mean).set_with_std(with_std)
        models.append(est.fit(table({"x": X})))
    jax_model, port_model = models
    np.testing.assert_allclose(port_model.mean, np.asarray(jax_model.mean), **STATS_TOL)
    np.testing.assert_allclose(port_model.std, np.asarray(jax_model.std), **STATS_TOL)
    assert port_model.std[2] == 0.0
    got = port_model.transform(Table({"x": X}))[0].column("out")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    want = np.asarray(jax_model.transform(JaxTable({"x": X}))[0].column("out"))
    np.testing.assert_allclose(got, want, **STATS_TOL)
    # the same model data scales the same, bit for bit (float64 on both sides)
    jax_model.mean, jax_model.std = port_model.mean, port_model.std
    np.testing.assert_array_equal(got, np.asarray(jax_model.transform(JaxTable({"x": X}))[0].column("out")))


def test_scaler_stats_are_sample_std_in_float32(both_on_one_device):
    X, _, _ = _data(seed=1)
    model = port_ss.StandardScaler().set_input_col("x").fit(Table({"x": X}))
    np.testing.assert_allclose(model.mean, X.mean(0), rtol=1e-6)
    np.testing.assert_allclose(model.std, X.std(0, ddof=1), rtol=1e-4)
    assert np.array_equal(model.mean, model.mean.astype(np.float32))


def test_scaler_tensor_column_stays_on_device(both_on_one_device):
    X, _, _ = _data(seed=2)
    est = port_ss.StandardScaler().set_input_col("x").set_with_mean(True)
    model = est.fit(Table({"x": torch.from_numpy(X).float()}))
    host_model = est.fit(Table({"x": X}))
    np.testing.assert_array_equal(model.mean, host_model.mean)
    out = model.transform(Table({"x": torch.from_numpy(X).float()}))[0].column("output")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), host_model.transform(Table({"x": X}))[0].column("output"),
                               rtol=1e-5, atol=1e-5)


# -- OneHotEncoder ---------------------------------------------------------------

def _encoders(**params):
    pair = []
    for module in (jax_ohe, port_ohe):
        est = module.OneHotEncoder().set_input_cols("a", "b").set_output_cols("va", "vb")
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        pair.append(est)
    return pair


@pytest.mark.parametrize("drop_last", [True, False])
def test_encoder_matches_jax(both_on_one_device, drop_last):
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 4, 50).astype(np.float64), rng.integers(0, 7, 50).astype(np.float64)
    jax_est, port_est = _encoders(drop_last=drop_last)
    jax_model = jax_est.fit(JaxTable({"a": a, "b": b}))
    port_model = port_est.fit(Table({"a": a, "b": b}))
    np.testing.assert_array_equal(port_model.category_sizes, np.asarray(jax_model.category_sizes))
    got = port_model.transform(Table({"a": a, "b": b}))[0]
    want = jax_model.transform(JaxTable({"a": a, "b": b}))[0]
    for col in ("va", "vb"):
        g, w = got.column(col), want.column(col)
        assert isinstance(g.indices, np.ndarray) and g.size == w.size
        np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
        np.testing.assert_array_equal(g.values, np.asarray(w.values))
    if drop_last:  # the last category is the empty vector: index -1, value 0
        last = a == 3
        assert np.all(got.column("va").indices[last] == -1) and np.all(got.column("va").values[last] == 0)


def test_encoder_tensor_column_gives_tensor_batch(both_on_one_device):
    a = torch.tensor([0.0, 2.0, 1.0, 3.0])
    model = _encoders()[1].set_input_cols("a").set_output_cols("va").fit(Table({"a": a}))
    out = model.transform(Table({"a": a}))[0].column("va")
    assert isinstance(out.indices, torch.Tensor) and out.size == 3
    assert out.indices[:, 0].tolist() == [0, 2, 1, -1] and out.values[:, 0].tolist() == [1, 1, 1, 0]


@pytest.mark.parametrize("column", ["numpy", "tensor"])
@pytest.mark.parametrize(
    "bad_value,match",
    [(1.5, "cannot be parsed as indexed integer"), (-1.0, "cannot be parsed as indexed integer"),
     (9.0, "invalid index")],
    ids=["fraction", "negative", "out_of_range"],
)
def test_encoder_invalid_input_raises_as_jax(both_on_one_device, column, bad_value, match):
    train = np.array([0.0, 1.0, 2.0])
    bad = np.array([0.0, bad_value, 1.0])
    models = []
    for module, table in ((jax_ohe, JaxTable), (port_ohe, Table)):
        est = module.OneHotEncoder().set_input_cols("a").set_output_cols("va")
        models.append(est.fit(table({"a": train})))
    with pytest.raises(ValueError, match=match):
        models[0].transform(JaxTable({"a": bad}))
    col = torch.from_numpy(bad) if column == "tensor" else bad
    with pytest.raises(ValueError, match=match + ".* column a"):
        models[1].transform(Table({"a": col}))


def test_encoder_fit_and_handle_invalid_errors(both_on_one_device):
    est = _encoders()[1].set_input_cols("a").set_output_cols("va")
    with pytest.raises(ValueError, match="cannot be parsed as indexed integer in column a"):
        est.fit(Table({"a": np.array([0.0, 0.5])}))
    model = est.fit(Table({"a": np.array([0.0, 2.0])}))
    model.set_handle_invalid("keep")
    with pytest.raises(ValueError, match="only supports handleInvalid = 'error'"):
        model.transform(Table({"a": np.array([0.0])}))


# -- VectorAssembler ------------------------------------------------------------

def _assembler_inputs(seed=4, n=20):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 3))
    scalar = rng.standard_normal(n)
    indices = rng.integers(0, 5, (n, 2)).astype(np.int32)
    indices[:, 1] = np.where(indices[:, 1] == indices[:, 0], -1, indices[:, 1])
    values = rng.random((n, 2))
    return dense, scalar, indices, values


def _assemblers(**params):
    pair = []
    for module in (jax_va, port_va):
        est = module.VectorAssembler().set_input_cols("d", "s", "sp").set_output_col("out")
        for name, value in params.items():
            getattr(est, f"set_{name}")(*value) if isinstance(value, tuple) else getattr(est, f"set_{name}")(value)
        pair.append(est)
    return pair


def _assembler_tables(dense, scalar, indices, values):
    return (JaxTable({"d": dense, "s": scalar, "sp": JaxSparseBatch(5, indices, values)}),
            Table({"d": dense, "s": scalar, "sp": SparseBatch(5, indices, values)}))


@pytest.mark.parametrize("handle", ["error", "keep", "skip"])
@pytest.mark.parametrize("with_nan", [False, True])
def test_assembler_matches_jax(both_on_one_device, handle, with_nan):
    dense, scalar, indices, values = _assembler_inputs()
    if with_nan:
        dense[[3, 11], 1] = np.nan
    jax_t, port_t = _assembler_tables(dense, scalar, indices, values)
    jax_a, port_a = _assemblers(handle_invalid=handle, input_sizes=(3, 1, 5))
    if with_nan and handle == "error":
        for a, t in ((jax_a, jax_t), (port_a, port_t)):
            with pytest.raises(ValueError, match="Encountered NaN while assembling"):
                a.transform(t)
        return
    got, want = port_a.transform(port_t)[0], jax_a.transform(jax_t)[0]
    assert got.num_rows == want.num_rows == (18 if with_nan and handle == "skip" else 20)
    assert got.column("out").dtype == np.asarray(want.column("out")).dtype == np.float64
    np.testing.assert_array_equal(got.column("out"), np.asarray(want.column("out")))
    np.testing.assert_array_equal(got.column("s"), np.asarray(want.column("s")))


def test_assembler_size_and_param_errors(both_on_one_device):
    dense, scalar, indices, values = _assembler_inputs()
    jax_t, port_t = _assembler_tables(dense, scalar, indices, values)
    for a, t in zip(_assemblers(input_sizes=(3, 2, 5)), (jax_t, port_t)):
        with pytest.raises(ValueError, match=r"Input column s has size 1, declared inputSizes\[1\] = 2"):
            a.transform(t)
    with pytest.raises(ValueError, match="Input sizes must be positive"):
        port_va.VectorAssembler().set_input_sizes(3, 0)
    with pytest.raises(ValueError, match="inputCols"):
        port_va.VectorAssembler().set_input_cols()


@pytest.mark.parametrize("handle", ["keep", "skip"])
def test_assembler_tensor_inputs_stay_on_device(both_on_one_device, handle):
    """Tensor columns (a tensor SparseBatch densified on its device) give a
    tensor, equal to the host run; 'skip' drops the NaN rows there."""
    dense, scalar, indices, values = _assembler_inputs(seed=5)
    dense[[2, 9], 0] = np.nan
    table = Table({"d": torch.from_numpy(dense), "s": torch.from_numpy(scalar),
                   "sp": SparseBatch(5, torch.from_numpy(indices), torch.from_numpy(values))})
    _, assembler = _assemblers(handle_invalid=handle)
    out = assembler.transform(table)[0]
    assert isinstance(out.column("out"), torch.Tensor)
    assert out.column("out").shape == (18 if handle == "skip" else 20, 9)
    host = assembler.transform(_assembler_tables(dense, scalar, indices, values)[1])[0]
    np.testing.assert_array_equal(out.column("out").numpy(), host.column("out"))
    np.testing.assert_array_equal(out.column("sp").indices.numpy(), host.column("sp").indices)


# -- Pipeline ----------------------------------------------------------------------

def _pipeline(module_ss, module_ohe, module_va, module_lr, pipeline_cls):
    return pipeline_cls([
        module_ss.StandardScaler().set_input_col("x").set_output_col("scaled").set_with_mean(True),
        module_ohe.OneHotEncoder().set_input_cols("cat").set_output_cols("cat_vec"),
        module_va.VectorAssembler().set_input_cols("scaled", "cat_vec").set_output_col("features"),
        module_lr.LogisticRegression().set_max_iter(10).set_global_batch_size(64).set_learning_rate(0.5),
    ])


def _pipelines():
    return (_pipeline(jax_ss, jax_ohe, jax_va, jax_lr, JaxPipeline),
            _pipeline(port_ss, port_ohe, port_va, port_lr, Pipeline))


def _assert_same_predictions(port_out, jax_out):
    np.testing.assert_array_equal(port_out.column("prediction"), np.asarray(jax_out.column("prediction")))
    np.testing.assert_allclose(port_out.column("rawPrediction"),
                               np.asarray(jax_out.column("rawPrediction")), atol=1e-5)


def test_pipeline_matches_jax(both_on_one_device):
    X, cat, y = _data(seed=6)
    jax_p, port_p = _pipelines()
    jax_model = jax_p.fit(JaxTable({"x": X, "cat": cat, "label": y}))
    port_model = port_p.fit(Table({"x": X, "cat": cat, "label": y}))
    assert [type(s).__name__ for s in port_model.stages] == [
        "StandardScalerModel", "OneHotEncoderModel", "VectorAssembler", "LogisticRegressionModel"]
    np.testing.assert_allclose(port_model.stages[3].coefficient,
                               np.asarray(jax_model.stages[3].coefficient), rtol=1e-4, atol=1e-6)
    port_out = port_model.transform(Table({"x": X, "cat": cat}))[0]
    _assert_same_predictions(port_out, jax_model.transform(JaxTable({"x": X, "cat": cat}))[0])
    assert (port_out.column("prediction") == y).mean() > 0.75  # better than chance (0.5)


def test_pipeline_fit_transforms_only_up_to_the_last_estimator(both_on_one_device):
    """Stages after the last Estimator are not run on the training data."""

    class Refuses(port_va.VectorAssembler):
        def transform(self, *inputs):
            raise AssertionError("transformed during fit")

    X, cat, y = _data(seed=7)
    stages = _pipelines()[1].stages + [Refuses()]
    model = Pipeline(stages).fit(Table({"x": X, "cat": cat, "label": y}))
    assert model.stages[-1] is stages[-1]
    with pytest.raises(TypeError, match="cannot transform data"):
        Pipeline([object(), port_lr.LogisticRegression()]).fit(Table({"x": X, "label": y}))


def test_pipeline_tensor_columns_stay_on_device(both_on_one_device):
    X, cat, y = _data(seed=8)
    _, port_p = _pipelines()
    host_model = port_p.fit(Table({"x": X, "cat": cat, "label": y}))
    dev = Table({"x": torch.from_numpy(X).float(), "cat": torch.from_numpy(cat).float(),
                 "label": torch.from_numpy(y).float()})
    model = port_p.fit(dev)
    np.testing.assert_allclose(model.stages[3].coefficient, host_model.stages[3].coefficient,
                               rtol=1e-4, atol=1e-6)
    out = model.transform(dev)[0]
    assert isinstance(out.column("features"), torch.Tensor) and out.column("features").shape == (300, 10)
    assert isinstance(out.column("prediction"), torch.Tensor)
    np.testing.assert_allclose(out.column("rawPrediction").numpy(),
                               model.transform(Table({"x": X, "cat": cat}))[0].column("rawPrediction"),
                               atol=1e-5)


def test_jax_saved_pipeline_loads_in_port(both_on_one_device, tmp_path):
    X, cat, y = _data(seed=9)
    jax_p, _ = _pipelines()
    jax_model = jax_p.fit(JaxTable({"x": X, "cat": cat, "label": y}))
    jax_model.save(str(tmp_path / "pm"))
    loaded = Stage.load(str(tmp_path / "pm"))
    assert isinstance(loaded, PipelineModel) and len(loaded.stages) == 4
    _assert_same_predictions(loaded.transform(Table({"x": X, "cat": cat}))[0],
                             jax_model.transform(JaxTable({"x": X, "cat": cat}))[0])


def test_port_saved_pipeline_loads_in_jax(both_on_one_device, tmp_path):
    X, cat, y = _data(seed=10)
    _, port_p = _pipelines()
    port_model = port_p.fit(Table({"x": X, "cat": cat, "label": y}))
    port_model.save(str(tmp_path / "pm"))
    with open(tmp_path / "pm" / "metadata") as f:
        metadata = json.load(f)
    assert metadata["className"] == PIPELINE_MODEL and metadata["numStages"] == 4
    assert sorted(os.listdir(tmp_path / "pm" / "stages")) == ["0", "1", "2", "3"]
    loaded = JaxPipelineModel.load(str(tmp_path / "pm"))
    _assert_same_predictions(port_model.transform(Table({"x": X, "cat": cat}))[0],
                             loaded.transform(JaxTable({"x": X, "cat": cat}))[0])
    again = PipelineModel.load(str(tmp_path / "pm"))
    np.testing.assert_array_equal(again.transform(Table({"x": X, "cat": cat}))[0].column("rawPrediction"),
                                  port_model.transform(Table({"x": X, "cat": cat}))[0].column("rawPrediction"))


def test_unfitted_pipeline_round_trips_across_packages(both_on_one_device, tmp_path):
    _, port_p = _pipelines()
    port_p.save(str(tmp_path / "p"))
    with open(tmp_path / "p" / "metadata") as f:
        assert json.load(f)["className"] == "org.apache.flink.ml.builder.Pipeline"
    jax_loaded = JaxPipeline.load(str(tmp_path / "p"))
    assert [type(s).__name__ for s in jax_loaded.stages] == [type(s).__name__ for s in port_p.stages]
    assert jax_loaded.stages[3].get_learning_rate() == 0.5
    jax_loaded.save(str(tmp_path / "q"))
    port_loaded = read_write.load_stage(str(tmp_path / "q"))
    assert isinstance(port_loaded, Pipeline)
    assert port_loaded.stages[2].get_input_cols() == ["scaled", "cat_vec"]


@pytest.mark.parametrize("num_stages,index,want", [(4, 2, "2"), (12, 3, "03"), (100, 7, "007")])
def test_stage_paths_pad_as_the_reference(tmp_path, num_stages, index, want):
    from flink_ml_tpu.utils import read_write as jax_read_write

    path = read_write.get_path_for_pipeline_stage(index, num_stages, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "stages", want)
    assert path == jax_read_write.get_path_for_pipeline_stage(index, num_stages, str(tmp_path))
    legacy = os.path.join(str(tmp_path), "stages", str(index).zfill(5))
    os.makedirs(legacy)
    assert read_write.resolve_pipeline_stage_path(index, num_stages, str(tmp_path)) == legacy
