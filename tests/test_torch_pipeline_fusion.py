"""The port's transform fusion planner against the JAX package's.

The same seeded numpy inputs go through both packages: the JAX side as
`jax.Array` columns on a one-device mesh under its default
`pipeline_fusion = "auto"` (as tests/test_pipeline_fusion.py runs it), the
port as CPU tensors under `config.use_device("cpu")`, where a fused
segment calls its stages' kernels in turn (on the card it is one captured
CUDA graph; chip_smoke.py checks that).

Held to:
- every one of the 25 stages with a transform kernel, alone in a
  PipelineModel: the port's fused output equal to its eager output
  (`pipeline_fusion = "off"`) bit for bit, the plan gauges equal to the
  JAX package's, and the output within the tolerance of that stage's own
  parity test against the JAX fused output: equal for comparisons,
  selections, gathers and the elementwise stages both sides compute with
  the same IEEE operations (test_torch_feature_transformers.py,
  test_torch_feature_estimators.py, test_torch_text_stages.py); Normalizer
  rtol 1e-6, atol 1e-7 and DCT rtol 1e-5, atol 1e-6 (test_torch_feature_
  transformers.py); StandardScaler rtol 1e-5, atol 1e-6
  (test_torch_pipeline.py); the linear models' raw predictions atol 1e-5
  and equal labels (test_torch_linear_models.py, test_torch_online.py);
  KMeans equal nearest centroids (test_torch_kmeans.py);
- the contracts of tests/test_pipeline_fusion.py: a sparse LR input, the
  five-stage guarded pipeline (one transform host sync fused, two eager),
  a guard-free pipeline (none), chained producers and consumers, a host
  stage that breaks a segment, a host input that runs eagerly, guard
  errors with the same message raised before any later eager stage, and
  plans rebuilt on a param or a model-array change;
- a swap-capable model keeps its plan across publications and the next
  transform stamps the new version; the BASELINE and text pipelines plan
  no fused segment in either package; a float64 column into Bucketizer
  fuses (its produced dtype is the port's) and equals eager; C.10's NaN
  in a dropped column stays out of the fused selector's rows;
  `transform_deferred` leaves its guards pending for a later drain.
"""

import importlib
import importlib.util
import inspect
import os
import pkgutil
import types

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import PipelineModel as JaxPipelineModel
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import config as jax_config
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
from flink_ml_tpu.utils import metrics as jax_metrics

import flink_ml_tpu_torch
from flink_ml_tpu_torch import PipelineModel, SparseBatch, Table, config
from flink_ml_tpu_torch.api import AlgoOperator, Transformer
from flink_ml_tpu_torch.pipeline import _drain_guards, _GraphCache
from flink_ml_tpu_torch.table import DictTokenMatrix
from flink_ml_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=0, atol=0)
NORMALIZER_TOL = dict(rtol=1e-6, atol=1e-7)
DCT_TOL = dict(rtol=1e-5, atol=1e-6)
SCALER_TOL = dict(rtol=1e-5, atol=1e-6)
RAW_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def _mat(rng, n=9, d=4, scale=1.0):
    return (rng.standard_normal((n, d)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# one case per stage with a kernel: rng -> (make(pkg), columns, tolerance)
# ---------------------------------------------------------------------------

def _model(pkg, path, cls, **attrs):
    m = getattr(_mod(pkg, path), cls)()
    for k, v in attrs.items():
        setattr(m, k, v)
    return m


def _standard_scaler(rng):
    mean, std = rng.standard_normal(4), np.abs(rng.standard_normal(4)) + 0.1

    def make(pkg):
        return _model(pkg, "models.feature.standardscaler", "StandardScalerModel",
                      mean=mean, std=std).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, SCALER_TOL


def _minmax_scaler(rng):
    lo, hi = np.array([-1.0, 0.0, -2.0, 0.5]), np.array([1.0, 0.0, 3.0, 2.5])

    def make(pkg):
        return _model(pkg, "models.feature.minmaxscaler", "MinMaxScalerModel", min_vector=lo,
                      max_vector=hi).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, EXACT


def _maxabs_scaler(rng):
    def make(pkg):
        return _model(pkg, "models.feature.maxabsscaler", "MaxAbsScalerModel",
                      max_abs=np.array([2.0, 0.0, 1.5, 4.0])
                      ).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, EXACT


def _robust_scaler(rng):
    medians, ranges = rng.standard_normal(4), np.abs(rng.standard_normal(4))

    def make(pkg):
        return _model(pkg, "models.feature.robustscaler", "RobustScalerModel", medians=medians,
                      ranges=ranges).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, EXACT


def _normalizer(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.normalizer").Normalizer().set_p(3.0)
                .set_input_col("features").set_output_col("out"))
    return make, {"features": _mat(rng)}, NORMALIZER_TOL


def _binarizer(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.binarizer").Binarizer().set_input_cols("a", "b")
                .set_output_cols("oa", "ob").set_thresholds(0.0, 0.5))
    return make, {"a": rng.standard_normal(9).astype(np.float32),
                  "b": rng.random(9).astype(np.float32)}, EXACT


def _bucketizer(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.bucketizer").Bucketizer().set_input_cols("a")
                .set_output_cols("oa").set_splits_array([[-10.0, -0.5, 0.0, 0.5, 10.0]]))
    return make, {"a": rng.standard_normal(9).astype(np.float32)}, EXACT


def _dct(rng):
    def make(pkg):
        return _mod(pkg, "models.feature.dct").DCT().set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng, d=8)}, DCT_TOL


def _elementwise_product(rng):
    def make(pkg):
        vectors = _mod(pkg, "linalg").Vectors
        return (_mod(pkg, "models.feature.elementwiseproduct").ElementwiseProduct()
                .set_scaling_vec(vectors.dense(1.5, -2.0, 0.0, 4.0))
                .set_input_col("features").set_output_col("out"))
    return make, {"features": _mat(rng)}, EXACT


def _idf(rng):
    idf = np.abs(rng.standard_normal(4))

    def make(pkg):
        return _model(pkg, "models.feature.idf", "IDFModel", idf=idf,
                      doc_freq=np.arange(1, 5).astype(np.float64), num_docs=9
                      ).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, EXACT


def _imputer(rng):
    a, b = rng.standard_normal(9).astype(np.float32), rng.standard_normal(9).astype(np.float32)
    a[::3] = np.nan
    b[1::4] = np.nan

    def make(pkg):
        return _model(pkg, "models.feature.imputer", "ImputerModel",
                      surrogates={"a": 1.25, "b": -3.0}
                      ).set_input_cols("a", "b").set_output_cols("oa", "ob")
    return make, {"a": a, "b": b}, EXACT


def _interaction(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.interaction").Interaction().set_input_cols("va", "vb")
                .set_output_col("out"))
    return make, {"va": _mat(rng, d=2), "vb": _mat(rng, d=3)}, EXACT


def _kbins(rng):
    edges = [np.array([-np.inf, -0.5, 0.5, np.inf]), np.array([-np.inf, 0.0, np.inf])]

    def make(pkg):
        return _model(pkg, "models.feature.kbinsdiscretizer", "KBinsDiscretizerModel",
                      bin_edges=edges).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng, d=2)}, EXACT


def _onehot(rng):
    def make(pkg):
        return _model(pkg, "models.feature.onehotencoder", "OneHotEncoderModel",
                      category_sizes=np.array([4, 3])
                      ).set_input_cols("a", "b").set_output_cols("oa", "ob")
    return make, {"a": rng.integers(0, 4, 9).astype(np.float32),
                  "b": rng.integers(0, 3, 9).astype(np.float32)}, EXACT


def _poly(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.polynomialexpansion").PolynomialExpansion().set_degree(3)
                .set_input_col("features").set_output_col("out"))
    return make, {"features": _mat(rng, d=3)}, EXACT


def _univariate_selector(rng):
    def make(pkg):
        return _model(pkg, "models.feature.univariatefeatureselector",
                      "UnivariateFeatureSelectorModel", indices=np.array([2, 0])
                      ).set_features_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, EXACT


def _variance_selector(rng):
    def make(pkg):
        return _model(pkg, "models.feature.variancethresholdselector",
                      "VarianceThresholdSelectorModel", indices=np.array([0, 3])
                      ).set_input_col("features").set_output_col("out")
    return make, {"features": _mat(rng)}, EXACT


def _vector_assembler(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.vectorassembler").VectorAssembler()
                .set_input_cols("va", "vb").set_output_col("out"))
    return make, {"va": _mat(rng, d=2), "vb": _mat(rng, d=3)}, EXACT


def _vector_slicer(rng):
    def make(pkg):
        return (_mod(pkg, "models.feature.vectorslicer").VectorSlicer().set_indices(3, 1)
                .set_input_col("features").set_output_col("out"))
    return make, {"features": _mat(rng)}, EXACT


def _linear(path, cls):
    def case(rng):
        coeff = rng.standard_normal(4)

        def make(pkg):
            return _model(pkg, path, cls, coefficient=coeff).set_features_col(
                "features").set_prediction_col("pred")
        return make, {"features": _mat(rng)}, RAW_TOL
    return case


def _kmeans(rng):
    centroids = rng.standard_normal((3, 4))

    def make(pkg):
        return _model(pkg, "models.clustering.kmeans", "KMeansModel", centroids=centroids,
                      weights=np.ones(3)).set_features_col("features").set_prediction_col("pred")
    return make, {"features": _mat(rng)}, EXACT


def _online_kmeans(rng):
    centroids = rng.standard_normal((3, 4))

    def make(pkg):
        m = _mod(pkg, "models.clustering.onlinekmeans").OnlineKMeansModel()
        m.publish_model_arrays((centroids, np.ones(3)), 2)
        return m.set_features_col("features").set_prediction_col("pred")
    return make, {"features": _mat(rng)}, EXACT


def _online_logistic_regression(rng):
    coeff = rng.standard_normal(4)

    def make(pkg):
        m = _mod(pkg, "models.classification.onlinelogisticregression"
                 ).OnlineLogisticRegressionModel()
        m.publish_model_arrays((coeff,), 3)
        return m.set_features_col("features").set_prediction_col("pred")
    return make, {"features": _mat(rng)}, RAW_TOL


STAGE_CASES = {
    "StandardScalerModel": _standard_scaler,
    "MinMaxScalerModel": _minmax_scaler,
    "MaxAbsScalerModel": _maxabs_scaler,
    "RobustScalerModel": _robust_scaler,
    "Normalizer": _normalizer,
    "Binarizer": _binarizer,
    "Bucketizer": _bucketizer,
    "DCT": _dct,
    "ElementwiseProduct": _elementwise_product,
    "IDFModel": _idf,
    "ImputerModel": _imputer,
    "Interaction": _interaction,
    "KBinsDiscretizerModel": _kbins,
    "OneHotEncoderModel": _onehot,
    "PolynomialExpansion": _poly,
    "UnivariateFeatureSelectorModel": _univariate_selector,
    "VarianceThresholdSelectorModel": _variance_selector,
    "VectorAssembler": _vector_assembler,
    "VectorSlicer": _vector_slicer,
    "LinearRegressionModel": _linear("models.regression.linearregression",
                                     "LinearRegressionModel"),
    "LogisticRegressionModel": _linear("models.classification.logisticregression",
                                       "LogisticRegressionModel"),
    "LinearSVCModel": _linear("models.classification.linearsvc", "LinearSVCModel"),
    "KMeansModel": _kmeans,
    "OnlineKMeansModel": _online_kmeans,
    "OnlineLogisticRegressionModel": _online_logistic_regression,
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _jax_table(cols):
    out = {}
    for name, col in cols.items():
        if isinstance(col, SparseBatch):
            out[name] = JaxSparseBatch(col.size, jax.device_put(col.indices.numpy()),
                                       jax.device_put(col.values.numpy()))
        else:
            out[name] = jax.device_put(col)
    return JaxTable(out)


def _port_table(cols):
    out = {}
    for name, col in cols.items():
        out[name] = col if isinstance(col, SparseBatch) else torch.from_numpy(np.array(col))
    return Table(out)


def _gauges(registry):
    return (registry.get_gauge("pipeline.fused_segments"),
            registry.get_gauge("pipeline.fused_stages"))


def _assert_identical(fused: Table, eager: Table):
    assert sorted(fused.column_names) == sorted(eager.column_names)
    for name in fused.column_names:
        a, b = fused.column(name), eager.column(name)
        if isinstance(a, SparseBatch) or isinstance(b, SparseBatch):
            assert isinstance(a, SparseBatch) and isinstance(b, SparseBatch), name
            assert a.size == b.size, name
            assert torch.equal(a.indices, b.indices) and torch.equal(a.values, b.values), name
            continue
        assert type(a) is type(b), name
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
            assert torch.equal(a, b) or bool(torch.all((a == b) | (a.isnan() & b.isnan()))), (
                f"column {name} differs between the fused and the eager path")


def _values(col):
    if isinstance(col, (SparseBatch, JaxSparseBatch)):
        return [np.asarray(col.indices), np.asarray(col.values, np.float64)]
    return [np.asarray(col, np.float64)]


def _assert_close_to_jax(port: Table, want, names, tol):
    for name in names:
        for g, w in zip(_values(port.column(name)), _values(want.column(name))):
            np.testing.assert_allclose(g.reshape(w.shape), w, **tol, err_msg=name)


def _run_both(stages, cols, expect_fused_stages=None):
    """Transform a tensor table through `stages` fused and eager; assert
    equal outputs. Returns (fused, eager)."""
    pm = PipelineModel(stages)
    fused = pm.transform(_port_table(cols))[0]
    if expect_fused_stages is not None:
        # the parity claim is empty if the plan fell back
        assert metrics.get_gauge("pipeline.fused_stages") == expect_fused_stages
    with config.pipeline_fusion_mode("off"):
        eager = pm.transform(_port_table(cols))[0]
    _assert_identical(fused, eager)
    return fused, eager


def _transform_syncs(fn):
    before = metrics.get_counter("iteration.host_sync.transform")
    fn()
    return metrics.get_counter("iteration.host_sync.transform") - before


# ---------------------------------------------------------------------------
# every stage with a kernel, alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_single_stage_fused_equals_eager_and_jax(name):
    make, cols, tol = STAGE_CASES[name](np.random.default_rng(sorted(STAGE_CASES).index(name)))
    want = JaxPipelineModel([make("flink_ml_tpu")]).transform(_jax_table(cols))[0]
    jax_gauges = _gauges(jax_metrics)
    fused, _ = _run_both([make("flink_ml_tpu_torch")], cols, expect_fused_stages=1)
    assert _gauges(metrics) == jax_gauges == (1, 1)
    produced = [n for n in want.column_names if n not in cols]
    assert produced and sorted(produced) == sorted(n for n in fused.column_names if n not in cols)
    _assert_close_to_jax(fused, want, produced, tol)


def _port_stage_classes():
    base = AlgoOperator
    for info in pkgutil.walk_packages(flink_ml_tpu_torch.__path__, "flink_ml_tpu_torch."):
        if ".native" in info.name or "_build" in info.name:
            continue
        module = importlib.import_module(info.name)
        for _, cls in inspect.getmembers(module, inspect.isclass):
            if issubclass(cls, base) and not inspect.isabstract(cls) and \
                    cls.__module__ == module.__name__:
                yield cls


def test_every_kernel_stage_is_covered():
    """The port's stages with a transform kernel are the JAX package's, by
    name, each with a parity case; every other stage declares why it
    does not fuse (the contract of scripts/check_fusion_coverage.py)."""
    spec = importlib.util.spec_from_file_location(
        "check_fusion_coverage", os.path.join(REPO, "scripts", "check_fusion_coverage.py"))
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    from flink_ml_tpu.api import AlgoOperator as JaxAlgoOperator

    jax_kernels = {c.__name__ for c in checker._iter_stage_classes()
                   if c.transform_kernel is not JaxAlgoOperator.transform_kernel}
    classes = list(_port_stage_classes())
    port_kernels = {c.__name__ for c in classes
                    if c.transform_kernel is not AlgoOperator.transform_kernel}
    assert port_kernels == jax_kernels and len(port_kernels) == 25
    assert port_kernels == set(STAGE_CASES)
    for cls in classes:
        declared = any("fusable" in k.__dict__ for k in cls.__mro__[:-1] if k is not AlgoOperator)
        assert declared, cls.__name__
        if cls.__name__ in port_kernels:
            assert cls.fusable, cls.__name__
        else:
            assert not cls.fusable and cls.fusable_reason.strip(), cls.__name__


def test_prefers_host_input_matches_jax():
    """Every concrete stage class of the JAX package has its port
    counterpart, with the same `prefers_host_input` placement hint (True
    on AgglomerativeClustering and FeatureHasher, the `Stage` default
    False elsewhere; ROADMAP C.38)."""
    from flink_ml_tpu.analysis.rules.coverage import _iter_operator_classes
    from flink_ml_tpu_torch.api import Stage

    assert Stage.prefers_host_input is False
    hosts = set()
    jax_classes = list(_iter_operator_classes("Stage"))
    assert len(jax_classes) > 50
    for jax_cls in jax_classes:
        module = importlib.import_module(
            jax_cls.__module__.replace("flink_ml_tpu", "flink_ml_tpu_torch", 1))
        port_cls = getattr(module, jax_cls.__name__)
        assert port_cls.prefers_host_input is jax_cls.prefers_host_input, jax_cls.__name__
        if port_cls.prefers_host_input:
            hosts.add(port_cls.__name__)
    assert hosts == {"AgglomerativeClustering", "FeatureHasher"}


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------

def test_sparse_input_fuses_and_matches_jax():
    """A sparse linear model keeps its SparseBatch on the device through
    the segment (the row-dot kernel's path on the card)."""
    rng = np.random.default_rng(11)
    coeff = rng.standard_normal(16)
    indices = rng.integers(-1, 18, (9, 3)).astype(np.int32)  # padding and idx >= d
    values = rng.random((9, 3)).astype(np.float32)
    models = []
    for pkg in ("flink_ml_tpu", "flink_ml_tpu_torch"):
        m = _model(pkg, "models.classification.logisticregression", "LogisticRegressionModel",
                   coefficient=coeff)
        models.append(m.set_features_col("features").set_prediction_col("pred"))
    batch = SparseBatch(16, torch.from_numpy(indices), torch.from_numpy(values))
    want = JaxPipelineModel([models[0]]).transform(_jax_table({"features": batch}))[0]
    assert _gauges(jax_metrics) == (1, 1)
    fused, _ = _run_both([models[1]], {"features": batch}, expect_fused_stages=1)
    _assert_close_to_jax(fused, want, ["pred", "rawPrediction"], RAW_TOL)


def _five_stage(pkg, rng_seed=3):
    """VectorAssembler (error) -> StandardScaler -> Normalizer -> Bucketizer
    (error) -> Binarizer: one segment, two guard stages."""
    rng = np.random.default_rng(rng_seed)
    ss = _model(pkg, "models.feature.standardscaler", "StandardScalerModel",
                mean=rng.standard_normal(5), std=np.abs(rng.standard_normal(5)) + 0.1)
    ss.set_input_col("assembled").set_output_col("scaled")
    stages = [
        _mod(pkg, "models.feature.vectorassembler").VectorAssembler()
        .set_input_cols("va", "vb").set_output_col("assembled"),
        ss,
        _mod(pkg, "models.feature.normalizer").Normalizer().set_p(2.0)
        .set_input_col("scaled").set_output_col("norm"),
        _mod(pkg, "models.feature.bucketizer").Bucketizer().set_input_cols("raw")
        .set_output_cols("bucket").set_splits_array([[-100.0, -1.0, 0.0, 1.0, 100.0]]),
        _mod(pkg, "models.feature.binarizer").Binarizer().set_input_cols("bucket")
        .set_output_cols("bin").set_thresholds(1.5),
    ]
    cols = {"va": _mat(rng, d=2), "vb": _mat(rng, d=3),
            "raw": rng.standard_normal(9).astype(np.float32)}
    return stages, cols


def test_five_stage_pipeline_one_segment_matches_jax():
    stages, cols = _five_stage("flink_ml_tpu_torch")
    want = JaxPipelineModel(_five_stage("flink_ml_tpu")[0]).transform(_jax_table(cols))[0]
    jax_gauges = _gauges(jax_metrics)
    fused, _ = _run_both(stages, cols, expect_fused_stages=5)
    assert _gauges(metrics) == jax_gauges == (1, 5)
    _assert_close_to_jax(fused, want, ["assembled", "bucket", "bin"], EXACT)
    _assert_close_to_jax(fused, want, ["scaled"], SCALER_TOL)
    _assert_close_to_jax(fused, want, ["norm"], NORMALIZER_TOL)


@pytest.mark.parametrize("fusion,expected", [("auto", 1), ("off", 2)])
def test_five_stage_sync_budget(fusion, expected):
    """One segment, one packed guard readback fused; one readback per guard
    stage eager."""
    stages, cols = _five_stage("flink_ml_tpu_torch")
    pm = PipelineModel(stages)
    table = _port_table(cols)
    with config.pipeline_fusion_mode(fusion):
        pm.transform(table)
        assert _transform_syncs(lambda: pm.transform(table)) == expected
    if fusion == "auto":
        assert _gauges(metrics) == (1, 5)


def test_guard_free_pipeline_is_sync_free():
    stages, _ = _five_stage("flink_ml_tpu_torch")
    pm = PipelineModel(stages[1:3])
    table = _port_table({"assembled": _mat(np.random.default_rng(4), d=5)})
    pm.transform(table)
    assert _transform_syncs(lambda: pm.transform(table)) == 0
    assert _gauges(metrics) == (1, 2)


def _chain(pkg):
    rng = np.random.default_rng(5)
    ss = _model(pkg, "models.feature.standardscaler", "StandardScalerModel",
                mean=rng.standard_normal(4), std=np.abs(rng.standard_normal(4)) + 0.1)
    return [
        ss.set_input_col("features").set_output_col("scaled"),
        _mod(pkg, "models.feature.normalizer").Normalizer().set_p(2.0)
        .set_input_col("scaled").set_output_col("norm"),
        _mod(pkg, "models.feature.vectorslicer").VectorSlicer().set_indices(0, 2)
        .set_input_col("norm").set_output_col("out"),
    ]


def test_chained_producer_consumer():
    """Columns made inside a segment feed the kernels after them."""
    cols = {"features": _mat(np.random.default_rng(6))}
    want = JaxPipelineModel(_chain("flink_ml_tpu")).transform(_jax_table(cols))[0]
    jax_gauges = _gauges(jax_metrics)
    fused, _ = _run_both(_chain("flink_ml_tpu_torch"), cols, expect_fused_stages=3)
    assert _gauges(metrics) == jax_gauges == (1, 3)
    _assert_close_to_jax(fused, want, ["out"], NORMALIZER_TOL)


def _mixed(pkg, table_cls, device_put):
    rng = np.random.default_rng(7)
    ss = _model(pkg, "models.feature.standardscaler", "StandardScalerModel",
                mean=rng.standard_normal(4), std=np.abs(rng.standard_normal(4)) + 0.1)
    stages = [
        ss.set_input_col("features").set_output_col("scaled"),
        _mod(pkg, "models.feature.tokenizer").Tokenizer().set_input_col("text")
        .set_output_col("tokens"),
        _mod(pkg, "models.feature.normalizer").Normalizer().set_p(2.0)
        .set_input_col("scaled").set_output_col("norm"),
    ]
    table = table_cls({"features": device_put(_mat(rng)),
                       "text": np.array(["a b c"] * 9, dtype=object)})
    return stages, table


def test_host_stage_breaks_the_segment():
    stages, table = _mixed("flink_ml_tpu_torch", Table, torch.from_numpy)
    jax_stages, jax_table = _mixed("flink_ml_tpu", JaxTable, jax.device_put)
    JaxPipelineModel(jax_stages).transform(jax_table)
    pm = PipelineModel(stages)
    fused = pm.transform(table)[0]
    assert _gauges(metrics) == _gauges(jax_metrics) == (2, 2)
    with config.pipeline_fusion_mode("off"):
        eager = pm.transform(table)[0]
    _assert_identical(fused, eager)


def test_host_input_runs_eagerly():
    make, cols, _ = _standard_scaler(np.random.default_rng(8))
    pm = PipelineModel([make("flink_ml_tpu_torch")])
    host = pm.transform(Table(dict(cols)))[0]
    JaxPipelineModel([make("flink_ml_tpu")]).transform(JaxTable(dict(cols)))
    assert _gauges(metrics) == _gauges(jax_metrics) == (0, 0)
    with config.pipeline_fusion_mode("off"):
        eager = pm.transform(Table(dict(cols)))[0]
    np.testing.assert_array_equal(host.column("out"), eager.column("out"))


#: stages whose host-column transform keeps a branch of its own beside the
#: kernel, as its result differs from the kernel's (api.py's docstring)
HOST_BRANCH = {"Binarizer", "Bucketizer", "MinMaxScalerModel", "OnlineLogisticRegressionModel"}


@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_host_input_runs_the_stage_kernel(name):
    """One code path per stage: a host table is staged to the device and
    runs the stage's own transform kernel, and the outputs come back as
    host arrays that match the JAX package's host path."""
    make, cols, tol = STAGE_CASES[name](np.random.default_rng(sorted(STAGE_CASES).index(name)))
    want = make("flink_ml_tpu").transform(JaxTable(dict(cols)))[0]
    stage = make("flink_ml_tpu_torch")
    calls = []
    kernel = stage.transform_kernel
    stage.transform_kernel = lambda *args: calls.append(1) or kernel(*args)
    got = stage.transform(Table(dict(cols)))[0]
    assert len(calls) == (0 if name in HOST_BRANCH else 1)
    produced = [n for n in want.column_names if n not in cols]
    for n in produced:
        col = got.column(n)
        leaves = [col.indices, col.values] if isinstance(col, SparseBatch) else [col]
        assert all(isinstance(leaf, np.ndarray) for leaf in leaves), n
    _assert_close_to_jax(got, want, produced, tol)


def test_graph_cache_evicts_least_recently_used():
    """The captured graphs of a segment: at most `kernel_cache_size`, and
    no more bytes kept than the card has free, least recently used first
    out; each eviction ticks jit.kernelCacheEvict."""
    cache = _GraphCache()
    evictions = metrics.get_counter("jit.kernelCacheEvict")
    with config.kernel_cache_limit(3):
        for sig in "abc":
            cache.make_room(free_bytes=1 << 40)
            cache.entries[sig] = types.SimpleNamespace(kept_bytes=100)
        assert list(cache.entries) == ["a", "b", "c"]
        assert cache.get("a") is not None and cache.get("z") is None
        cache.make_room(free_bytes=1 << 40)  # room for a fourth capture
        assert list(cache.entries) == ["c", "a"]
    cache.make_room(free_bytes=150)
    assert list(cache.entries) == ["a"]
    cache.make_room(free_bytes=100)
    assert list(cache.entries) == ["a"]
    cache.make_room(free_bytes=99)
    assert not cache.entries
    assert metrics.get_counter("jit.kernelCacheEvict") - evictions == 3


class _Recorder(Transformer):
    """A host stage that records each call."""

    fusable = False
    fusable_reason = "test stage: records its calls on the host"

    def __init__(self):
        self.calls = 0

    def transform(self, *inputs):
        self.calls += 1
        return [inputs[0]]


@pytest.mark.parametrize("fusion", ["auto", "off"])
def test_guard_error_same_message_before_later_eager_stage(fusion):
    """A failed check raises the eager path's message, read back before any
    later host stage runs."""
    def bucketizer(pkg):
        return (_mod(pkg, "models.feature.bucketizer").Bucketizer().set_input_cols("a")
                .set_output_cols("oa").set_splits_array([[0.0, 1.0, 2.0]]))

    cols = {"a": np.array([0.5, 1.5, 99.0], dtype=np.float32)}  # 99 out of range
    with pytest.raises(ValueError) as jax_error:
        JaxPipelineModel([bucketizer("flink_ml_tpu")]).transform(_jax_table(cols))
    recorder = _Recorder()
    pm = PipelineModel([bucketizer("flink_ml_tpu_torch"), recorder])
    with config.pipeline_fusion_mode(fusion):
        with pytest.raises(ValueError) as port_error:
            pm.transform(_port_table(cols))
    assert str(port_error.value) == str(jax_error.value)
    assert recorder.calls == 0


def test_param_change_rebuilds_the_plan():
    stage = (_mod("flink_ml_tpu_torch", "models.feature.binarizer").Binarizer()
             .set_input_cols("a").set_output_cols("oa").set_thresholds(0.0))
    cols = {"a": np.array([-1.0, 0.5, 2.0], dtype=np.float32)}
    pm = PipelineModel([stage])
    assert pm.transform(_port_table(cols))[0].column("oa").tolist() == [0.0, 1.0, 1.0]
    plan = pm._fusion_plan()
    stage.set_thresholds(1.0)
    assert pm.transform(_port_table(cols))[0].column("oa").tolist() == [0.0, 0.0, 1.0]
    assert pm._fusion_plan() is not plan


def test_model_array_change_rebuilds_the_plan():
    m = _model("flink_ml_tpu_torch", "models.feature.standardscaler", "StandardScalerModel",
               mean=np.zeros(2), std=np.ones(2))
    m.set_with_mean(True).set_with_std(True).set_input_col("f").set_output_col("o")
    cols = {"f": np.ones((3, 2), dtype=np.float32)}
    pm = PipelineModel([m])
    out1 = pm.transform(_port_table(cols))[0].column("o")
    plan = pm._fusion_plan()
    m.mean = np.ones(2)  # re-assigned, the model-update idiom
    out2 = pm.transform(_port_table(cols))[0].column("o")
    assert torch.all(out1 == 1.0) and torch.all(out2 == 0.0)
    assert pm._fusion_plan() is not plan


def test_swap_capable_publish_keeps_the_plan_and_stamps_the_version():
    rng = np.random.default_rng(9)
    m = _mod("flink_ml_tpu_torch", "models.classification.onlinelogisticregression"
             ).OnlineLogisticRegressionModel()
    m.publish_model_arrays((rng.standard_normal(4),), 1)
    m.set_features_col("features").set_prediction_col("pred")
    pm = PipelineModel([m])
    table = _port_table({"features": _mat(rng)})
    assert pm.transform(table)[0].column("modelVersion").tolist() == [1] * 9
    plan = pm._fusion_plan()
    for version in (2, 3):
        coeff = rng.standard_normal(4)
        m.publish_model_arrays((coeff,), version)
        out = pm.transform(table)[0]
        assert pm._fusion_plan() is plan and _gauges(metrics) == (1, 1)
        assert out.column("modelVersion").tolist() == [version] * 9
        dot = table.column("features") @ torch.from_numpy(coeff).float()
        assert torch.equal(out.column("pred"), torch.where(dot >= 0, 1.0, 0.0))


def test_baseline_and_text_pipelines_plan_no_fused_segment():
    """OneHotEncoder hands VectorAssembler SparseBatches and HashingTF hands
    IDF one: both packages veto those segments and run them eagerly."""
    rng = np.random.default_rng(10)
    X = _mat(rng, n=12, d=3)
    cat = rng.integers(0, 3, 12).astype(np.float32)
    vocab = np.asarray([f"t{i}" for i in range(20)])
    ids = rng.integers(0, 20, (12, 5)).astype(np.int32)
    idf, coeff = np.abs(rng.standard_normal(64)), rng.standard_normal(64)
    coeff_b = rng.standard_normal(5)  # 3 features and 3 categories less the dropped one
    for pkg, table_cls, put, tokens in (
            ("flink_ml_tpu", JaxTable, jax.device_put,
             lambda: JaxDictTokenMatrix(vocab, jax.device_put(ids))),
            ("flink_ml_tpu_torch", Table, lambda a: torch.from_numpy(np.array(a)),
             lambda: DictTokenMatrix(vocab, torch.from_numpy(ids.copy())))):
        registry = jax_metrics if pkg == "flink_ml_tpu" else metrics
        ss = _model(pkg, "models.feature.standardscaler", "StandardScalerModel",
                    mean=np.zeros(3), std=np.ones(3)).set_input_col("x").set_output_col("xs")
        ohe = _model(pkg, "models.feature.onehotencoder", "OneHotEncoderModel",
                     category_sizes=np.array([3])).set_input_cols("c").set_output_cols("cv")
        va = (_mod(pkg, "models.feature.vectorassembler").VectorAssembler()
              .set_input_cols("xs", "cv").set_output_col("features"))
        lr = _model(pkg, "models.classification.logisticregression", "LogisticRegressionModel",
                    coefficient=coeff_b).set_features_col("features")
        baseline = PipelineModel if pkg != "flink_ml_tpu" else JaxPipelineModel
        out = baseline([ss, ohe, va, lr]).transform(table_cls({"x": put(X), "c": put(cat)}))[0]
        assert _gauges(registry) == (0, 0), pkg
        assert out.column("prediction").shape == (12,)
        text = [
            _mod(pkg, "models.feature.stopwordsremover").StopWordsRemover()
            .set_input_cols("tokens").set_output_cols("words"),
            _mod(pkg, "models.feature.hashingtf").HashingTF().set_input_col("words")
            .set_output_col("tf").set_num_features(64),
            _model(pkg, "models.feature.idf", "IDFModel", idf=idf, doc_freq=np.ones(64),
                   num_docs=12).set_input_col("tf").set_output_col("features"),
            _model(pkg, "models.classification.logisticregression", "LogisticRegressionModel",
                   coefficient=coeff).set_features_col("features"),
        ]
        baseline(text).transform(table_cls({"tokens": tokens()}))
        assert _gauges(registry) == (0, 0), pkg


@pytest.mark.parametrize("scaled", [False, True], ids=["input", "produced"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bucketizer_float64_column_fuses_equal_to_eager(scaled, dtype):
    """0.1 has no float32 twin: a float32 column (or a column a kernel made
    from one) sends the segment to the eager path, as in the JAX package; a
    float64 column is the port's own and fuses, equal to eager."""
    rng = np.random.default_rng(12)
    bucketizer = (_mod("flink_ml_tpu_torch", "models.feature.bucketizer").Bucketizer()
                  .set_input_cols("b").set_output_cols("bucket")
                  .set_splits_array([[-10.0, 0.1, 0.2, 10.0]]))
    x = (rng.random(9) * 0.3).astype(dtype)
    stages = [bucketizer]
    if scaled:
        ss = _model("flink_ml_tpu_torch", "models.feature.standardscaler", "StandardScalerModel",
                    mean=np.zeros(1), std=np.ones(1)).set_input_col("x").set_output_col("b")
        stages = [ss, bucketizer]
        cols = {"x": x}
    else:
        cols = {"b": x}
    # the veto sends the whole segment to the eager path
    fused_stages = len(stages) if dtype == np.float64 else 0
    fused, _ = _run_both(stages, cols, expect_fused_stages=fused_stages)
    assert fused.column("bucket").dtype == torch.float32


def test_selector_keeps_the_gather_c10():
    """A NaN in a dropped column stays out of the kept columns through the
    fused selector (C.10: the JAX device path's 0/1 matmul spreads it)."""
    X = np.array([[0.0, np.nan, 2.0, 3.0], [1.0, 2.0, np.inf, 4.0]], dtype=np.float32)
    for name in ("VarianceThresholdSelectorModel", "UnivariateFeatureSelectorModel"):
        make, _, _ = STAGE_CASES[name](np.random.default_rng(0))
        stage = make("flink_ml_tpu_torch")
        stage.indices = np.array([0, 2])
        fused, _ = _run_both([stage], {"features": X}, expect_fused_stages=1)
        np.testing.assert_array_equal(fused.column("out").numpy(), X[:, [0, 2]])


def test_transform_deferred_leaves_guards_pending():
    stages, cols = _five_stage("flink_ml_tpu_torch")
    cols["va"][4, 1] = np.nan
    pm = PipelineModel(stages)
    before = metrics.get_counter("iteration.host_sync.transform")
    table, pending = pm.transform_deferred(_port_table(cols))
    assert metrics.get_counter("iteration.host_sync.transform") == before
    assert len(pending) == 1 and "assembled" in table.column_names
    with pytest.raises(ValueError, match="Encountered NaN while assembling"):
        _drain_guards(pending)
    assert metrics.get_counter("iteration.host_sync.transform") == before + 1
    assert not pending
    with config.pipeline_fusion_mode("off"):
        with pytest.raises(ValueError, match="Encountered NaN while assembling"):
            pm.transform(_port_table(cols))


def test_jax_fusion_default_is_auto():
    """The JAX side of every test here runs its default fused path."""
    assert jax_config.pipeline_fusion == "auto" and config.pipeline_fusion == "auto"
