"""UnivariateFeatureSelector and BinaryClassificationEvaluator of the port
against the JAX package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor).
Tolerances:

- UnivariateFeatureSelector: equal selections in every type combination
  and mode, on host and device columns, on data whose informative columns
  are clearly apart from the others; the same validation errors; the
  transform is a gather, exact (ROADMAP C.10);
- BinaryClassificationEvaluator (ROADMAP C.11: scores sorted as float32,
  every sum in float64): within 1e-12 of the JAX package's float64 oracle
  `_binary_metrics` fed the same float32 scores, on every input form,
  weighted or not, with ties; within the JAX package's own bounds of its
  float32 device path (2e-4 at 4,000 rows, 1e-3 at 500,000 rows with
  heavy ties, tests/test_stats_evaluation.py); the single-class AUC NaN.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import Stage as JaxStage
from flink_ml_tpu.linalg import DenseVector as JaxDenseVector
from flink_ml_tpu.models.evaluation import binaryclassification as jax_bce
from flink_ml_tpu.models.feature import univariatefeatureselector as jax_ufs
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
from flink_ml_tpu_torch import DenseVector, SparseBatch, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.evaluation import binaryclassification as port_bce
from flink_ml_tpu_torch.models.feature import univariatefeatureselector as port_ufs

ORACLE_TOL = 1e-12
ALL_METRICS = ("areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz")


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


# -- UnivariateFeatureSelector ---------------------------------------------------

#: (featureType, labelType) -> the test the selector runs
COMBINATIONS = [("categorical", "categorical"), ("continuous", "categorical"),
                ("continuous", "continuous")]
#: a threshold of each mode that cuts between the informative columns and
#: the noise columns of `_selector_data`
MODES = {"numTopFeatures": 4, "percentile": 0.34, "fpr": 0.01, "fdr": 0.02, "fwe": 0.05}
D, INFORMATIVE = 12, (1, 4, 6, 9)


def _selector_data(feature_type, label_type, seed=0, n=3_000):
    """D columns, INFORMATIVE of them tied to the label (p-values far below
    any threshold), the others independent of it; float32-exact values."""
    rng = np.random.default_rng(seed)
    if label_type == "categorical":
        y = rng.integers(0, 3, n).astype(np.float64)
    else:
        y = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    if feature_type == "categorical":
        X = rng.integers(0, 4, (n, D)).astype(np.float64)
        for j in INFORMATIVE:
            X[:, j] = np.where(rng.random(n) < 0.5, y, X[:, j])
    else:
        X = rng.standard_normal((n, D))
        for j in INFORMATIVE:
            X[:, j] += 0.5 * y
    return X.astype(np.float32).astype(np.float64), y


def _selectors(feature_type, label_type, mode, threshold):
    return [m.UnivariateFeatureSelector().set_feature_type(feature_type)
            .set_label_type(label_type).set_selection_mode(mode)
            .set_selection_threshold(threshold).set_output_col("selected")
            for m in (jax_ufs, port_ufs)]


def _tables(X, y, layout):
    if layout == "host":
        return JaxTable({"features": X, "label": y}), Table({"features": X, "label": y})
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    return (JaxTable({"features": jax.device_put(X32), "label": jax.device_put(y32)}),
            Table({"features": torch.from_numpy(X32), "label": torch.from_numpy(y32)}))


@pytest.mark.parametrize("layout", ["host", "device"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("types", COMBINATIONS, ids=lambda t: "-".join(t))
def test_selector_selects_as_jax(types, mode, layout):
    X, y = _selector_data(*types)
    jax_table, port_table = _tables(X, y, layout)
    jax_sel, port_sel = _selectors(*types, mode, MODES[mode])
    want = jax_sel.fit(jax_table).indices
    got = port_sel.fit(port_table).indices
    np.testing.assert_array_equal(got, want)
    assert list(got) == list(INFORMATIVE)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_selector_default_thresholds_are_jax_s(mode):
    X, y = _selector_data("continuous", "categorical", seed=1)
    jax_table, port_table = _tables(X, y, "device")
    jax_sel, port_sel = (m.UnivariateFeatureSelector().set_feature_type("continuous")
                         .set_label_type("categorical").set_selection_mode(mode)
                         for m in (jax_ufs, port_ufs))
    np.testing.assert_array_equal(port_sel.fit(port_table).indices,
                                  jax_sel.fit(jax_table).indices)
    assert port_ufs._DEFAULT_THRESHOLDS == jax_ufs._DEFAULT_THRESHOLDS


def _fdr_boundaries():
    """p-value vectors on the FDR boundary: p_(k) exactly (alpha/d)*k
    (strictly not below it), one ulp below, and ties."""
    out = []
    for d in (3, 7, 10, 49):
        for alpha in (0.05, 0.1, 0.3):
            edge = (alpha / d) * np.arange(1, d + 1)
            out.append((edge, alpha))
            out.append((np.nextafter(edge, 0.0), alpha))
            out.append((np.where(np.arange(d) % 2 == 0, edge, 0.9)[::-1].copy(), alpha))
            other = (np.arange(1, d + 1) / d) * alpha  # the other operand order
            out.append((other, alpha))
    out.append((np.full(5, 0.01), 0.05))
    return out


@pytest.mark.parametrize("case", range(len(_fdr_boundaries())))
def test_fdr_on_boundary_p_values_is_jax_s(case):
    p, alpha = _fdr_boundaries()[case]
    np.testing.assert_array_equal(
        port_ufs.select_indices_from_p_values(p, "fdr", alpha),
        jax_ufs.select_indices_from_p_values(p, "fdr", alpha))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_select_indices_on_ties_is_jax_s(mode):
    p = np.asarray([0.5, 0.001, 0.5, 0.001, 0.02, 0.0, 0.3, 0.02])
    np.testing.assert_array_equal(port_ufs.select_indices_from_p_values(p, mode, MODES[mode]),
                                  jax_ufs.select_indices_from_p_values(p, mode, MODES[mode]))


@pytest.mark.parametrize("mode,threshold", [
    ("numTopFeatures", 0.5), ("numTopFeatures", 2.5), ("numTopFeatures", 0.0),
    ("numTopFeatures", -3.0), ("percentile", 1.5), ("fpr", -0.1), ("fdr", 2.0), ("fwe", 1.01)])
def test_selector_threshold_validation_is_jax_s(mode, threshold):
    X, y = _selector_data("continuous", "categorical")
    jax_table, port_table = _tables(X, y, "host")
    jax_sel, port_sel = _selectors("continuous", "categorical", mode, threshold)
    with pytest.raises(ValueError) as want:
        jax_sel.fit(jax_table)
    with pytest.raises(ValueError) as got:
        port_sel.fit(port_table)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("types", [(None, "categorical"), ("continuous", None),
                                   ("categorical", "continuous")], ids=str)
def test_selector_type_errors_are_jax_s(types):
    X, y = _selector_data("continuous", "continuous")
    jax_table, port_table = _tables(X, y, "host")
    messages = []
    for m, table in ((jax_ufs, jax_table), (port_ufs, port_table)):
        sel = m.UnivariateFeatureSelector()
        if types[0]:
            sel.set_feature_type(types[0])
        if types[1]:
            sel.set_label_type(types[1])
        with pytest.raises(ValueError) as err:
            sel.fit(table)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("layout", ["host", "device"])
def test_selector_transform_matches_jax(layout):
    X, y = _selector_data("continuous", "categorical", seed=2)
    jax_table, port_table = _tables(X, y, layout)
    jax_sel, port_sel = _selectors("continuous", "categorical", "numTopFeatures", 4)
    got = port_sel.fit(port_table).transform(port_table)[0].column("selected")
    want = jax_sel.fit(jax_table).transform(jax_table)[0].column("selected")
    assert isinstance(got, torch.Tensor) == (layout == "device")
    np.testing.assert_array_equal(got.numpy() if layout == "device" else got, np.asarray(want))


def test_selector_gathers_where_the_jax_device_matmul_spreads_nan():
    """C.10: a NaN or inf in a dropped column stays out of the row."""
    X = np.asarray([[0.0, np.inf, 2.0, 3.0], [np.nan, 1.0, 5.0, -1.0]], np.float32)
    models = []
    for m in (jax_ufs, port_ufs):
        model = m.UnivariateFeatureSelectorModel().set_output_col("o")
        model.indices = np.asarray([1, 2, 3])
        models.append(model)
    got = models[1].transform(Table({"features": torch.from_numpy(X)}))[0].column("o")
    np.testing.assert_array_equal(got.numpy(), X[:, [1, 2, 3]])
    jax_dev = np.asarray(models[0].transform(JaxTable({"features": jax.device_put(X)}))[0].column("o"))
    assert np.isnan(jax_dev[1]).all() and np.isfinite(got.numpy()[1]).all()
    jax_host = models[0].transform(JaxTable({"features": X}))[0].column("o")
    np.testing.assert_array_equal(got.numpy(), jax_host)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_selector_model_loads_across_packages(tmp_path, direction):
    X, y = _selector_data("categorical", "categorical", seed=3)
    jax_table, port_table = _tables(X, y, "host")
    jax_sel, port_sel = _selectors("categorical", "categorical", "fpr", 0.01)
    path = str(tmp_path / "m")
    if direction == "jax_to_port":
        jax_sel.fit(jax_table).save(path)
        loaded = Stage.load(path)
        assert type(loaded) is port_ufs.UnivariateFeatureSelectorModel
    else:
        port_sel.fit(port_table).save(path)
        loaded = jax_ufs.UnivariateFeatureSelectorModel.load(path)
    np.testing.assert_array_equal(loaded.indices, INFORMATIVE)
    assert loaded.get_output_col() == "selected"
    fresh = port_ufs.UnivariateFeatureSelectorModel().set_model_data(*loaded.get_model_data())
    np.testing.assert_array_equal(fresh.indices, INFORMATIVE)


# -- BinaryClassificationEvaluator ---------------------------------------------------

FORMS = ["tensor_matrix", "host_matrix", "dense_vectors", "scores", "tensor_scores", "sparse"]


def _eval_data(seed=5, n=4_000, tie_levels=None, weighted=False):
    rng = np.random.default_rng(seed)
    scores = rng.random(n)
    if tie_levels is not None:
        scores = np.round(scores * tie_levels) / tie_levels
    labels = (rng.random(n) < scores).astype(np.float64)
    weights = rng.random(n) + 0.1 if weighted else None
    return scores, labels, weights


def _raw_columns(form, scores):
    """The rawPrediction column of a form, for (JAX, port)."""
    raw = np.stack([1 - scores, scores], axis=1)
    if form == "tensor_matrix":
        raw32 = raw.astype(np.float32)
        return jax.device_put(raw32), torch.from_numpy(raw32)
    if form == "host_matrix":
        return raw, raw.copy()
    if form == "dense_vectors":
        return [JaxDenseVector(r) for r in raw], [DenseVector(r) for r in raw]
    if form == "scores":
        return scores, scores.copy()
    if form == "tensor_scores":
        return jax.device_put(scores.astype(np.float32)), torch.from_numpy(scores.astype(np.float32))
    idx = np.tile(np.arange(2, dtype=np.int32), (scores.size, 1))
    return JaxSparseBatch(2, idx, raw), SparseBatch(2, idx, raw)


def _evaluate(module, table_cls, label, raw, weights, metrics=ALL_METRICS):
    cols = {"label": label, "rawPrediction": raw}
    ev = module.BinaryClassificationEvaluator().set_metrics_names(*metrics)
    if weights is not None:
        cols["w"] = weights
        ev.set_weight_col("w")
    row = ev.transform(table_cls(cols))[0].collect()[0]
    return {k: float(v) for k, v in row.items()}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tie_levels", [None, 7, 2])
@pytest.mark.parametrize("form", FORMS)
def test_evaluator_matches_the_float64_oracle_and_jax(form, tie_levels, weighted):
    scores, labels, weights = _eval_data(tie_levels=tie_levels, weighted=weighted)
    jax_raw, port_raw = _raw_columns(form, scores)
    got = _evaluate(port_bce, Table, labels, port_raw, weights)
    want_jax = _evaluate(jax_bce, JaxTable, labels, jax_raw, weights)
    s32 = scores.astype(np.float32).astype(np.float64)  # the float32 tie groups
    oracle = jax_bce._binary_metrics(s32, labels, np.ones_like(labels) if weights is None else weights)
    for name in ALL_METRICS:
        assert abs(got[name] - oracle[name]) < ORACLE_TOL, (name, got[name], oracle[name])
        assert abs(got[name] - want_jax[name]) < 2e-4, (name, got[name], want_jax[name])


@pytest.mark.parametrize("weighted", [False, True])
def test_evaluator_tensor_labels_and_weights(weighted):
    scores, labels, weights = _eval_data(seed=6, tie_levels=11, weighted=weighted)
    raw = torch.from_numpy(np.stack([1 - scores, scores], axis=1).astype(np.float32))
    cols = {"label": torch.from_numpy(labels.astype(np.float32)), "rawPrediction": raw}
    ev = port_bce.BinaryClassificationEvaluator().set_metrics_names(*ALL_METRICS)
    if weighted:
        cols["w"] = torch.from_numpy(weights.astype(np.float32))
        ev.set_weight_col("w")
    got = ev.transform(Table(cols))[0].collect()[0]
    w = np.ones_like(labels) if weights is None else weights.astype(np.float32).astype(np.float64)
    oracle = jax_bce._binary_metrics(scores.astype(np.float32).astype(np.float64), labels, w)
    for name in ALL_METRICS:
        assert abs(got[name] - oracle[name]) < ORACLE_TOL


def test_evaluator_plain_version_is_the_jax_oracle():
    for tie_levels in (None, 3):
        scores, labels, weights = _eval_data(seed=7, tie_levels=tie_levels, weighted=True)
        assert port_bce.binary_metrics(scores, labels, weights) == \
            jax_bce._binary_metrics(scores, labels, weights)


def test_evaluator_c11_float64_sums_at_large_n():
    """C.11: at 500,000 rows with ~1,000 tie groups the port stays within
    1e-12 of the float64 oracle, where the JAX float32 pass is held only
    to 1e-3; the two agree within that bound."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n = 500_000
    scores = np.round(rng.random(n) * 1000) / 1000
    labels = (rng.random(n) < scores).astype(np.float64)
    weights = rng.random(n) + 0.1
    oracle = jax_bce._binary_metrics(scores.astype(np.float32).astype(np.float64), labels, weights)
    got = port_bce.binary_metrics_device(torch.from_numpy(scores), torch.from_numpy(labels),
                                         torch.from_numpy(weights)).numpy()
    jax_dev = np.asarray(jax_bce._binary_metrics_device(
        jnp.asarray(scores, jnp.float32), jnp.asarray(labels, jnp.float32),
        jnp.asarray(weights, jnp.float32)))
    for i, name in enumerate(port_bce.METRICS):
        assert abs(got[i] - oracle[name]) < ORACLE_TOL, (name, got[i], oracle[name])
        assert abs(got[i] - jax_dev[i]) < 1e-3, (name, got[i], jax_dev[i])


@pytest.mark.parametrize("labels", [[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]])
def test_evaluator_single_class_auc_is_nan(labels):
    t = Table({"label": np.asarray(labels), "rawPrediction": np.asarray([0.3, 0.7, 0.5])})
    row = port_bce.BinaryClassificationEvaluator().set_metrics_names(*ALL_METRICS) \
        .transform(t)[0].collect()[0]
    assert np.isnan(row["areaUnderROC"])
    want = jax_bce.BinaryClassificationEvaluator().set_metrics_names(*ALL_METRICS).transform(
        JaxTable({"label": np.asarray(labels), "rawPrediction": np.asarray([0.3, 0.7, 0.5])}))[0]
    for name in ALL_METRICS[1:]:
        assert row[name] == pytest.approx(float(want.collect()[0][name]), abs=1e-6)


@pytest.mark.parametrize("layout", ["tensor", "host"])
def test_evaluator_needs_two_raw_columns(layout):
    raw = np.ones((4, 1), np.float32)
    t = Table({"label": np.ones(4), "rawPrediction": torch.from_numpy(raw) if layout == "tensor" else raw})
    with pytest.raises(IndexError):
        port_bce.BinaryClassificationEvaluator().transform(t)


def test_evaluator_ragged_vector_column_raises_as_jax():
    raws = [np.asarray([0.2, 0.8]), np.asarray([0.4, 0.5, 0.1])]
    for module, vec, table_cls in ((jax_bce, JaxDenseVector, JaxTable), (port_bce, DenseVector, Table)):
        t = table_cls({"label": np.ones(2), "rawPrediction": [vec(r) for r in raws]})
        with pytest.raises(ValueError):
            module.BinaryClassificationEvaluator().transform(t)


def test_evaluator_reference_values_and_params():
    """BinaryClassificationEvaluatorTest.java EXPECTED_DATA_M and _W."""
    labels = [1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    scores = [0.9, 0.9, 0.9, 0.75, 0.6, 0.9, 0.9, 0.4, 0.3, 0.9, 0.2, 0.1]
    weights = [0.8, 0.7, 0.5, 1.2, 1.3, 1.5, 1.4, 0.3, 0.5, 1.9, 1.2, 1.0]
    raw = [DenseVector([1 - s, s]) for s in scores]
    ev = port_bce.BinaryClassificationEvaluator()
    assert ev.get_metrics_names() == ["areaUnderROC", "areaUnderPR"]
    out = ev.set_metrics_names(*ALL_METRICS).transform(Table({"label": labels, "rawPrediction": raw}))[0]
    assert out.column_names == list(ALL_METRICS)
    row = out.collect()[0]
    for name, want in zip(("areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz"),
                          (0.8571428571428571, 0.9377705627705628, 0.8571428571428571,
                           0.6488095238095237)):
        assert abs(row[name] - want) < 1e-12
    row = ev.set_weight_col("weight").transform(
        Table({"label": labels, "rawPrediction": raw, "weight": weights}))[0].collect()[0]
    assert abs(row["areaUnderROC"] - 0.8911680911680911) < 1e-12
    with pytest.raises(ValueError):
        port_bce.BinaryClassificationEvaluator().set_metrics_names("nope")


def test_selector_load_without_the_npz_container_names_a15(tmp_path):
    X, y = _selector_data("continuous", "categorical", seed=4)
    _, port_table = _tables(X, y, "host")
    _selectors("continuous", "categorical", "fwe", 0.05)[1].fit(port_table).save(str(tmp_path / "m"))
    data = tmp_path / "m" / "data"
    (data / "model_data.npz").rename(data / "part-0")
    # the reference's binary model data is read now (A.15): an npz is no such part file
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        Stage.load(str(tmp_path / "m"))
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        JaxStage.load(str(tmp_path / "m"))
