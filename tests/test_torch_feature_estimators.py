"""The port's feature estimators against the JAX package.

MaxAbsScaler, MinMaxScaler, VarianceThresholdSelector, VectorIndexer,
KBinsDiscretizer, RobustScaler and Imputer in flink_ml_tpu_torch get the
same seeded numpy inputs as flink_ml_tpu's, as a host float64 column and
as a float32 device column (`jax.Array` against a float32 torch tensor);
the JAX side on a one-device mesh, the port under
`config.use_device("cpu")`. Each model's fit, transform, save/load in both
directions, a mixed Pipeline the JAX package saved, and the StreamTable
fits of Imputer, KBinsDiscretizer and RobustScaler.

Tolerances: equal for the order statistics and selections (max, min,
kept indices, category maps, bin edges, quantiles, medians, modes) and
for transforms both sides compute with the same IEEE operations (the
MinMax device transform is one fused multiply-add on both: XLA contracts
it, the port calls torch.addcmul); float32 variance and Imputer device
mean rtol 1e-6 (float32 sums in another order); the Imputer host mean
rtol 1e-12 (float64 sums in another order); the stream fits equal (the
same numpy sketch on both sides).
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Pipeline as JaxPipeline
from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.feature import imputer as jax_imp
from flink_ml_tpu.models.feature import kbinsdiscretizer as jax_kb
from flink_ml_tpu.models.feature import maxabsscaler as jax_mas
from flink_ml_tpu.models.feature import minmaxscaler as jax_mms
from flink_ml_tpu.models.feature import robustscaler as jax_rs
from flink_ml_tpu.models.feature import variancethresholdselector as jax_vts
from flink_ml_tpu.models.feature import vectorassembler as jax_va
from flink_ml_tpu.models.feature import vectorindexer as jax_vi
from flink_ml_tpu.models.feature import vectorslicer as jax_vs
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import PipelineModel, StreamTable, Table, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.feature import imputer as port_imp
from flink_ml_tpu_torch.models.feature import kbinsdiscretizer as port_kb
from flink_ml_tpu_torch.models.feature import maxabsscaler as port_mas
from flink_ml_tpu_torch.models.feature import minmaxscaler as port_mms
from flink_ml_tpu_torch.models.feature import robustscaler as port_rs
from flink_ml_tpu_torch.models.feature import variancethresholdselector as port_vts
from flink_ml_tpu_torch.models.feature import vectorindexer as port_vi

FORMS = ["host64", "device32"]
SUM_TOL = dict(rtol=1e-6, atol=0)
HOST_MEAN_TOL = dict(rtol=1e-12, atol=0)


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _tables(form, columns):
    if form == "host64":
        cols = {k: np.asarray(v, np.float64) for k, v in columns.items()}
        return JaxTable(dict(cols)), Table(dict(cols))
    cols = {k: np.asarray(v, np.float32) for k, v in columns.items()}
    return (JaxTable({k: jax.device_put(v) for k, v in cols.items()}),
            Table({k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


def _host(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


def _pair(jax_module, port_module, cls, **params):
    pair = []
    for module in (jax_module, port_module):
        stage = getattr(module, cls)()
        for name, value in params.items():
            setter = getattr(stage, f"set_{name}")
            setter(*value) if isinstance(value, tuple) else setter(value)
        pair.append(stage)
    return pair


def _fit_both(pair, form, columns):
    jax_est, port_est = pair
    jax_table, port_table = _tables(form, columns)
    return jax_est.fit(jax_table), port_est.fit(port_table), jax_table, port_table


def _transform_both(jax_model, port_model, jax_table, port_table, form, out="o"):
    jax_out = jax_model.transform(jax_table)[0]
    port_out = port_model.transform(port_table)[0]
    got = port_out.column(out)
    assert isinstance(got, np.ndarray if form == "host64" else torch.Tensor)
    assert port_out.num_rows == jax_out.num_rows
    return np.asarray(jax_out.column(out), np.float64), _host(got).astype(np.float64)


def _data(seed=0, n=3000, d=6):
    return np.random.default_rng(seed).random((n, d))


# -- MaxAbsScaler -----------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_maxabsscaler_matches_jax(both_on_one_device, form):
    X = _data(1) * 4 - 3
    X[:, 2] = 0.0  # a zero maxAbs leaves the feature as it is
    jm, pm, jt, pt = _fit_both(_pair(jax_mas, port_mas, "MaxAbsScaler", input_col="v",
                                     output_col="o"), form, {"v": X})
    np.testing.assert_array_equal(pm.max_abs, np.asarray(jm.max_abs))
    assert pm.max_abs[2] == 0.0
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)


# -- MinMaxScaler -----------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 5.0)])
def test_minmaxscaler_matches_jax(both_on_one_device, form, lo, hi):
    X = _data(2) * 10 - 4
    X[:, 3] = 1.5  # constant: the middle of the range
    jm, pm, jt, pt = _fit_both(_pair(jax_mms, port_mms, "MinMaxScaler", input_col="v",
                                     output_col="o", min=lo, max=hi), form, {"v": X})
    np.testing.assert_array_equal(pm.min_vector, np.asarray(jm.min_vector))
    np.testing.assert_array_equal(pm.max_vector, np.asarray(jm.max_vector))
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:, 3] == (lo + hi) / 2)


def test_minmaxscaler_device_transform_is_one_rounding(both_on_one_device):
    """The tensor path's X * scale + offset rounds once (addcmul), as XLA's
    contracted multiply-add does; two roundings differ on some rows."""
    X = _data(3, n=20000, d=4).astype(np.float32)
    model = port_mms.MinMaxScaler().set_input_col("v").set_output_col("o").fit(
        Table({"v": torch.from_numpy(X)}))
    got = model.transform(Table({"v": torch.from_numpy(X)}))[0].column("o").numpy()
    scale, offset = (c.astype(np.float32) for c in model.scale_offset())
    fused = (X.astype(np.float64) * scale + offset).astype(np.float32)
    np.testing.assert_array_equal(got, fused)
    assert not np.array_equal(got, X * scale + offset)


# -- VarianceThresholdSelector ------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_variancethresholdselector_matches_jax(both_on_one_device, form, threshold):
    X = _data(4) * np.array([1.0, 0.1, 2.0, 0.5, 0.0, 1.0])
    X[:, 4] = 3.0  # zero variance
    jm, pm, jt, pt = _fit_both(_pair(jax_vts, port_vts, "VarianceThresholdSelector", input_col="v",
                                     output_col="o", variance_threshold=threshold), form, {"v": X})
    np.testing.assert_array_equal(pm.indices, np.asarray(jm.indices))
    assert 4 not in pm.indices
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)


def test_sample_variance_matches_jax(both_on_one_device):
    X = (_data(5) * 3).astype(np.float32)
    want = np.asarray(jax_vts._sample_variance(jax.device_put(X)))
    got = port_vts.sample_variance(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, **SUM_TOL)


# -- VectorIndexer ------------------------------------------------------------------

def _indexer_data(seed=6, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.random((n, 5))
    X[:, 1] = rng.integers(0, 4, n)  # 4 categories, with 0
    X[:, 3] = rng.integers(1, 8, n) * 0.5  # 7 categories, no 0
    X[:, 4] = rng.integers(0, 30, n)  # 30 values: continuous at maxCategories 20
    return X


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("handle", ["keep", "skip", "error"])
def test_vectorindexer_matches_jax(both_on_one_device, form, handle):
    X = _indexer_data()
    jm, pm, jt, pt = _fit_both(_pair(jax_vi, port_vi, "VectorIndexer", input_col="v", output_col="o",
                                     handle_invalid=handle, max_categories=20), form, {"v": X})
    assert pm.category_maps == jm.category_maps
    assert sorted(pm.category_maps) == [1, 3]
    assert pm.category_maps[1][0.0] == 0
    test = _indexer_data(seed=7, n=500)
    test[:4, 1] = [9.0, 2.0, 5.0, 1.0]  # 9 and 5 unseen
    jt, pt = _tables(form, {"v": test})
    if handle == "error":
        for model, table in ((jm, jt), (pm, pt)):
            with pytest.raises(ValueError, match="unseen value: 9.0"):
                model.transform(table)
        return
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == (500 if handle == "keep" else 498)


@pytest.mark.parametrize("form", FORMS)
def test_vectorindexer_continuous_columns_give_an_empty_model(both_on_one_device, form):
    X = _data(8, d=4)
    jm, pm, jt, pt = _fit_both(_pair(jax_vi, port_vi, "VectorIndexer", input_col="v", output_col="o",
                                     handle_invalid="skip"), form, {"v": X})
    assert pm.category_maps == jm.category_maps == {}
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_vectorindexer_counts_nan_as_the_jax_path_counts_it(both_on_one_device, form):
    """The JAX package is inconsistent here (ROADMAP C.5): its host path
    counts every NaN as one value (np.unique), its device path each NaN
    apart. The port follows each path: with 3 values and 20 NaNs at
    maxCategories 5 the host column is categorical (NaN a key that never
    matches) and the tensor column continuous."""
    X = np.zeros((40, 2))
    X[:, 0] = np.arange(40) % 3
    X[:20, 0] = np.nan
    X[:, 1] = np.arange(40)
    jm, pm, jt, pt = _fit_both(_pair(jax_vi, port_vi, "VectorIndexer", input_col="v", output_col="o",
                                     max_categories=5, handle_invalid="keep"), form, {"v": X})
    assert sorted(pm.category_maps) == sorted(jm.category_maps) == ([0] if form == "host64" else [])
    for j in pm.category_maps:
        np.testing.assert_array_equal(sorted(pm.category_maps[j], key=pm.category_maps[j].get),
                                      sorted(jm.category_maps[j], key=jm.category_maps[j].get))
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)


# -- KBinsDiscretizer ---------------------------------------------------------------

def _kbins_data(seed=9, n=3000):
    X = _data(seed, n=n, d=4)
    X[:, 1] = X[:, 1] ** 3  # skewed
    X[:, 3] = 0.25  # constant: <= 2 edges, bin 0
    return X


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
@pytest.mark.parametrize("sub_samples", [200000, 1000])
def test_kbins_matches_jax(both_on_one_device, form, strategy, sub_samples):
    """With subSamples under the row count both packages keep the rows of
    RandomState(0).choice, so even uniform's min and max agree."""
    X = _kbins_data()
    jm, pm, jt, pt = _fit_both(_pair(jax_kb, port_kb, "KBinsDiscretizer", input_col="v",
                                     output_col="o", strategy=strategy, num_bins=5,
                                     sub_samples=sub_samples), form, {"v": X})
    assert len(pm.bin_edges) == len(jm.bin_edges) == 4
    for got_e, want_e in zip(pm.bin_edges, jm.bin_edges):
        np.testing.assert_array_equal(got_e, np.asarray(want_e))
    assert pm.bin_edges[3].size <= 2
    test = _kbins_data(seed=10, n=500) * 1.2 - 0.1  # some values outside the edges
    jt, pt = _tables(form, {"v": test})
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)
    assert not got[:, 3].any()


@pytest.mark.parametrize("form", FORMS)
def test_kbins_nan_goes_to_the_top_bin(both_on_one_device, form):
    """TestDeviceEdgeSemantics.test_kbins_nan_bins_like_host's rule, in the port."""
    train = {"v": np.asarray([[0.0], [0.5], [1.0]])}
    jm, pm, _, _ = _fit_both(_pair(jax_kb, port_kb, "KBinsDiscretizer", input_col="v",
                                   output_col="o", strategy="uniform", num_bins=2), form, train)
    jt, pt = _tables(form, {"v": np.asarray([[0.25], [np.nan], [0.75], [2.0], [-1.0]])})
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [0, 1, 1, 1, 0])


def test_kbins_nan_edge_never_counts_below_a_value():
    """ROADMAP C.8: a NaN edge is not <= x, whatever the search path; the
    top bin still counts it (np.searchsorted sorts NaN last)."""
    edges = np.array([0.0, 0.25, 0.5, 0.75, np.nan])
    x = np.array([0.1, 0.3, 0.6, 0.8, 5.0])
    got = port_kb.bin_all(torch.from_numpy(x[:, None]), [edges])[:, 0].numpy()
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 3])
    want = np.clip(np.searchsorted(edges, x, side="right") - 1, 0, edges.size - 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_kbins_quantile_fit_over_an_infinite_value_bins_as_jax(both_on_one_device, form):
    """ROADMAP C.8: a quantile fit over a column holding +inf gives a NaN
    last edge (inf - inf), on both sides; the bins still agree."""
    X = _data(31, n=200, d=4)
    X[17, 2] = np.inf
    jm, pm, jt, pt = _fit_both(_pair(jax_kb, port_kb, "KBinsDiscretizer", input_col="v",
                                     output_col="o", strategy="quantile", num_bins=4),
                               form, {"v": X})
    for got_e, want_e in zip(pm.bin_edges, jm.bin_edges):
        np.testing.assert_array_equal(got_e, np.asarray(want_e))
    assert np.isnan(pm.bin_edges[2][-1])
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
def test_kbins_constant_column_collapses_to_bin_0(both_on_one_device, form, strategy):
    """A constant feature keeps at most 2 edges, and the transform puts
    every value of it, inside or outside, in bin 0 (KBinsDiscretizer.java:63-64)."""
    X = _data(17, n=500, d=2)
    X[:, 1] = 0.75
    jm, pm, _, _ = _fit_both(_pair(jax_kb, port_kb, "KBinsDiscretizer", input_col="v",
                                   output_col="o", strategy=strategy), form, {"v": X})
    assert pm.bin_edges[1].size <= 2
    np.testing.assert_array_equal(pm.bin_edges[1], np.asarray(jm.bin_edges[1]))
    jt, pt = _tables(form, {"v": np.array([[0.5, 0.75], [0.5, -3.0], [0.5, 9.0], [0.5, np.nan]])})
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 1], 0.0)


def test_kbins_subsample_rows_are_the_jax_draw():
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(port_kb.subsample_rows(5000, 300).numpy(),
                                  rng.choice(5000, size=300, replace=False))


# -- RobustScaler -------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("centering,scaling", [(True, True), (False, True), (True, False)])
def test_robustscaler_matches_jax(both_on_one_device, form, centering, scaling):
    X = _data(11) * np.array([1.0, 5.0, 0.1, 2.0, 1.0, 3.0])
    X[:, 4] = 2.0  # zero range: scaled by 1
    jm, pm, jt, pt = _fit_both(_pair(jax_rs, port_rs, "RobustScaler", input_col="v", output_col="o",
                                     with_centering=centering, with_scaling=scaling, lower=0.1,
                                     upper=0.8), form, {"v": X})
    np.testing.assert_array_equal(pm.medians, np.asarray(jm.medians))
    np.testing.assert_array_equal(pm.ranges, np.asarray(jm.ranges))
    assert pm.ranges[4] == 0.0
    want, got = _transform_both(jm, pm, jt, pt, form)
    np.testing.assert_array_equal(got, want)


# -- Imputer ------------------------------------------------------------------------

def _imputer_data(seed=12, n=3000, missing=np.nan):
    """Integer values in [0, 100), many ties, with 5% missing."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name in ("a", "b", "c"):
        v = rng.integers(0, 100, n).astype(np.float64)
        v[rng.random(n) < 0.05] = missing
        cols[name] = v
    cols["c"][rng.random(n) < 0.02] = np.nan  # NaN is left out of the fit always
    return cols


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("strategy", ["mean", "median", "most_frequent"])
@pytest.mark.parametrize("missing", [np.nan, -1.0])
def test_imputer_matches_jax(both_on_one_device, form, strategy, missing):
    columns = _imputer_data(missing=missing)
    pair = _pair(jax_imp, port_imp, "Imputer", input_cols=("a", "b", "c"),
                 output_cols=("oa", "ob", "oc"), strategy=strategy, missing_value=missing)
    jm, pm, jt, pt = _fit_both(pair, form, columns)
    assert list(pm.surrogates) == list(jm.surrogates) == ["a", "b", "c"]
    want = np.array([jm.surrogates[k] for k in "abc"])
    got = np.array([pm.surrogates[k] for k in "abc"])
    if strategy == "mean":
        np.testing.assert_allclose(got, want, **(HOST_MEAN_TOL if form == "host64" else SUM_TOL))
        pm.surrogates = dict(jm.surrogates)  # the transform's own check, on equal surrogates
    else:
        np.testing.assert_array_equal(got, want)
    for out in ("oa", "ob", "oc"):
        w, g = _transform_both(jm, pm, jt, pt, form, out)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", FORMS)
def test_imputer_most_frequent_takes_the_smallest_of_ties(both_on_one_device, form):
    a = np.array([5.0, 3.0, 5.0, 3.0, np.nan, 7.0, 1.0])
    pair = _pair(jax_imp, port_imp, "Imputer", input_cols=("a",), output_cols=("o",),
                 strategy="most_frequent")
    jm, pm, _, _ = _fit_both(pair, form, {"a": a})
    assert pm.surrogates["a"] == jm.surrogates["a"] == 3.0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("strategy", ["mean", "median", "most_frequent"])
def test_imputer_column_with_no_valid_value_raises(both_on_one_device, form, strategy):
    columns = {"a": np.array([1.0, 2.0, np.nan]), "b": np.array([np.nan, -1.0, np.nan])}
    for module in (jax_imp, port_imp):
        est = module.Imputer().set_input_cols("a", "b").set_output_cols("x", "y") \
            .set_strategy(strategy).set_missing_value(-1.0)
        jt, pt = _tables(form, columns)
        with pytest.raises(ValueError, match="Column b has no valid values"):
            est.fit(jt if module is jax_imp else pt)


def test_imputer_host_mean_over_an_infinite_value_is_infinite(both_on_one_device):
    """ROADMAP C.9: the JAX host path raises only on a column with no valid
    value, so a host column holding +inf imputes inf."""
    a = np.array([1.0, np.inf, np.nan, 2.0])
    pair = _pair(jax_imp, port_imp, "Imputer", input_cols=("a",), output_cols=("o",))
    jm, pm, jt, pt = _fit_both(pair, "host64", {"a": a})
    assert jm.surrogates["a"] == pm.surrogates["a"] == np.inf
    want, got = _transform_both(jm, pm, jt, pt, "host64")
    np.testing.assert_array_equal(got, want)


def test_imputer_device_mean_over_an_infinite_value_raises(both_on_one_device):
    """ROADMAP C.9: a float32 tensor holding +inf raises, as the jax.Array
    does (the device path reads a non-finite sum as no valid value)."""
    a = np.array([1.0, np.inf, np.nan, 2.0])
    jt, pt = _tables("device32", {"a": a})
    for module, table in ((jax_imp, jt), (port_imp, pt)):
        est = module.Imputer().set_input_cols("a").set_output_cols("o")
        with pytest.raises(ValueError, match="Column a has no valid values"):
            est.fit(table)


def test_selector_gathers_where_the_jax_device_matmul_spreads_nan(both_on_one_device):
    """ROADMAP C.10: the JAX device selection is a 0/1 matmul, so a NaN in
    a dropped column reaches every output column of its row; the port
    gathers the kept columns and returns their values."""
    X = _data(41, n=300, d=5)
    X[:, 1] = 0.5  # constant: dropped by its zero variance
    jt, pt = _tables("device32", {"v": X})
    jm, pm = (est.fit(t) for est, t in zip(
        _pair(jax_vts, port_vts, "VarianceThresholdSelector", input_col="v",
              output_col="o", variance_threshold=0.01), (jt, pt)))
    kept = list(pm.indices)
    assert kept == [int(i) for i in jm.indices] and 1 not in kept
    test = X[:4].astype(np.float32)
    test[2, 1] = np.nan
    jt, pt = _tables("device32", {"v": test})
    want_jax = np.asarray(jm.transform(jt)[0].column("o"))
    got = pm.transform(pt)[0].column("o").numpy()
    np.testing.assert_array_equal(got, test[:, kept])
    assert np.isnan(want_jax[2]).all()
    np.testing.assert_array_equal(np.delete(want_jax, 2, axis=0), np.delete(got, 2, axis=0))


# -- save and load across packages ----------------------------------------------------

def _estimators():
    """(JAX estimator, port estimator, columns) of each estimator."""
    X = _indexer_data(seed=13, n=400)
    cols = _imputer_data(seed=14, n=400)
    cols["v"] = X
    return [
        _pair(jax_mas, port_mas, "MaxAbsScaler", input_col="v", output_col="o"),
        _pair(jax_mms, port_mms, "MinMaxScaler", input_col="v", output_col="o", min=-1.0, max=2.0),
        _pair(jax_vts, port_vts, "VarianceThresholdSelector", input_col="v", output_col="o",
              variance_threshold=0.1),
        _pair(jax_vi, port_vi, "VectorIndexer", input_col="v", output_col="o", handle_invalid="keep"),
        _pair(jax_kb, port_kb, "KBinsDiscretizer", input_col="v", output_col="o", num_bins=4),
        _pair(jax_rs, port_rs, "RobustScaler", input_col="v", output_col="o", with_centering=True),
        _pair(jax_imp, port_imp, "Imputer", input_cols=("a", "b"), output_cols=("o", "ob"),
              strategy="median"),
    ], cols


@pytest.mark.parametrize("index", range(7))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_save_load_across_packages(both_on_one_device, tmp_path, index, direction):
    pairs, cols = _estimators()
    jax_est, port_est = pairs[index]
    path = str(tmp_path / "model")
    if direction == "jax_to_port":
        model = jax_est.fit(JaxTable(dict(cols)))
        model.save(path)
        loaded = Stage.load(path)
        assert type(loaded).__module__.startswith("flink_ml_tpu_torch.")
        want = model.transform(JaxTable(dict(cols)))[0].column("o")
        got = loaded.transform(Table(dict(cols)))[0].column("o")
    else:
        model = port_est.fit(Table(dict(cols)))
        model.save(path)
        loaded = type(jax_est.fit(JaxTable(dict(cols)))).load(path)
        want = model.transform(Table(dict(cols)))[0].column("o")
        got = loaded.transform(JaxTable(dict(cols)))[0].column("o")
    np.testing.assert_array_equal(np.asarray(got, np.float64), np.asarray(want, np.float64))
    # the model data crosses as the JAX model's get_model_data rows
    port_model = loaded if direction == "jax_to_port" else model
    fresh = type(port_model)().set_model_data(*port_model.get_model_data())
    for p in port_model.get_param_map():
        fresh.set(p, port_model.get(p))
    np.testing.assert_array_equal(
        np.asarray(fresh.transform(Table(dict(cols)))[0].column("o"), np.float64),
        np.asarray(want, np.float64))


def _port_model_data(jax_table):
    """The JAX model's get_model_data() rows as a port Table: vectors as the
    port's DenseVector, lists and maps as they are."""
    from flink_ml_tpu_torch import DenseVector

    rows = jax_table.collect()
    return Table({name: [DenseVector(np.asarray(r[name].to_array())) if hasattr(r[name], "to_array")
                         else r[name] for r in rows] for name in jax_table.column_names})


@pytest.mark.parametrize("index", range(7))
def test_set_model_data_takes_the_jax_model_rows(both_on_one_device, index):
    pairs, cols = _estimators()
    jax_est, port_est = pairs[index]
    jax_model = jax_est.fit(JaxTable(dict(cols)))
    port_model = type(port_est.fit(Table(dict(cols))))()
    for p in port_est.get_param_map():
        if port_model.get_param(p.name) is not None:
            port_model.set(port_model.get_param(p.name), port_est.get(p))
    port_model.set_model_data(*[_port_model_data(t) for t in jax_model.get_model_data()])
    np.testing.assert_array_equal(
        np.asarray(port_model.transform(Table(dict(cols)))[0].column("o"), np.float64),
        np.asarray(jax_model.transform(JaxTable(dict(cols)))[0].column("o"), np.float64))


# -- a Pipeline saved by the JAX package ----------------------------------------------

def test_pipeline_of_new_stages_loads_from_jax(both_on_one_device, tmp_path):
    """Imputer -> VectorAssembler -> MinMaxScaler -> VectorSlicer ->
    LogisticRegression, fitted and saved by the JAX package, loads in the
    port by class name and predicts the same."""
    rng = np.random.default_rng(16)
    n = 600
    a, b, c = (rng.random(n) * 4 for _ in range(3))
    y = (a - b + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    a[rng.random(n) < 0.05] = np.nan
    cols = {"a": a, "b": b, "c": c, "label": y}
    pipeline = JaxPipeline([
        jax_imp.Imputer().set_input_cols("a", "b", "c").set_output_cols("ia", "ib", "ic"),
        jax_va.VectorAssembler().set_input_cols("ia", "ib", "ic").set_output_col("raw"),
        jax_mms.MinMaxScaler().set_input_col("raw").set_output_col("scaled"),
        jax_vs.VectorSlicer().set_input_col("scaled").set_output_col("features").set_indices(0, 1),
        jax_lr.LogisticRegression().set_max_iter(30).set_global_batch_size(64),
    ])
    model = pipeline.fit(JaxTable(dict(cols)))
    path = str(tmp_path / "pm")
    model.save(path)
    loaded = PipelineModel.load(path)
    assert [type(s).__name__ for s in loaded.stages] == [
        "ImputerModel", "VectorAssembler", "MinMaxScalerModel", "VectorSlicer",
        "LogisticRegressionModel"]
    want = model.transform(JaxTable(dict(cols)))[0]
    got = loaded.transform(Table(dict(cols)))[0]
    np.testing.assert_array_equal(got.column("features"), np.asarray(want.column("features")))
    np.testing.assert_allclose(got.column("rawPrediction"), np.asarray(want.column("rawPrediction")),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.column("prediction"), np.asarray(want.column("prediction")))
    assert (np.asarray(got.column("prediction")) == y).mean() > 0.75


# -- the StreamTable fits ---------------------------------------------------------------

def _streams(columns, parts):
    """The same host chunks as a JAX and a port StreamTable."""
    n = len(next(iter(columns.values())))
    splits = np.array_split(np.arange(n), parts)
    return (JaxStreamTable.from_batches([JaxTable({k: v[s] for k, v in columns.items()}) for s in splits]),
            StreamTable.from_batches([Table({k: v[s] for k, v in columns.items()}) for s in splits]))


@pytest.mark.parametrize("strategy", ["mean", "median", "most_frequent"])
def test_imputer_stream_fit_equals_jax(both_on_one_device, strategy):
    columns = _imputer_data(seed=17, n=60_000)
    jax_s, port_s = _streams(columns, 7)
    jax_est, port_est = _pair(jax_imp, port_imp, "Imputer", input_cols=("a", "b", "c"),
                              output_cols=("x", "y", "z"), strategy=strategy)
    assert port_est.fit(port_s).surrogates == jax_est.fit(jax_s).surrogates


@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
def test_kbins_stream_fit_equals_jax(both_on_one_device, strategy):
    X = _kbins_data(seed=18, n=30_000)
    jax_s, port_s = _streams({"v": X}, 6)
    jax_est, port_est = _pair(jax_kb, port_kb, "KBinsDiscretizer", input_col="v", output_col="o",
                              strategy=strategy, num_bins=5, sub_samples=4000)
    jm, pm = jax_est.fit(jax_s), port_est.fit(port_s)
    for got_e, want_e in zip(pm.bin_edges, jm.bin_edges):
        np.testing.assert_array_equal(got_e, np.asarray(want_e))


def test_robustscaler_stream_fit_equals_jax(both_on_one_device):
    X = np.random.default_rng(19).normal(size=(80_000, 3)) * np.array([1.0, 5.0, 0.1])
    jax_s, port_s = _streams({"v": X}, 9)
    jax_est, port_est = _pair(jax_rs, port_rs, "RobustScaler", input_col="v", output_col="o",
                              relative_error=0.005)
    jm, pm = jax_est.fit(jax_s), port_est.fit(port_s)
    np.testing.assert_array_equal(pm.medians, jm.medians)
    np.testing.assert_array_equal(pm.ranges, jm.ranges)


def test_stream_fits_stay_within_the_rank_error(both_on_one_device):
    """The sketch's promise: each stream quantile lies within relativeError
    * n ranks of the exact one."""
    X = np.random.default_rng(20).random((50_000, 2))
    _, port_s = _streams({"v": X}, 5)
    eps = 0.002
    model = port_rs.RobustScaler().set_input_col("v").set_relative_error(eps) \
        .set_with_centering(True).fit(port_s)
    for j in range(2):
        rank = np.searchsorted(np.sort(X[:, j]), model.medians[j])
        assert abs(rank - 0.5 * len(X)) <= eps * len(X) + 1
