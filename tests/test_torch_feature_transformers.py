"""The port's feature transformers against the JAX package.

Binarizer, VectorSlicer, ElementwiseProduct, Normalizer, Interaction,
PolynomialExpansion, DCT and Bucketizer in flink_ml_tpu_torch get the same
seeded numpy inputs as flink_ml_tpu's, in two forms: a host float64
column (the JAX host path against the port's staged float64 tensor) and a
float32 device column (a `jax.Array` against a float32 torch tensor). The
JAX side runs on a one-device mesh, the port under
`config.use_device("cpu")`.

Tolerances: equal where the result is a comparison or a selection
(Binarizer, VectorSlicer, Bucketizer) and where both sides do the same
IEEE operations in the same order (ElementwiseProduct, Interaction,
PolynomialExpansion); Normalizer rtol 1e-6 (a float32 row sum in another
order, a pow); DCT rtol 1e-5, atol 1e-6 (a float32 matrix product in
another order).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.linalg import Vectors as JaxVectors
from flink_ml_tpu.models.feature import binarizer as jax_bin
from flink_ml_tpu.models.feature import bucketizer as jax_buck
from flink_ml_tpu.models.feature import dct as jax_dct
from flink_ml_tpu.models.feature import elementwiseproduct as jax_ep
from flink_ml_tpu.models.feature import interaction as jax_inter
from flink_ml_tpu.models.feature import normalizer as jax_norm
from flink_ml_tpu.models.feature import polynomialexpansion as jax_poly
from flink_ml_tpu.models.feature import vectorslicer as jax_vs
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import SparseBatch, Table, Vectors, config
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.feature import binarizer as port_bin
from flink_ml_tpu_torch.models.feature import bucketizer as port_buck
from flink_ml_tpu_torch.models.feature import dct as port_dct
from flink_ml_tpu_torch.models.feature import elementwiseproduct as port_ep
from flink_ml_tpu_torch.models.feature import interaction as port_inter
from flink_ml_tpu_torch.models.feature import normalizer as port_norm
from flink_ml_tpu_torch.models.feature import polynomialexpansion as port_poly
from flink_ml_tpu_torch.models.feature import vectorslicer as port_vs

FORMS = ["host64", "device32"]
NORMALIZER_TOL = dict(rtol=1e-6, atol=1e-7)
DCT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _tables(form, columns):
    """(JAX table, port table) of the same numpy columns: float64 host
    arrays, or float32 device arrays on each side."""
    if form == "host64":
        cols = {k: np.asarray(v, np.float64) for k, v in columns.items()}
        return JaxTable(dict(cols)), Table(dict(cols))
    cols = {k: np.asarray(v, np.float32) for k, v in columns.items()}
    return (JaxTable({k: jax.device_put(v) for k, v in cols.items()}),
            Table({k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


def _host(col):
    if isinstance(col, torch.Tensor):
        return col.numpy()
    return np.asarray(col)


def _check_form(form, port_out):
    """A host column comes back as numpy, a tensor column as a tensor."""
    if form == "host64":
        assert isinstance(port_out, np.ndarray)
    else:
        assert isinstance(port_out, torch.Tensor)


def _pair(jax_module, port_module, cls, **params):
    pair = []
    for module in (jax_module, port_module):
        stage = getattr(module, cls)()
        for name, value in params.items():
            setter = getattr(stage, f"set_{name}")
            setter(*value) if isinstance(value, tuple) else setter(value)
        pair.append(stage)
    return pair


def _outputs(pair, form, columns, out_cols):
    jax_stage, port_stage = pair
    jax_table, port_table = _tables(form, columns)
    jax_out = jax_stage.transform(jax_table)[0]
    port_out = port_stage.transform(port_table)[0]
    assert port_out.num_rows == jax_out.num_rows
    for name in out_cols:
        _check_form(form, port_out.column(name))
    return ([np.asarray(jax_out.column(n), np.float64) for n in out_cols],
            [_host(port_out.column(n)).astype(np.float64) for n in out_cols])


def _data(seed=0, n=2000, d=5):
    return np.random.default_rng(seed).random((n, d))


# -- Binarizer ------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_binarizer_matches_jax(both_on_one_device, form):
    X = _data(1)
    X[:7, 1] = 0.3  # on the threshold: not above it
    columns = {f"f{j}": X[:, j] for j in range(5)}
    columns["v"] = X
    thresholds = (0.5, 0.3, 0.3, 0.6, 0.8, 0.4)
    pair = _pair(jax_bin, port_bin, "Binarizer", input_cols=("f0", "f1", "f2", "f3", "f4", "v"),
                 output_cols=("o0", "o1", "o2", "o3", "o4", "ov"), thresholds=thresholds)
    want, got = _outputs(pair, form, columns, ["o0", "o1", "o2", "o3", "o4", "ov"])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_binarizer_tensor_gives_float32_host_gives_float64(both_on_one_device):
    X = _data(2, n=50, d=1)[:, 0]
    stage = port_bin.Binarizer().set_input_cols("x").set_output_cols("o").set_thresholds(0.5)
    host = stage.transform(Table({"x": X}))[0].column("o")
    dev = stage.transform(Table({"x": torch.from_numpy(X).float()}))[0].column("o")
    assert host.dtype == np.float64 and dev.dtype == torch.float32


def test_binarizer_compares_against_the_threshold_in_the_column_dtype(both_on_one_device):
    """0.3 has no float32 twin: float32(0.3) is above 0.3, so a float32 0.3
    is not above the threshold once the threshold is cast to float32, as
    the JAX device path casts it."""
    x = np.full(4, np.float32(0.3))
    jax_stage, port_stage = _pair(jax_bin, port_bin, "Binarizer", input_cols=("x",),
                                  output_cols=("o",), thresholds=(0.3,))
    got = port_stage.transform(Table({"x": torch.from_numpy(x)}))[0].column("o").numpy()
    want = np.asarray(jax_stage.transform(JaxTable({"x": jax.device_put(x)}))[0].column("o"))
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_binarizer_sparse_stays_sparse(both_on_one_device):
    idx = np.array([[0, 2, -1], [1, -1, -1]], np.int32)
    vals = np.array([[0.9, 0.1, 0.0], [0.6, 0.0, 0.0]])
    jax_stage, port_stage = _pair(jax_bin, port_bin, "Binarizer", input_cols=("s",),
                                  output_cols=("o",), thresholds=(0.5,))
    want = jax_stage.transform(JaxTable({"s": JaxSparseBatch(3, idx, vals)}))[0].column("o")
    got = port_stage.transform(Table({"s": SparseBatch(3, idx, vals)}))[0].column("o")
    assert isinstance(got, SparseBatch)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    dev = port_stage.transform(Table({"s": SparseBatch(
        3, torch.from_numpy(idx), torch.from_numpy(vals).float())}))[0].column("o")
    assert isinstance(dev.values, torch.Tensor)
    np.testing.assert_array_equal(dev.values.numpy(), want.values)


def test_binarizer_threshold_count_must_match(both_on_one_device):
    stage = port_bin.Binarizer().set_input_cols("a", "b").set_output_cols("x", "y").set_thresholds(0.5)
    with pytest.raises(ValueError, match="number of thresholds"):
        stage.transform(Table({"a": np.ones(3), "b": np.ones(3)}))


# -- VectorSlicer ---------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("indices", [(1, 3, 5, 7), (9, 0), (4,)])
def test_vectorslicer_matches_jax(both_on_one_device, form, indices):
    pair = _pair(jax_vs, port_vs, "VectorSlicer", input_col="v", output_col="o", indices=indices)
    (want,), (got,) = _outputs(pair, form, {"v": _data(3, d=10)}, ["o"])
    np.testing.assert_array_equal(got, want)


def test_vectorslicer_index_out_of_range(both_on_one_device):
    stage = port_vs.VectorSlicer().set_input_col("v").set_output_col("o").set_indices(1, 10)
    with pytest.raises(ValueError, match="out of range"):
        stage.transform(Table({"v": _data(4, n=10, d=10)}))
    with pytest.raises(ValueError):
        port_vs.VectorSlicer().set_indices(1, 1)


# -- ElementwiseProduct -----------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_elementwiseproduct_matches_jax(both_on_one_device, form):
    jax_stage = jax_ep.ElementwiseProduct().set_input_col("v").set_output_col("o") \
        .set_scaling_vec(JaxVectors.dense(1.0, 2.0, 3.0, 4.0, 5.0))
    port_stage = port_ep.ElementwiseProduct().set_input_col("v").set_output_col("o") \
        .set_scaling_vec(Vectors.dense(1.0, 2.0, 3.0, 4.0, 5.0))
    (want,), (got,) = _outputs((jax_stage, port_stage), form, {"v": _data(5) * 3 - 1}, ["o"])
    np.testing.assert_array_equal(got, want)


def test_elementwiseproduct_sparse_and_size_check(both_on_one_device):
    idx = np.array([[0, 2, -1], [1, -1, -1]], np.int32)
    vals = np.array([[1.5, 2.0, 0.0], [3.0, 0.0, 0.0]])
    jax_stage = jax_ep.ElementwiseProduct().set_input_col("s").set_output_col("o") \
        .set_scaling_vec(JaxVectors.dense(2.0, 3.0, 4.0))
    port_stage = port_ep.ElementwiseProduct().set_input_col("s").set_output_col("o") \
        .set_scaling_vec(Vectors.dense(2.0, 3.0, 4.0))
    want = jax_stage.transform(JaxTable({"s": JaxSparseBatch(3, idx, vals)}))[0].column("o")
    got = port_stage.transform(Table({"s": SparseBatch(3, idx, vals)}))[0].column("o")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    with pytest.raises(ValueError, match="scalingVec size"):
        port_stage.transform(Table({"s": np.ones((4, 2))}))


def test_elementwiseproduct_scaling_vec_param_round_trips_json(both_on_one_device):
    stage = port_ep.ElementwiseProduct().set_scaling_vec(Vectors.sparse(4, [1, 3], [2.0, 5.0]))
    param = stage.SCALING_VEC
    back = param.json_decode(json.loads(json.dumps(param.json_encode(stage.get_scaling_vec()))))
    assert back == stage.get_scaling_vec()
    # the conf files' form: values with no type is a dense vector
    assert param.json_decode({"values": [1.0, 2.0]}) == Vectors.dense(1.0, 2.0)


# -- Normalizer -----------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_normalizer_matches_jax(both_on_one_device, form, p):
    X = _data(6) * 2 - 1
    X[3] = 0.0  # a zero row stays zero (the norm is floored at 1e-30)
    pair = _pair(jax_norm, port_norm, "Normalizer", input_col="v", output_col="o", p=p)
    (want,), (got,) = _outputs(pair, form, {"v": X}, ["o"])
    np.testing.assert_allclose(got, want, **NORMALIZER_TOL)
    assert not got[3].any()


def test_normalizer_computes_in_float32_on_either_column(both_on_one_device):
    """The JAX package casts a host column to float32 (jnp.asarray); so does
    the port, and both give float32."""
    stage = port_norm.Normalizer().set_input_col("v").set_output_col("o")
    out = stage.transform(Table({"v": _data(7, n=10)}))[0].column("o")
    assert out.dtype == np.float32


# -- Interaction ----------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_interaction_matches_jax(both_on_one_device, form):
    X = _data(8, d=6)
    columns = {"num": X[:, 0], "a": X[:, 1:3], "b": X[:, 3:6]}
    pair = _pair(jax_inter, port_inter, "Interaction", input_cols=("num", "a", "b"), output_col="o")
    (want,), (got,) = _outputs(pair, form, columns, ["o"])
    assert got.shape == (2000, 6)
    np.testing.assert_array_equal(got, want)


def test_interaction_of_host_and_tensor_columns_is_host(both_on_one_device):
    X = _data(9, n=20, d=4)
    stage = port_inter.Interaction().set_input_cols("a", "b").set_output_col("o")
    out = stage.transform(Table({"a": X[:, :2], "b": torch.from_numpy(X[:, 2:].astype(np.float32))}))[0].column("o")
    want = np.asarray(jax_inter.Interaction().set_input_cols("a", "b").set_output_col("o").transform(
        JaxTable({"a": X[:, :2], "b": jax.device_put(X[:, 2:].astype(np.float32))}))[0].column("o"))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, want)


# -- PolynomialExpansion --------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("degree,d", [(1, 4), (2, 5), (3, 3)])
def test_polynomialexpansion_matches_jax(both_on_one_device, form, degree, d):
    pair = _pair(jax_poly, port_poly, "PolynomialExpansion", input_col="v", output_col="o",
                 degree=degree)
    (want,), (got,) = _outputs(pair, form, {"v": _data(10, d=d) * 4 - 2}, ["o"])
    from math import comb

    assert got.shape[1] == comb(d + degree, degree) - 1
    np.testing.assert_array_equal(got, want)


def test_polynomialexpansion_reference_order(both_on_one_device):
    """[a, b] at degree 2 is [a, a^2, b, ab, b^2], the reference's recursion."""
    stage = port_poly.PolynomialExpansion().set_input_col("v").set_output_col("o")
    out = stage.transform(Table({"v": np.array([[2.0, 3.0]])}))[0].column("o")
    np.testing.assert_array_equal(out, [[2.0, 4.0, 3.0, 6.0, 9.0]])


# -- DCT ------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("inverse", [False, True])
def test_dct_matches_jax(both_on_one_device, form, inverse):
    pair = _pair(jax_dct, port_dct, "DCT", input_col="v", output_col="o", inverse=inverse)
    (want,), (got,) = _outputs(pair, form, {"v": _data(11, d=16)}, ["o"])
    np.testing.assert_allclose(got, want, **DCT_TOL)


def test_dct_inverse_undoes_forward_and_leaves_tf32_setting(both_on_one_device):
    X = _data(12, n=50, d=8)
    fwd = port_dct.DCT().set_input_col("v").set_output_col("f")
    inv = port_dct.DCT().set_input_col("f").set_output_col("o").set_inverse(True)
    out = inv.transform(fwd.transform(Table({"v": X}))[0])[0].column("o")
    np.testing.assert_allclose(out, X, rtol=1e-5, atol=1e-5)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with port_dct.full_float32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def test_dct_basis_is_orthonormal():
    B = port_dct.dct_basis(12)
    np.testing.assert_allclose(B @ B.T, np.eye(12), atol=1e-12)
    np.testing.assert_array_equal(B, jax_dct._dct_basis(12))


# -- Bucketizer -----------------------------------------------------------------

SPLITS = [[0.0, 0.25, 0.5, 0.75, 1.0], [-1.0, 0.0, 0.5, 2.0]]


def _bucket_data(seed=13, n=2000):
    rng = np.random.default_rng(seed)
    a = rng.random(n) * 1.2 - 0.1  # some rows below 0 and above 1
    b = rng.random(n) * 4 - 2
    a[:5] = [0.0, 0.25, 1.0, 0.75, 0.5]  # on the splits; 1.0 is the closed last bucket
    b[5:9] = [-1.0, 2.0, 0.0, 0.5]
    return {"a": a, "b": b}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("handle", ["keep", "skip"])
def test_bucketizer_matches_jax(both_on_one_device, form, handle):
    columns = _bucket_data()
    columns["a"][20] = np.nan
    pair = _pair(jax_buck, port_buck, "Bucketizer", input_cols=("a", "b"), output_cols=("oa", "ob"),
                 splits_array=SPLITS, handle_invalid=handle)
    want, got = _outputs(pair, form, columns, ["oa", "ob"])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    if handle == "keep":
        assert got[0][20] == 4.0 and got[0][2] == 3.0  # NaN -> the extra bucket; 1.0 -> last


@pytest.mark.parametrize("form", FORMS)
def test_bucketizer_error_rule(both_on_one_device, form):
    columns = _bucket_data()
    for module in (jax_buck, port_buck):
        stage = module.Bucketizer().set_input_cols("a", "b").set_output_cols("oa", "ob") \
            .set_splits_array(SPLITS)
        jax_table, port_table = _tables(form, columns)
        with pytest.raises(ValueError, match="invalid value"):
            stage.transform(jax_table if module is jax_buck else port_table)
    inside = {"a": np.clip(columns["a"], 0, 1), "b": np.clip(columns["b"], -1, 2)}
    pair = _pair(jax_buck, port_buck, "Bucketizer", input_cols=("a", "b"), output_cols=("oa", "ob"),
                 splits_array=SPLITS)
    want, got = _outputs(pair, form, inside, ["oa", "ob"])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", FORMS)
def test_bucketizer_last_bucket_is_right_closed(both_on_one_device, form):
    """A value on a split opens its bucket; the last split closes the last
    bucket rather than opening an invalid one (Bucketizer.java findBucket)."""
    x = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 0.9999])
    pair = _pair(jax_buck, port_buck, "Bucketizer", input_cols=("x",), output_cols=("o",),
                 splits_array=[SPLITS[0]])
    (want,), (got,) = _outputs(pair, form, {"x": x}, ["o"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 3, 3])


def test_bucketizer_splits_without_float32_twin_take_float64_on_the_device(both_on_one_device):
    """The port rule: a tensor column whose splits do not survive its dtype
    is compared on its device in float64; the JAX package pulls that column
    to the host and compares in float64. Same buckets."""
    splits = [0.0, 0.1, 0.7, 1.0]
    assert not port_buck.splits_survive(np.asarray(splits), torch.float32)
    assert port_buck.splits_survive(np.asarray(SPLITS[0]), torch.float32)
    x = np.array([np.float32(0.7), np.float32(0.1), 0.05, 0.5, 0.8, 1.0], np.float32)
    # float32(0.7) lies below 0.7: with the splits cast to float32 it would
    # fall into bucket 2, not 1
    jax_stage, port_stage = _pair(jax_buck, port_buck, "Bucketizer", input_cols=("x",),
                                  output_cols=("o",), splits_array=[splits])
    want = np.asarray(jax_stage.transform(JaxTable({"x": jax.device_put(x)}))[0].column("o"))
    got = port_stage.transform(Table({"x": torch.from_numpy(x)}))[0].column("o")
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [1, 1, 0, 1, 2, 2])
    cast = port_buck.bucketize(torch.from_numpy(x), torch.tensor(splits, dtype=torch.float32))[0]
    assert not torch.equal(cast.float(), got)


def test_bucketizer_rejects_bad_splits():
    with pytest.raises(ValueError, match="strictly increasing"):
        port_buck.Bucketizer().set_splits_array([[0.0, 1.0]])
    with pytest.raises(ValueError, match="strictly increasing"):
        port_buck.Bucketizer().set_splits_array([[0.0, 0.5, 0.5, 1.0]])


# -- save and load ----------------------------------------------------------------

def _transformers():
    """(JAX stage, port stage, input table columns) of each transformer."""
    X = _data(14, n=30, d=5)
    return [
        _pair(jax_bin, port_bin, "Binarizer", input_cols=("v",), output_cols=("o",), thresholds=(0.4,)),
        _pair(jax_vs, port_vs, "VectorSlicer", input_col="v", output_col="o", indices=(4, 1)),
        (jax_ep.ElementwiseProduct().set_input_col("v").set_output_col("o")
         .set_scaling_vec(JaxVectors.dense(1.0, 2.0, 3.0, 4.0, 5.0)),
         port_ep.ElementwiseProduct().set_input_col("v").set_output_col("o")
         .set_scaling_vec(Vectors.dense(1.0, 2.0, 3.0, 4.0, 5.0))),
        _pair(jax_norm, port_norm, "Normalizer", input_col="v", output_col="o", p=3.0),
        _pair(jax_inter, port_inter, "Interaction", input_cols=("v", "v"), output_col="o"),
        _pair(jax_poly, port_poly, "PolynomialExpansion", input_col="v", output_col="o", degree=3),
        _pair(jax_dct, port_dct, "DCT", input_col="v", output_col="o", inverse=True),
        _pair(jax_buck, port_buck, "Bucketizer", input_cols=("w",), output_cols=("o",),
              splits_array=[[0.0, 0.3, 1.0]], handle_invalid="keep"),
    ], {"v": X, "w": X[:, 0]}


@pytest.mark.parametrize("index", range(8))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_transformer_save_load_across_packages(both_on_one_device, tmp_path, index, direction):
    stages, columns = _transformers()
    jax_stage, port_stage = stages[index]
    path = str(tmp_path / "stage")
    if direction == "jax_to_port":
        jax_stage.save(path)
        loaded = Stage.load(path)
        assert type(loaded) is type(port_stage)
        other = jax_stage.transform(JaxTable(dict(columns)))[0]
        out = loaded.transform(Table(dict(columns)))[0]
    else:
        port_stage.save(path)
        with open(os.path.join(path, "metadata")) as f:
            assert json.load(f)["className"].startswith("org.apache.flink.ml.feature.")
        loaded = type(jax_stage).load(path)
        other = port_stage.transform(Table(dict(columns)))[0]
        out = loaded.transform(JaxTable(dict(columns)))[0]
    np.testing.assert_allclose(np.asarray(out.column("o"), np.float64),
                               np.asarray(other.column("o"), np.float64), **DCT_TOL)
