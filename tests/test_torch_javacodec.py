"""The reference-format model-data loader of flink_ml_tpu_torch
(utils/javacodec.py, read_write.load_arrays_or_reference and the
`_load_extra` of every model with a codec) against the JAX package.

- every codec round-trips, and its wire bytes equal the JAX encoder's for
  the same seeded numpy inputs; every decoded array is writable and in
  native byte order, so `torch.from_numpy` takes it;
- every family of scripts/make_reference_fixture.py FAMILIES (and the
  KMeans, LR pipeline and IndexToString layouts) written to a temporary
  directory, and every committed tests/fixtures/reference_* directory
  read in place, loads through the port's `load_stage` and the JAX
  package's, and both transform the same seeded table to equal outputs.
  Equal means equal: the stages compute on host float64 columns in both
  packages, except the linear models and KMeans, which compute in float32
  and are held at their solo parity tolerances (raw predictions atol
  1e-5, equal predictions and assignments);
- the error cases: numeric part order, a truncated or corrupt part raises
  IOError naming the file, a directory with neither format raises a
  FileNotFoundError naming both, an npz is preferred over part files,
  Knn concatenates its part records.
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.utils import javacodec as jax_codec
from flink_ml_tpu.utils import read_write as jax_rw
from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.utils import javacodec
from flink_ml_tpu_torch.utils import read_write
from scripts.make_reference_fixture import FAMILIES, write_metadata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _stream(payload: bytes):
    return io.BufferedReader(io.BytesIO(payload))


# -- the codecs ------------------------------------------------------------

def _codec_cases():
    """name -> (encode args, encoder name, reader name, expected decode)."""
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(7)
    centroids, weights = rng.standard_normal((3, 4)), rng.random(3)
    matrix = rng.standard_normal((3, 5))
    strings = ["plain", "", None, "nul\x00inside", "smile \U0001F600 and é", "￿"]
    knn_features, knn_labels = rng.standard_normal((4, 3)), rng.integers(0, 3, 4).astype(float)
    theta = [[{0.0: -0.1, 1.0: -2.3}, {2.5: 0.25}], [{0.0: -1.6}, {}]]
    return {
        "dense_vector": ((vec,), "encode_dense_vector", "read_dense_vector", vec),
        "empty_dense_vector": ((np.zeros(0),), "encode_dense_vector", "read_dense_vector",
                               np.zeros(0)),
        "kmeans": ((centroids, weights), "encode_kmeans_model_data", "read_kmeans_model_data",
                   (centroids, weights)),
        "logisticregression": ((vec, 42), "encode_logisticregression_model_data",
                               "read_logisticregression_model_data", (vec, 42)),
        "coefficient": ((vec,), "encode_coefficient_model_data", "read_dense_vector", vec),
        "string_array": ((strings,), "encode_string_array", "read_string_array", strings),
        "double_array": ((vec,), "encode_double_array", "read_double_array", vec),
        "int_array": ((np.array([0, -1, 2**31 - 1, -2**31]),), "encode_int_array", "read_int_array",
                      np.array([0, -1, 2**31 - 1, -2**31])),
        "long_array": ((np.array([0, -1, 2**63 - 1]),), "encode_long_array", "read_long_array",
                       np.array([0, -1, 2**63 - 1])),
        "dense_matrix": ((matrix,), "encode_dense_matrix", "read_dense_matrix", matrix),
        "naivebayes": ((theta, np.log([0.4, 0.6]), np.array([10.0, 20.0])),
                       "encode_naivebayes_model_data", "read_naivebayes_model_data", None),
        "countvectorizer": ((["b", "a", "été"],), "encode_countvectorizer_model_data",
                            "read_countvectorizer_model_data", None),
        "idf": ((vec[:3], [1, 2, 3], 9), "encode_idf_model_data", "read_idf_model_data", None),
        "imputer": (({"a": 1.5, "b": float("nan"), "c": None},), "encode_imputer_model_data",
                    "read_imputer_model_data", None),
        "kbinsdiscretizer": (([[0.0, 1.0, 2.0], [-1.0, 5.0]],),
                             "encode_kbinsdiscretizer_model_data",
                             "read_kbinsdiscretizer_model_data", None),
        "minhashlsh": ((2, 3, [1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]),
                       "encode_minhashlsh_model_data", "read_minhashlsh_model_data", None),
        "maxabsscaler": ((vec,), "encode_maxabsscaler_model_data", "read_maxabsscaler_model_data",
                         None),
        "minmaxscaler": ((vec, vec + 1), "encode_minmaxscaler_model_data",
                         "read_minmaxscaler_model_data", None),
        "onehotencoder": ((3, 7), "encode_onehotencoder_model_record",
                          "read_onehotencoder_model_record", (3, 7)),
        "robustscaler": ((vec, vec * 2), "encode_robustscaler_model_data",
                         "read_robustscaler_model_data", None),
        "standardscaler": ((vec, np.abs(vec)), "encode_standardscaler_model_data",
                           "read_standardscaler_model_data", None),
        "stringindexer": (([["b", "a"], ["x"]],), "encode_stringindexer_model_data",
                          "read_stringindexer_model_data", None),
        "univariatefeatureselector": (([4, 0, 2],), "encode_univariatefeatureselector_model_data",
                                      "read_univariatefeatureselector_model_data", None),
        "variancethresholdselector": ((5, [0, 3]),
                                      "encode_variancethresholdselector_model_data",
                                      "read_variancethresholdselector_model_data", None),
        "vectorindexer": (({0: {5.0: 0, 7.0: 1}, 3: {-1.0: 1, 2.0: 0}},),
                          "encode_vectorindexer_model_data", "read_vectorindexer_model_data",
                          None),
        "knn": ((knn_features, knn_labels), "encode_knn_model_data", "read_knn_model_data",
                (knn_features, knn_labels)),
    }


CODECS = sorted(_codec_cases())


def _leaves(value):
    """The arrays and scalars of a decoded value, flattened in order."""
    if isinstance(value, dict):
        for k in sorted(value):
            yield from _leaves(value[k])
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    elif isinstance(value, np.ndarray) and value.dtype == object:
        for v in value.reshape(-1):
            yield from _leaves(v)
    else:
        yield value


def _same(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)
        elif isinstance(x, float) and np.isnan(x):
            assert np.isnan(y)
        else:
            assert x == y and type(x) is type(y)


@pytest.mark.parametrize("name", CODECS)
def test_codec_bytes_equal_jax_and_round_trip(name):
    args, encoder, reader, expected = _codec_cases()[name]
    payload = getattr(javacodec, encoder)(*args)
    assert payload == getattr(jax_codec, encoder)(*args)
    decoded = getattr(javacodec, reader)(_stream(payload))
    _same(decoded, getattr(jax_codec, reader)(_stream(payload)))
    if expected is not None:
        _same(decoded, expected) if not isinstance(expected, np.ndarray) else \
            np.testing.assert_array_equal(decoded, expected)
    for leaf in _leaves(decoded):
        if isinstance(leaf, np.ndarray) and leaf.dtype != object:
            assert leaf.dtype.isnative and leaf.flags.writeable
            torch.from_numpy(leaf)  # refuses big-endian and read-only arrays


def test_java_strings_are_utf16_code_units():
    """NUL is one code unit (0x00, as a varint), a supplementary character
    two surrogates (U+1F600: 0xD83D 0xDE00); None is the 0x00 length."""
    assert javacodec.encode_java_string(None) == b"\x00"
    assert javacodec.encode_java_string("") == b"\x01"
    assert javacodec.encode_java_string("\x00") == b"\x02\x00"
    assert javacodec.encode_java_string("\U0001F600") == b"\x03" + bytes([0xBD, 0xB0, 0x03, 0x80, 0xBC, 0x03])
    assert javacodec.read_java_string(_stream(b"\x03\xbd\xb0\x03\x80\xbc\x03")) == "\U0001F600"


def test_dense_vector_wire_bytes_are_big_endian():
    raw = javacodec.encode_dense_vector(np.array([1.0]))
    assert raw == b"\x00\x00\x00\x01" + b"\x3f\xf0" + b"\x00" * 6


@pytest.mark.parametrize("reader,payload", [
    ("read_dense_vector", b"\x00\x00\x00\x02" + b"\x00" * 8),
    ("read_java_string", b"\x85"),
    ("read_int_array", b"\x00\x00\x00\x03\x00\x00\x00\x01"),
    ("read_onehotencoder_model_record", b"\x01\x00\x00\x00"),
])
def test_truncated_payloads_raise_eof(reader, payload):
    with pytest.raises(EOFError):
        getattr(javacodec, reader)(_stream(payload))


def test_port_module_is_a_copy_of_the_jax_codecs():
    """The port keeps its own copy: the same public functions."""
    public = lambda m: sorted(n for n in dir(m) if not n.startswith("_") and callable(getattr(m, n)))  # noqa: E731
    assert public(javacodec) == public(jax_codec)


# -- reference-format directories, through load_stage ------------------------

def _family_inputs():
    """name -> (columns of the table both packages transform, output
    columns, float32 compute?). Seeded."""
    rng = np.random.default_rng(3)
    two = rng.standard_normal((20, 2)) * 3
    a = rng.standard_normal(20)
    a[::4] = np.nan
    b = rng.standard_normal(20)
    b[1::5] = np.nan
    tokens = np.empty(20, dtype=object)
    for i in range(20):
        tokens[i] = list(rng.choice(["apple", "pear", "fig"], size=rng.integers(0, 5)))
    idx = rng.integers(0, 10, size=(20, 3)).astype(np.int32)
    return {
        "standardscaler": ({"input": two}, ["output"]),
        "minmaxscaler": ({"input": two}, ["output"]),
        "maxabsscaler": ({"input": two}, ["output"]),
        "robustscaler": ({"input": two}, ["output"]),
        "idf": ({"input": np.abs(two)}, ["output"]),
        "imputer": ({"a": a, "b": b}, ["ao", "bo"]),
        "kbinsdiscretizer": ({"input": rng.uniform(-0.5, 2.5, (20, 1))}, ["output"]),
        "stringindexer": ({"c": rng.choice(["a", "b"], 20)}, ["ci"]),
        "onehotencoder": ({"c": rng.integers(0, 3, 20).astype(float)}, ["v"]),
        "vectorindexer": ({"input": rng.choice([5.0, 7.0], (20, 1))}, ["output"]),
        "countvectorizer": ({"input": tokens}, ["output"]),
        "minhashlsh": ({"vec": ("sparse", 10, idx, np.ones((20, 3)))}, ["hashes"]),
        "univariatefeatureselector": ({"features": rng.standard_normal((20, 3))}, ["output"]),
        "variancethresholdselector": ({"input": rng.standard_normal((20, 3))}, ["output"]),
        "naivebayes": ({"features": rng.integers(0, 2, (20, 1)).astype(float)}, ["prediction"]),
        "knn": ({"features": rng.uniform(-1, 11, (20, 2))}, ["prediction"]),
        "kmeans": ({"features": rng.uniform(-1, 11, (20, 2))}, ["prediction"]),
        "lr_pipelinemodel": ({"features": rng.standard_normal((20, 4))},
                             ["prediction", "rawPrediction"]),
        "indextostring": ({"ci": rng.integers(0, 2, 20).astype(float)}, ["c"]),
    }


#: transforms that compute in float32 on the port's device: held at the
#: solo parity tolerances (raw predictions atol 1e-5; equal predictions)
FLOAT32_TRANSFORMS = {"kmeans", "lr_pipelinemodel"}


def _tables(cols):
    jax_cols, port_cols = {}, {}
    for k, v in cols.items():
        if isinstance(v, tuple) and v[0] == "sparse":
            _, size, idx, vals = v
            jax_cols[k], port_cols[k] = JaxSparseBatch(size, idx, vals), SparseBatch(size, idx, vals)
        else:
            jax_cols[k] = port_cols[k] = v
    return JaxTable(jax_cols), Table(port_cols)


def _host(col):
    if isinstance(col, torch.Tensor):
        return col.numpy()
    if hasattr(col, "to_dense"):
        return np.asarray(col.to_dense())
    col = np.asarray(col)
    if col.dtype == object and len(col) and hasattr(col[0], "to_array"):
        return np.stack([np.asarray(v.to_array()) for v in col])
    if col.dtype == object and len(col) and isinstance(col[0], (list, np.ndarray)):
        return np.array([np.asarray(v).tolist() for v in col], dtype=object)
    return col


def _same_output(name, col, port_col, jax_col):
    got, want = _host(port_col), _host(jax_col)
    if name in FLOAT32_TRANSFORMS and col == "rawPrediction":
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), atol=1e-5)
    elif got.dtype == object or want.dtype == object:
        assert [np.asarray(g).tolist() if not isinstance(g, str) else g for g in got] == \
            [np.asarray(w).tolist() if not isinstance(w, str) else w for w in want]
    else:
        np.testing.assert_array_equal(got, want)


def _write_family(root, name):
    if name == "kmeans":
        path = os.path.join(root, "reference_kmeans_model")
        write_metadata(path, "org.apache.flink.ml.clustering.kmeans.KMeansModel",
                       {"featuresCol": "features", "predictionCol": "prediction", "k": 2})
        javacodec.write_reference_data_file(path, javacodec.encode_kmeans_model_data(
            np.array([[0.0, 0.0], [10.0, 10.0]]), np.array([3.0, 2.0])))
    elif name == "lr_pipelinemodel":
        path = os.path.join(root, "reference_lr_pipelinemodel")
        write_metadata(path, "org.apache.flink.ml.builder.PipelineModel", {}, {"numStages": 1})
        stage = os.path.join(path, "stages", "0")
        write_metadata(stage, "org.apache.flink.ml.classification.logisticregression."
                       "LogisticRegressionModel", {"featuresCol": "features"})
        javacodec.write_reference_data_file(stage, javacodec.encode_logisticregression_model_data(
            np.array([1.5, -2.0, 0.25, 3.0]), 3))
    elif name == "indextostring":
        path = os.path.join(root, "reference_indextostring_model")
        write_metadata(path, "org.apache.flink.ml.feature.stringindexer.IndexToStringModel",
                       {"inputCols": ["ci"], "outputCols": ["c"]})
        javacodec.write_reference_data_file(
            path, javacodec.encode_stringindexer_model_data([["b", "a"]]))
    else:
        class_name, param_map, payload = FAMILIES[name]
        path = os.path.join(root, f"reference_{name}_model")
        write_metadata(path, class_name, param_map)
        javacodec.write_reference_data_file(path, payload)
    return path


def _load_both_and_transform(name, path):
    cols, outputs = _family_inputs()[name]
    jax_table, port_table = _tables(cols)
    port_stage, jax_stage = read_write.load_stage(path), jax_rw.load_stage(path)
    assert type(port_stage).__name__ == type(jax_stage).__name__
    port_out = port_stage.transform(port_table)[0]
    jax_out = jax_stage.transform(jax_table)[0]
    for col in outputs:
        _same_output(name, col, port_out.column(col), jax_out.column(col))
    return port_stage, port_out


FAMILY_NAMES = sorted(FAMILIES) + ["kmeans", "lr_pipelinemodel", "indextostring"]


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_written_family_loads_and_transforms_as_jax(both_on_one_device, tmp_path, name):
    path = _write_family(str(tmp_path), name)
    assert not read_write.model_data_exists(path)
    _load_both_and_transform(name, path)


COMMITTED = sorted(os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES, "reference_*")))


@pytest.mark.parametrize("fixture", COMMITTED)
def test_committed_fixture_loads_in_place_and_transforms_as_jax(both_on_one_device, tmp_path,
                                                                fixture):
    name = fixture[len("reference_"):]
    name = name[: -len("_model")] if name.endswith("_model") else name
    stage, out = _load_both_and_transform(name, os.path.join(FIXTURES, fixture))
    # and the npz container written by the port loads back to the same outputs
    stage.save(str(tmp_path / "npz"))
    again = read_write.load_stage(str(tmp_path / "npz")).transform(
        _tables(_family_inputs()[name][0])[1])[0]
    for col in _family_inputs()[name][1]:
        _same_output(name, col, again.column(col), out.column(col))


def test_every_family_has_a_committed_fixture():
    assert len(COMMITTED) == len(FAMILIES) + 2
    assert {f"reference_{n}_model" for n in FAMILIES} | {
        "reference_kmeans_model", "reference_lr_pipelinemodel"} == set(COMMITTED)


def test_reference_kmeans_and_lr_pipeline_fixtures_predict(both_on_one_device):
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeansModel
    from flink_ml_tpu_torch.pipeline import PipelineModel

    model = read_write.load_stage(os.path.join(FIXTURES, "reference_kmeans_model"))
    assert isinstance(model, KMeansModel) and model.get_k() == 2
    np.testing.assert_array_equal(model.centroids, [[0.0, 0.0], [10.0, 10.0]])
    np.testing.assert_array_equal(model.weights, [3.0, 2.0])
    out = model.transform(Table({"features": np.array([[1.0, 1.0], [9.0, 9.0]])}))[0]
    np.testing.assert_array_equal(out.column("prediction"), [0, 1])

    pipeline = PipelineModel.load(os.path.join(FIXTURES, "reference_lr_pipelinemodel"))
    X = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    out = pipeline.transform(Table({"features": X}))[0]
    np.testing.assert_array_equal(out.column("prediction"), [1.0, 0.0, 1.0])
    coeff = np.array([1.5, -2.0, 0.25, 3.0])
    np.testing.assert_allclose(out.column("rawPrediction")[:, 1], 1 / (1 + np.exp(-(X @ coeff))),
                               atol=1e-6)
    # device in, device out: a tensor column predicts on its device
    dev_out = pipeline.transform(Table({"features": torch.from_numpy(X).float()}))[0]
    np.testing.assert_array_equal(dev_out.column("prediction").numpy(), [1.0, 0.0, 1.0])


# -- error cases and format precedence ------------------------------------------

def test_part_files_sort_numerically_and_the_last_record_wins(tmp_path):
    stage = str(tmp_path / "m")
    for i in range(11):
        javacodec.write_reference_data_file(
            stage, javacodec.encode_logisticregression_model_data(np.array([float(i)]), i), part=i)
    names = [os.path.basename(p) for p in javacodec._data_files(stage)]
    assert names == [f"part-0-{i}" for i in range(11)]
    coeff, version = javacodec.load_reference_logisticregression(stage)
    assert version == 10 and coeff[0] == 10.0
    assert javacodec.load_reference_logisticregression(stage)[1] == \
        jax_codec.load_reference_logisticregression(stage)[1]


@pytest.mark.parametrize("cut", ["truncated", "corrupt"])
def test_a_truncated_or_corrupt_part_raises_naming_the_file(tmp_path, cut):
    stage = str(tmp_path / "m")
    payload = javacodec.encode_dense_vector(np.array([1.0, 2.0]))
    payload = payload[:-3] if cut == "truncated" else b"\x7f\xff\xff\xff" + payload[4:]
    path = javacodec.write_reference_data_file(stage, payload)
    with pytest.raises(IOError, match="Corrupt reference model data file .*part-0-0"):
        javacodec.load_reference_coefficient(stage)
    assert os.path.exists(path)


@pytest.mark.parametrize("payload", [
    b"\x7f\xff\xff\xff",  # a DenseVector claiming 2^31 - 1 doubles (16 GiB)
    b"\x00\x00\x00\x01\x03\xff\xff\x7f\x41",  # a string array with a code unit past U+10FFFF
    b"\xff\xff\xff\xfe",  # a negative length
], ids=["huge_length", "bad_code_unit", "negative_length"])
def test_a_corrupt_length_or_value_raises_without_reading_it(tmp_path, payload):
    """The port reads a length prefix's bytes in bounded chunks, so a
    corrupt one ends at the end of the file; a value no writer makes is
    corruption too."""
    stage = str(tmp_path / "m")
    javacodec.write_reference_data_file(stage, payload)
    loader = (javacodec.load_reference_countvectorizer if payload[4:5] == b"\x03"
              else javacodec.load_reference_coefficient)
    with pytest.raises(IOError, match="Corrupt reference model data file"):
        loader(stage)


def test_a_corrupt_model_directory_fails_loading_in_both_packages(both_on_one_device, tmp_path):
    path = _write_family(str(tmp_path), "standardscaler")
    with open(os.path.join(path, "data", "part-0-0"), "r+b") as f:
        f.truncate(10)
    with pytest.raises(IOError, match="Corrupt"):
        read_write.load_stage(path)
    with pytest.raises(IOError, match="Corrupt"):
        jax_rw.load_stage(path)


def test_missing_model_data_names_both_formats(both_on_one_device, tmp_path):
    stage_dir = tmp_path / "empty_model"
    stage_dir.mkdir()
    (stage_dir / "metadata").write_text(json.dumps({
        "className": "org.apache.flink.ml.clustering.kmeans.KMeansModel", "paramMap": {}}))
    for loader in (read_write.load_stage, jax_rw.load_stage):
        with pytest.raises(FileNotFoundError, match="neither the native npz container nor "
                           "reference-format binary part files"):
            loader(str(stage_dir))
    with pytest.raises(FileNotFoundError):
        read_write.load_model_arrays(str(stage_dir))


def test_an_npz_container_wins_over_part_files(both_on_one_device, tmp_path):
    from flink_ml_tpu_torch.models.feature.standardscaler import StandardScalerModel

    path = _write_family(str(tmp_path), "standardscaler")
    read_write.save_model_arrays(path, mean=np.array([0.0, 0.0]), std=np.array([1.0, 1.0]))
    model = StandardScalerModel.load(path)
    np.testing.assert_array_equal(model.mean, [0.0, 0.0])
    np.testing.assert_array_equal(model.std, [1.0, 1.0])
    assert javacodec.load_reference_standardscaler(path)["mean"].tolist() == [1.0, 2.0]


def test_knn_concatenates_its_part_records(both_on_one_device, tmp_path):
    stage = str(tmp_path / "m")
    write_metadata(stage, "org.apache.flink.ml.classification.knn.KnnModel",
                   {"featuresCol": "features", "predictionCol": "prediction", "k": 1})
    javacodec.write_reference_data_file(
        stage, javacodec.encode_knn_model_data(np.array([[0.0, 0.0]]), np.array([1.0])), part=0)
    javacodec.write_reference_data_file(
        stage, javacodec.encode_knn_model_data(np.array([[10.0, 10.0]]), np.array([2.0])), part=1)
    model = read_write.load_stage(stage)
    np.testing.assert_array_equal(model.features, [[0.0, 0.0], [10.0, 10.0]])
    out = model.transform(Table({"features": np.array([[9.0, 9.0], [1.0, 0.0]])}))[0]
    np.testing.assert_array_equal(out.column("prediction"), [2.0, 1.0])


def test_onehot_records_across_part_files(both_on_one_device, tmp_path):
    """OneHotEncoder's model data is one record a column, in any part."""
    stage = str(tmp_path / "m")
    write_metadata(stage, "org.apache.flink.ml.feature.onehotencoder.OneHotEncoderModel",
                   {"inputCols": ["c", "d"], "outputCols": ["v", "w"], "dropLast": False})
    javacodec.write_reference_data_file(stage, javacodec.encode_onehotencoder_model_record(1, 4), 0)
    javacodec.write_reference_data_file(stage, javacodec.encode_onehotencoder_model_record(0, 2), 1)
    model = read_write.load_stage(stage)
    np.testing.assert_array_equal(model.category_sizes, [3, 5])
    np.testing.assert_array_equal(model.category_sizes, jax_rw.load_stage(stage).category_sizes)


def test_online_models_still_need_the_npz_container(tmp_path):
    """The online models have no reference codec in either package."""
    from flink_ml_tpu_torch.models.clustering.onlinekmeans import OnlineKMeansModel

    stage = str(tmp_path / "m")
    write_metadata(stage, "org.apache.flink.ml.clustering.onlinekmeans.OnlineKMeansModel", {})
    javacodec.write_reference_data_file(stage, javacodec.encode_kmeans_model_data(
        np.zeros((2, 2)), np.ones(2)))
    with pytest.raises(FileNotFoundError):
        OnlineKMeansModel.load(stage)
