"""The port's benchmark CLI (`flink_ml_tpu_torch.benchmark`) against the
JAX package's (`flink_ml_tpu.benchmark`).

The JAX side runs on a one-device mesh, the port under
`config.use_device("cpu")`. Held to:

- the 12 cases of tests/test_benchmark.py, each on both packages: the
  generators, the result schema, a modelData entry, the reference's
  commented configs, the demo, every shipped config at `_shrunk` size;
- every `conf/*-benchmark.json` and every entry of the demo, at
  `_shrunk` size, run through both runners (the JAX side once a config,
  module-scoped): identical result keys (`runner.RESULT_KEYS`) and
  `phaseTimesMs` keys, equal `inputRecordNum` and `outputRecordNum`, the
  row relation `chip_smoke.bench_output_rows` pins (which phase 19 holds
  on the card), and an equal `gapCount` (one launch on the whole fits);
- the generated tables: bit for bit on the numpy path (below
  `DEVICE_GEN_THRESHOLD`, and at 2,048 rows with
  FLINK_ML_TPU_DEVICE_DATAGEN=0); above it (torch's generator, not
  jax.random's: ROADMAP C.43) by shape, float32, range and same-seed
  determinism;
- the runner cases of tests/test_obs.py, test_timeline.py and
  test_metrics.py: the embedded metrics, `dispatchGapMs` within 5% of the
  work wall less `hostDispatchMs` with the timeline's attribution, the
  phase timers;
- `runner.main` with `--output-file` in-process, and scripts/bench_diff.py
  over that file as a subprocess (exit 0).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flink_ml_tpu.benchmark import datagenerator as jax_dg
from flink_ml_tpu.benchmark import runner as jax_runner
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.benchmark import datagenerator as port_dg
from flink_ml_tpu_torch.benchmark import runner
from flink_ml_tpu_torch.obs import timeline
from flink_ml_tpu_torch.table import DictTokenMatrix
from flink_ml_tpu_torch.utils import metrics

import chip_smoke
from test_benchmark import _shrunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF_DIR = os.path.join(REPO, "conf")
CONFIGS = sorted(glob.glob(os.path.join(CONF_DIR, "*-benchmark.json")))
DEMO = os.path.join(CONF_DIR, "benchmark-demo.json")
#: the fits both packages launch once (a whole fit through the funnel)
WHOLE_FIT_STAGES = ("LogisticRegression", "LinearSVC", "LinearRegression", "KMeans")

GENERATORS = ("DenseVectorGenerator", "DenseVectorArrayGenerator", "DoubleGenerator",
              "LabeledPointWithWeightGenerator", "RandomStringGenerator",
              "RandomStringArrayGenerator", "KMeansModelDataGenerator")


@pytest.fixture
def jax_one_device():
    import jax

    with jax_mesh.use_mesh(jax_mesh.create_mesh(devices=jax.devices()[:1])):
        yield


@pytest.fixture(scope="module")
def jax_results():
    """The JAX runner's result of each config's entries, at `_shrunk`
    size, run once a config on a one-device mesh."""
    import jax

    cache = {}

    def get(path):
        if path not in cache:
            with jax_mesh.use_mesh(jax_mesh.create_mesh(devices=jax.devices()[:1])):
                cache[path] = {name: jax_runner.run_benchmark(name, entry)
                               for name, entry in _entries(path)}
        return cache[path]
    return get


def _entries(path):
    cfg = runner.load_config(path)
    return [(name, _shrunk(entry, os.path.basename(path)))
            for name, entry in cfg.items() if name != "version"]


def _stage_name(entry) -> str:
    return entry["stage"]["className"].rsplit(".", 1)[1]


def _host(col):
    """A generated column as host values to compare: numpy arrays as they
    are, a vector array's rows as lists of value arrays."""
    if isinstance(col, torch.Tensor):
        return col.numpy()
    col = np.asarray(col)
    if col.dtype == object:
        return [[np.asarray(v.values) for v in row] for row in col]
    return col


def _assert_tables_equal(port_tables, jax_tables):
    assert len(port_tables) == len(jax_tables)
    for p, j in zip(port_tables, jax_tables):
        assert p.column_names == j.column_names
        for name in p.column_names:
            a, b = _host(p.column(name)), _host(j.column(name))
            if isinstance(a, list):
                assert len(a) == len(b)
                for ra, rb in zip(a, b):
                    for va, vb in zip(ra, rb):
                        np.testing.assert_array_equal(va, vb)
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def _both(cls_name, **params):
    """The generator `cls_name` of each package, with the same params set
    by their JSON names."""
    spec = {"className": f"org.apache.flink.ml.benchmark.datagenerator.common.{cls_name}",
            "paramMap": params}
    return runner.instantiate_generator(spec), jax_runner.instantiate_generator(spec)


GEN_PARAMS = {
    "DenseVectorGenerator": {"colNames": [["f"]], "vectorDim": 7, "seed": 11},
    "DenseVectorArrayGenerator": {"colNames": [["f"]], "vectorDim": 3, "arraySize": 2,
                                  "seed": 3},
    "DoubleGenerator": {"colNames": [["a", "b", "c"]], "seed": 5},
    "LabeledPointWithWeightGenerator": {"colNames": [["x", "y", "w"]], "vectorDim": 4,
                                        "labelArity": 3, "seed": 9},
    "RandomStringGenerator": {"colNames": [["s", "t"]], "numDistinctValues": 37, "seed": 2},
    "RandomStringArrayGenerator": {"colNames": [["s"]], "numDistinctValues": 1000,
                                   "arraySize": 5, "seed": 4},
    "KMeansModelDataGenerator": {"colNames": [["centroids", "weights"]], "arraySize": 4,
                                 "vectorDim": 6, "seed": 8},
}


# -- the generators -----------------------------------------------------------


class TestGenerators:
    def test_dense_vector_generator(self):
        gen = (port_dg.DenseVectorGenerator().set_col_names(["features"]).set_num_values(100)
               .set_vector_dim(5))
        (table,) = gen.get_data()
        assert table.num_rows == 100
        assert np.asarray(table.column("features")).shape == (100, 5)
        jgen = (jax_dg.DenseVectorGenerator().set_col_names(["features"]).set_num_values(100)
                .set_vector_dim(5))
        _assert_tables_equal([table], jgen.get_data())

    def test_deterministic_by_seed(self):
        def make(dg):
            return (dg.DenseVectorGenerator().set_col_names(["f"]).set_num_values(10)
                    .set_vector_dim(3).set_seed(7)).get_data()[0]

        np.testing.assert_array_equal(np.asarray(make(port_dg).column("f")),
                                      np.asarray(make(port_dg).column("f")))
        _assert_tables_equal([make(port_dg)], [make(jax_dg)])

    def test_labeled_point_generator(self):
        def make(dg):
            return (dg.LabeledPointWithWeightGenerator()
                    .set_col_names(["features", "label", "weight"])
                    .set_num_values(50).set_vector_dim(4).set_label_arity(3)).get_data()

        (table,) = make(port_dg)
        assert set(np.asarray(table.column("label"))).issubset({0.0, 1.0, 2.0})
        assert np.asarray(table.column("features")).shape == (50, 4)
        _assert_tables_equal([table], make(jax_dg))

    def test_string_generators(self):
        (t,) = port_dg.RandomStringGenerator().set_col_names(["s"]).set_num_values(20).get_data()
        assert all(isinstance(v, str) for v in t.column("s"))
        (t2,) = (port_dg.RandomStringArrayGenerator()
                 .set_col_names(["s"]).set_num_values(5).set_array_size(3)).get_data()
        assert all(len(v) == 3 for v in t2.column("s"))
        _assert_tables_equal(
            [t], jax_dg.RandomStringGenerator().set_col_names(["s"]).set_num_values(20).get_data())
        _assert_tables_equal([t2], (jax_dg.RandomStringArrayGenerator().set_col_names(["s"])
                                    .set_num_values(5).set_array_size(3)).get_data())

    def test_double_generator(self):
        (t,) = port_dg.DoubleGenerator().set_col_names(["a", "b"]).set_num_values(10).get_data()
        assert t.column_names == ["a", "b"]
        _assert_tables_equal(
            [t], jax_dg.DoubleGenerator().set_col_names(["a", "b"]).set_num_values(10).get_data())

    def test_kmeans_model_data_generator(self):
        def make(dg):
            gen = dg.KMeansModelDataGenerator().set_col_names(["centroids", "weights"])
            gen.set(gen.ARRAY_SIZE, 3).set(gen.VECTOR_DIM, 2)
            return gen.get_data()

        (t,) = make(port_dg)
        assert t.num_rows == 1
        _assert_tables_equal([t], make(jax_dg))


@pytest.mark.parametrize("cls_name", GENERATORS)
@pytest.mark.parametrize("rows", [1, 200, port_dg.DEVICE_GEN_THRESHOLD - 1])
def test_numpy_path_tables_equal_jax_bit_for_bit(cls_name, rows):
    port, jax_gen = _both(cls_name, numValues=rows, **GEN_PARAMS[cls_name])
    with config.use_device("cpu"):
        _assert_tables_equal(port.get_data(), jax_gen.get_data())


@pytest.mark.parametrize("cls_name", GENERATORS)
def test_host_datagen_switch_keeps_jax_bits_above_the_threshold(cls_name, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_DEVICE_DATAGEN", "0")
    port, jax_gen = _both(cls_name, numValues=2_048, **GEN_PARAMS[cls_name])
    with config.use_device("cpu"):
        _assert_tables_equal(port.get_data(), jax_gen.get_data())


def test_prefer_host_keeps_jax_bits_above_the_threshold():
    port, jax_gen = _both("DenseVectorGenerator", numValues=2_048,
                          **GEN_PARAMS["DenseVectorGenerator"])
    port_dg.set_prefer_host(True)
    jax_dg.set_prefer_host(True)
    try:
        with config.use_device("cpu"):
            tables = port.get_data()
        want = jax_gen.get_data()
    finally:
        port_dg.set_prefer_host(False)
        jax_dg.set_prefer_host(False)
    _assert_tables_equal(tables, want)


def _device_arrays(table):
    out = {}
    for name in table.column_names:
        col = table.column(name)
        out[name] = col.ids if isinstance(col, DictTokenMatrix) else col
    return out


@pytest.mark.parametrize("cls_name, arity", [
    ("DenseVectorGenerator", 0), ("DoubleGenerator", 0), ("DoubleGenerator", 6),
    ("LabeledPointWithWeightGenerator", 0), ("LabeledPointWithWeightGenerator", 6),
    ("RandomStringArrayGenerator", 0)])
def test_device_path_shape_dtype_range_and_seed(cls_name, arity):
    """Above the threshold the port's tables are torch's draws (ROADMAP
    C.43): the JAX tables' shapes, float32 (int32 ids), their range, the
    same bits from the same seed and others from another seed."""
    params = dict(GEN_PARAMS[cls_name], numValues=4_096)
    if cls_name == "DoubleGenerator":
        params["arity"] = arity
    elif cls_name == "LabeledPointWithWeightGenerator":
        params["featureArity"] = arity
    with config.use_device("cpu"):
        port, jax_gen = _both(cls_name, **params)
        (table,) = port.get_data()
        (again,) = _both(cls_name, **params)[0].get_data()
        (other,) = _both(cls_name, **dict(params, seed=params["seed"] + 100))[0].get_data()
    (jax_table,) = jax_gen.get_data()
    assert table.column_names == jax_table.column_names
    got, twin, diff = _device_arrays(table), _device_arrays(again), _device_arrays(other)
    for name in table.column_names:
        ref = jax_table.column(name)
        ref = ref.ids if hasattr(ref, "ids") else ref
        arr = got[name]
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
        assert tuple(arr.shape) == tuple(ref.shape)
        assert arr.dtype == (torch.int32 if cls_name == "RandomStringArrayGenerator"
                             else torch.float32)
        assert str(np.asarray(ref).dtype) == str(arr.dtype).replace("torch.", "")
        assert torch.equal(arr, twin[name])
        assert not torch.equal(arr, diff[name])
        lo, hi = float(arr.min()), float(arr.max())
        if cls_name == "RandomStringArrayGenerator":
            assert 0 <= lo and hi < params["numDistinctValues"]
            np.testing.assert_array_equal(table.column(name).vocab, jax_table.column(name).vocab)
        elif (arity and name in ("a", "b", "c", "x")) or name == "y":
            top = params.get("labelArity", 2) if name == "y" else arity
            assert 0 <= lo and hi <= top - 1
            assert torch.equal(arr, arr.round())
        else:
            assert 0.0 <= lo and hi < 1.0


def test_token_ids_are_the_token_op_on_each_column_seed():
    with config.use_device("cpu"):
        port, _ = _both("RandomStringArrayGenerator",
                        **dict(GEN_PARAMS["RandomStringArrayGenerator"], numValues=2_000,
                               colNames=[["s", "t"]]))
        (table,) = port.get_data()
        from flink_ml_tpu_torch.ops import tokens

        for i, name in enumerate(["s", "t"]):
            want = tokens.random_token_ids(4 + i, 2_000, 5, 1000)
            assert torch.equal(table.column(name).ids, want)


# -- the runner ---------------------------------------------------------------

KMEANS_ENTRY = {
    "stage": {
        "className": "org.apache.flink.ml.clustering.kmeans.KMeans",
        "paramMap": {"k": 2, "maxIter": 3},
    },
    "inputData": {
        "className": "org.apache.flink.ml.benchmark.datagenerator.common.DenseVectorGenerator",
        "paramMap": {"seed": 2, "colNames": [["features"]], "numValues": 200, "vectorDim": 5},
    },
}


class TestRunner:
    def test_run_benchmark_schema(self, jax_one_device):
        with config.use_device("cpu"):
            result = runner.run_benchmark("KMeans-1", KMEANS_ENTRY)
        want = jax_runner.run_benchmark("KMeans-1", KMEANS_ENTRY)
        assert set(result) == set(want) == runner.RESULT_KEYS
        assert result["fleetSize"] == 0
        assert result["modelsPerSecond"] == 0.0
        assert result["offeredQps"] == 0.0
        assert result["goodputQps"] == 0.0
        assert result["saturationQps"] == 0.0
        assert result["pageInCount"] == 0
        assert result["peakHbmBytes"] > 0
        assert 0 <= result["residentModelBytes"] <= result["peakHbmBytes"]
        assert result["hostSyncCount"] >= 1  # the packed fit readback
        # the Lloyd program's launch is the entry's one timed dispatch
        assert result["gapCount"] == want["gapCount"] == 1
        assert result["hostDispatchMs"] > 0
        work_ms = result["phaseTimesMs"]["fit"] + result["phaseTimesMs"]["transform"]
        assert 0.0 <= result["dispatchGapMs"] <= work_ms + 1e-6
        assert result["dispatchAttribution"] is None  # the timeline is off
        assert result["retryCount"] == result["shedCount"] == result["rejectCount"] == 0
        assert set(result["phaseTimesMs"]) == set(want["phaseTimesMs"]) == {
            "datagen", "fit", "transform", "collect"}
        assert result["inputRecordNum"] == want["inputRecordNum"] == 200
        assert result["outputRecordNum"] == want["outputRecordNum"] == 200
        assert result["totalTimeMs"] > 0
        assert result["wholeFitCount"] == want["wholeFitCount"] == 1
        assert result["collectiveBreakdown"] == want["collectiveBreakdown"] == {}

    def test_model_transform_benchmark(self, jax_one_device):
        entry = {
            "stage": {
                "className": "org.apache.flink.ml.clustering.kmeans.KMeansModel",
                "paramMap": {},
            },
            "modelData": {
                "className": "org.apache.flink.ml.benchmark.datagenerator.clustering."
                             "KMeansModelDataGenerator",
                "paramMap": {"colNames": [["centroids", "weights"]], "arraySize": 3,
                             "vectorDim": 5},
            },
            "inputData": {
                "className": "org.apache.flink.ml.benchmark.datagenerator.common."
                             "DenseVectorGenerator",
                "paramMap": {"colNames": [["features"]], "numValues": 100, "vectorDim": 5},
            },
        }
        with config.use_device("cpu"):
            result = runner.run_benchmark("KMeansModel-1", entry)
        want = jax_runner.run_benchmark("KMeansModel-1", entry)
        assert result["outputRecordNum"] == want["outputRecordNum"] == 100
        assert set(result["phaseTimesMs"]) == set(want["phaseTimesMs"])
        assert result["gapCount"] == want["gapCount"] == 0

    def test_load_reference_config(self, tmp_path):
        """A config with the reference's // license header parses (the
        conf/ mirror of kmeans-benchmark.json behind a // header)."""
        with open(os.path.join(CONF_DIR, "kmeans-benchmark.json")) as f:
            text = "// mirrored reference config\n// second line\n" + f.read()
        path = tmp_path / "kmeans-benchmark.json"
        path.write_text(text)
        cfg = runner.load_config(str(path))
        assert cfg == jax_runner.load_config(str(path))
        assert "KMeans" in cfg
        assert cfg["KMeans"]["stage"]["className"].endswith("KMeans")

    def test_shipped_demo_config(self):
        cfg = runner.load_config(DEMO)
        small = {"version": 1, "StandardScaler-1": cfg["StandardScaler-1"]}
        small["StandardScaler-1"]["inputData"]["paramMap"]["numValues"] = 100
        with config.use_device("cpu"):
            results = runner.execute_benchmarks(small)
        assert list(results) == ["StandardScaler-1"]
        assert results["StandardScaler-1"]["outputRecordNum"] == 100

    def test_conf_holds_every_shipped_config(self):
        """conf/ holds the reference's 36 benchmark configs and the demo,
        and every stage and generator they name resolves in the port."""
        assert len(CONFIGS) == 36
        for path in CONFIGS + [DEMO]:
            for _, entry in _entries(path):
                assert runner.instantiate_generator(entry["inputData"]) is not None
                from flink_ml_tpu_torch.utils import read_write

                stage = read_write.instantiate_with_params(entry["stage"])
                assert type(stage).__module__.startswith("flink_ml_tpu_torch.")


@pytest.mark.parametrize("config_path", CONFIGS + [DEMO], ids=os.path.basename)
def test_all_shipped_configs_execute_as_jax(config_path, jax_results):
    """Every shipped config (the reference's 36 and the demo) runs end to
    end at smoke size through the port's runner, as through the JAX
    runner: the same keys, record counts and launches."""
    want = jax_results(config_path)
    for name, entry in _entries(config_path):
        with config.use_device("cpu"):
            result = runner.run_benchmark(name, entry)
        ref = want[name]
        assert set(result) == set(ref) == runner.RESULT_KEYS
        assert set(result["phaseTimesMs"]) == set(ref["phaseTimesMs"])
        assert result["totalTimeMs"] > 0
        n = ref["inputRecordNum"]
        assert result["inputRecordNum"] == n
        assert result["outputRecordNum"] == ref["outputRecordNum"] > 0
        assert ref["outputRecordNum"] == chip_smoke.bench_output_rows(entry, n)
        assert result["gapCount"] == ref["gapCount"]
        if _stage_name(entry) in WHOLE_FIT_STAGES:
            assert result["gapCount"] == 1 and result["wholeFitCount"] == 1
            assert result["hostDispatchMs"] > 0
        else:
            assert result["gapCount"] == 0 and result["hostDispatchMs"] == 0.0
        json.dumps(result)


def test_entry_names_resolve_to_the_port_generator():
    for name in ("flink_ml_tpu.benchmark.datagenerator.DenseVectorGenerator",
                 "flink_ml_tpu_torch.benchmark.datagenerator.DenseVectorGenerator",
                 "org.apache.flink.ml.benchmark.datagenerator.common.DenseVectorGenerator"):
        gen = runner.instantiate_generator({"className": name, "paramMap": {"vectorDim": 3}})
        assert type(gen) is port_dg.DenseVectorGenerator
        assert gen.get_vector_dim() == 3


def test_block_until_ready_reads_nothing_back_on_the_cpu():
    before = metrics.get_counter("readback.count")
    with config.use_device("cpu"):
        (table,) = _both("DenseVectorGenerator", numValues=2_048,
                         **GEN_PARAMS["DenseVectorGenerator"])[0].get_data()
    runner._block_until_ready([table])
    assert metrics.get_counter("readback.count") == before


# -- the runner cases of test_obs.py, test_timeline.py, test_metrics.py ---------

SMALL_KMEANS = {
    "stage": {
        "className": "org.apache.flink.ml.clustering.kmeans.KMeans",
        "paramMap": {"k": 2, "maxIter": 2},
    },
    "inputData": {
        "className": "org.apache.flink.ml.benchmark.datagenerator.common.DenseVectorGenerator",
        "paramMap": {"colNames": [["features"]], "numValues": 64, "vectorDim": 3},
    },
}


def test_benchmark_runner_embeds_metrics(jax_one_device):
    with config.use_device("cpu"):
        result = runner.run_benchmark("KMeans-obs", SMALL_KMEANS)
    want = jax_runner.run_benchmark("KMeans-obs", SMALL_KMEANS)
    embedded = result["metrics"]
    assert set(embedded) == set(want["metrics"]) == {"timers", "gauges", "counters"}
    assert embedded["counters"]["readback.count"] >= 1
    assert embedded["counters"]["readback.bytes"] > 0
    assert "benchmark.KMeans-obs.fit" in embedded["timers"]
    assert embedded["timers"]["iteration.dispatch"]["count"] == \
        want["metrics"]["timers"]["iteration.dispatch"]["count"] == 1
    json.dumps(result)


def test_runner_dispatch_gap_consistent_with_wall(jax_one_device):
    """dispatchGapMs is the work wall less hostDispatchMs within 5%, with
    gapCount and hostDispatchMs first-class and the timeline's attribution
    embedded when the recorder is on (a dense LR, a whole fit)."""
    entry = {
        "stage": {
            "className": "org.apache.flink.ml.classification.logisticregression."
                         "LogisticRegression",
            "paramMap": {"maxIter": 50, "globalBatchSize": 512},
        },
        "inputData": {
            "className": "org.apache.flink.ml.benchmark.datagenerator.common."
                         "LabeledPointWithWeightGenerator",
            "paramMap": {"colNames": [["features", "label", "weight"]], "numValues": 1024,
                         "vectorDim": 8},
        },
    }
    timeline.configure(ring_size=32768)
    try:
        with config.use_device("cpu"):
            result = runner.run_benchmark("LR-dispatch-gap", entry)
    finally:
        timeline.configure()
    want = jax_runner.run_benchmark("LR-dispatch-gap", entry)
    wall_ms = result["phaseTimesMs"].get("fit", 0.0) + result["phaseTimesMs"].get("transform", 0.0)
    assert result["gapCount"] == want["gapCount"] == 1
    assert result["hostDispatchMs"] > 0
    expected = wall_ms - result["hostDispatchMs"]
    assert abs(result["dispatchGapMs"] - expected) <= 0.05 * wall_ms + 1e-6
    attr = result["dispatchAttribution"]
    assert attr is not None and attr["gapCount"] == 1
    assert "chunks" not in attr
    json.dumps(result)


def test_benchmark_phase_breakdown():
    with config.use_device("cpu"):
        result = runner.run_benchmark("KMeans-phase", SMALL_KMEANS)
    assert set(result["phaseTimesMs"]) == {"datagen", "fit", "transform", "collect"}
    assert all(v >= 0.0 for v in result["phaseTimesMs"].values())
    assert "benchmark.KMeans-phase.fit" in metrics.snapshot()["timers"]


# -- the CLI ----------------------------------------------------------------------


def test_main_writes_the_jax_shape_and_bench_diff_reads_it(tmp_path, capsys):
    cfg = runner.load_config(DEMO)
    small = {"version": 1}
    for name in ("LogisticRegression-1", "Bucketizer-1"):
        small[name] = json.loads(json.dumps(cfg[name]))
        small[name]["inputData"]["paramMap"]["numValues"] = 2_048
    conf = tmp_path / "demo.json"
    conf.write_text(json.dumps(small))
    out = tmp_path / "r.json"
    with config.use_device("cpu"):
        runner.main([str(conf), "--output-file", str(out)])
    printed = capsys.readouterr().out
    assert "Found 2 benchmarks." in printed and "Benchmarks execution completed." in printed
    payload = json.loads(out.read_text())
    assert list(payload) == ["LogisticRegression-1", "Bucketizer-1"]
    for name, body in payload.items():
        assert set(body) == {"stage", "results"}
        assert body["stage"] == small[name]["stage"]
        assert set(body["results"]) == runner.RESULT_KEYS
        assert body["results"]["inputRecordNum"] == 2_048
    assert payload["LogisticRegression-1"]["results"]["gapCount"] == 1
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "bench_diff.py"),
                           str(out), str(out)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LogisticRegression-1" in proc.stdout


def test_main_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        runner.main([DEMO])


def _dispatches(fn):
    before = metrics.snapshot()
    fn()
    delta = metrics.snapshot_delta(before, metrics.snapshot())
    return delta["timers"].get("iteration.dispatch", {}).get("count", 0)


@pytest.mark.parametrize("mode", ["whole fit", "whole fit off", "checkpointed", "stream"])
def test_dispatch_timer_counts_each_launch(mode, tmp_path):
    """ROADMAP C.44: a fit through the funnel is one launch (with
    `config.whole_fit` on or off); a loop that stays eager counts its own,
    one a checkpointed chunk (chunks end at the boundaries) and one a
    stream epoch. With the timeline on, each launch is one `dispatch.chunk`
    event carrying its epoch range."""
    from flink_ml_tpu_torch import StreamTable, Table
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.random((400, 5))
    y = (X.sum(1) > 2.5).astype(float)
    est = LogisticRegression().set_max_iter(6).set_global_batch_size(100)
    expected = {"whole fit": 1, "whole fit off": 1, "checkpointed": 3, "stream": 6}[mode]

    def fit():
        if mode == "stream":
            est.fit(StreamTable.from_batches(
                [Table({"features": X[i:i + 100], "label": y[i:i + 100]})
                 for i in range(0, 400, 100)]))
        elif mode == "checkpointed":
            with config.iteration_checkpointing(str(tmp_path), 2):
                est.fit(Table({"features": X, "label": y}))
        else:
            est.fit(Table({"features": X, "label": y}))

    timeline.configure(ring_size=4096)
    saved = config.whole_fit
    config.whole_fit = "off" if mode == "whole fit off" else saved
    try:
        with config.use_device("cpu"):
            start_us = timeline.now_us()
            count = _dispatches(fit)
        events, _ = timeline.snapshot_events()
    finally:
        config.whole_fit = saved
        timeline.configure()
    launches = [e for e in events if e["tsUs"] >= start_us and e["name"] == "dispatch.chunk"]
    assert count == len(launches) == expected
    ends = [e["args"]["end"] for e in launches]
    assert ends == sorted(ends) and ends[-1] == 6
