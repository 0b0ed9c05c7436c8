"""The window runtime and Graph/GraphModel of the port against the JAX
package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor).

- Windows: the cases of tests/test_time_windows.py one for one (event-time
  row groups, `window_all_and_process` with a fake clock for processing
  time, AgglomerativeClustering per time window), each on both packages,
  equal; the descriptors' JSON both ways; `aggregate`, `map_partition` and
  `reduce`; a tensor table keeps its columns on its device through the
  windows.
- Graph: the cases of tests/test_graph.py one for one on both packages,
  outputs equal (an LR inside at the LR tolerances: coefficients rtol 1e-4,
  atol 1e-6); save/load both ways; a Graph fits twice (ROADMAP C.12); and
  the evaluation Graph (RandomSplitter -> StopWordsRemover -> HashingTF ->
  IDF fitted on the train part, transforming the test part -> LR ->
  BinaryClassificationEvaluator, with a model-data edge to a twin
  LogisticRegressionModel) at 20,000 rows: the split row for row, the LR
  at the LR tolerances, the metrics within 1e-5 of the JAX package's
  (C.11) and 1e-12 of the float64 oracle, the twin's predictions equal to
  the LR node's, the reloaded GraphModel bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import flink_ml_tpu.graph as jax_graph
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.common import window as jax_window
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import agglomerativeclustering as jax_agg
from flink_ml_tpu.models.evaluation import binaryclassification as jax_bce
from flink_ml_tpu.models.feature import hashingtf as jax_htf
from flink_ml_tpu.models.feature import idf as jax_idf
from flink_ml_tpu.models.feature import minmaxscaler as jax_mms
from flink_ml_tpu.models.feature import randomsplitter as jax_rs
from flink_ml_tpu.models.feature import standardscaler as jax_ss
from flink_ml_tpu.models.feature import stopwordsremover as jax_sw
from flink_ml_tpu.models.feature import vectorassembler as jax_va
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
from flink_ml_tpu.table import StreamTable as JaxStreamTable
from flink_ml_tpu.utils import datastream as jax_ds
import flink_ml_tpu_torch.graph as port_graph
from flink_ml_tpu_torch import StreamTable, Table, config
from flink_ml_tpu_torch.common import window as port_window
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.clustering import agglomerativeclustering as port_agg
from flink_ml_tpu_torch.models.evaluation import binaryclassification as port_bce
from flink_ml_tpu_torch.models.feature import hashingtf as port_htf
from flink_ml_tpu_torch.models.feature import idf as port_idf
from flink_ml_tpu_torch.models.feature import minmaxscaler as port_mms
from flink_ml_tpu_torch.models.feature import randomsplitter as port_rs
from flink_ml_tpu_torch.models.feature import standardscaler as port_ss
from flink_ml_tpu_torch.models.feature import stopwordsremover as port_sw
from flink_ml_tpu_torch.models.feature import vectorassembler as port_va
from flink_ml_tpu_torch.models.feature._stopwords import STOP_WORDS
from flink_ml_tpu_torch.table import DictTokenMatrix
from flink_ml_tpu_torch.utils import datastream as port_ds
from flink_ml_tpu_torch.utils import read_write

COEFF_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_TOL = 1e-5
ALL_METRICS = ("areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz")

#: one namespace per package, so each case builds the same thing on both
JAX = dict(graph=jax_graph, window=jax_window, ds=jax_ds, Table=JaxTable, StreamTable=JaxStreamTable,
           agg=jax_agg, ss=jax_ss, mms=jax_mms, va=jax_va, lr=jax_lr, rs=jax_rs, sw=jax_sw,
           htf=jax_htf, idf=jax_idf, bce=jax_bce)
PORT = dict(graph=port_graph, window=port_window, ds=port_ds, Table=Table, StreamTable=StreamTable,
            agg=port_agg, ss=port_ss, mms=port_mms, va=port_va, lr=port_lr, rs=port_rs, sw=port_sw,
            htf=port_htf, idf=port_idf, bce=port_bce)
PACKAGES = (JAX, PORT)


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _host(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


def _same_table(got, want):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        np.testing.assert_array_equal(_host(got.column(name)), np.asarray(want.column(name)),
                                      err_msg=name)


# -- event-time row groups (TestEventTimeGroups) ---------------------------------------

GROUP_CASES = {
    "tumbling_epoch_aligned": ([0, 5, 10, 14, 20, 999], lambda w: w.EventTimeTumblingWindows.of(10)),
    "tumbling_negative_timestamps": ([-1, -10, 1], lambda w: w.EventTimeTumblingWindows.of(10)),
    "session_gap_merging": ([0, 50, 300, 320, 1000], lambda w: w.EventTimeSessionWindows.with_gap(100)),
    "session_unsorted_rows": ([320, 0, 1000, 50, 300],
                              lambda w: w.EventTimeSessionWindows.with_gap(100)),
    "tumbling_unsorted_rows": ([35, 3, 17, 3, -4, 29, 12],
                               lambda w: w.EventTimeTumblingWindows.of(10)),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_event_time_groups_equal_jax(case):
    ts, make = GROUP_CASES[case]
    want = jax_ds.event_time_window_groups(np.asarray(ts), make(jax_window))
    got = port_ds.event_time_window_groups(np.asarray(ts), make(port_window))
    assert [g.tolist() for g in got] == [g.tolist() for g in want]
    assert all(g.dtype == np.int64 for g in got)


@pytest.mark.parametrize("bad", ["tumbling", "session"])
def test_event_time_groups_refuse_what_jax_refuses(bad):
    make = (lambda w: w.EventTimeTumblingWindows.of(0)) if bad == "tumbling" else \
        (lambda w: w.EventTimeSessionWindows.with_gap(0))
    for ds, w in ((jax_ds, jax_window), (port_ds, port_window)):
        with pytest.raises(ValueError):
            ds.event_time_window_groups(np.arange(3), make(w))
        with pytest.raises(TypeError):
            ds.event_time_window_groups(np.arange(3), w.CountTumblingWindows.of(2))


# -- window_all_and_process (TestWindowAllAndProcess) -------------------------------------


def _counts(pkg):
    return lambda w: pkg["Table"]({"n": np.array([w.num_rows]), "sum": np.array([float(
        np.sum(_host(w.column("x"))))])})


def _six_rows(pkg):
    return pkg["Table"]({"x": np.arange(6, dtype=np.float64), "timestamp": np.array([0, 5, 10, 15, 20, 25])})


def _batches(pkg, n, ts=None):
    return pkg["StreamTable"].from_batches([
        pkg["Table"]({"x": np.array([float(i)]), **({"timestamp": np.array([ts[i]])} if ts else {})})
        for i in range(n)])


def _window_case(case, pkg):
    """(input, windows, fn, clock) of each case of TestWindowAllAndProcess."""
    w = pkg["window"]
    if case == "event_tumbling_10":
        return _six_rows(pkg), w.EventTimeTumblingWindows.of(10), _counts(pkg), None
    if case == "event_tumbling_30":
        return _six_rows(pkg), w.EventTimeTumblingWindows.of(30), _counts(pkg), None
    if case == "event_session_on_stream":
        return _batches(pkg, 3, [0, 5, 500]), w.EventTimeSessionWindows.with_gap(100), _counts(pkg), None
    if case == "processing_tumbling_fake_clock":
        times = iter([0.0, 0.1, 5.0, 5.1])
        return (_batches(pkg, 4), w.ProcessingTimeTumblingWindows.of(1000), _counts(pkg),
                lambda: next(times))
    if case == "processing_session_fake_clock":
        times = iter([0.0, 0.05, 10.0])
        return (_batches(pkg, 3), w.ProcessingTimeSessionWindows.with_gap(1000), _counts(pkg),
                lambda: next(times))
    if case == "processing_bounded_table_one_window":
        return (pkg["Table"]({"x": np.arange(4, dtype=np.float64)}),
                w.ProcessingTimeTumblingWindows.of(10), _counts(pkg), None)
    if case == "count_windows_drop_the_tail":
        return _six_rows(pkg), w.CountTumblingWindows.of(4), _counts(pkg), None
    if case == "count_windows_on_stream":
        return _batches(pkg, 7), w.CountTumblingWindows.of(3), _counts(pkg), None
    if case == "global_on_stream":
        return _batches(pkg, 5), w.GlobalWindows(), _counts(pkg), None
    raise KeyError(case)


WINDOW_CASES = ["event_tumbling_10", "event_tumbling_30", "event_session_on_stream",
                "processing_tumbling_fake_clock", "processing_session_fake_clock",
                "processing_bounded_table_one_window", "count_windows_drop_the_tail",
                "count_windows_on_stream", "global_on_stream"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_all_and_process_equals_jax(case):
    outs = []
    for pkg in PACKAGES:
        data, windows, fn, clock = _window_case(case, pkg)
        outs.append(pkg["ds"].window_all_and_process(data, windows, fn, clock=clock))
    want, got = outs
    assert isinstance(got, StreamTable) == isinstance(want, JaxStreamTable)
    if isinstance(want, JaxStreamTable):
        want, got = list(want), list(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_table(g, w)
    else:
        _same_table(got, want)


def test_event_windows_require_a_timestamp_column():
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="timestamp"):
            pkg["ds"].window_all_and_process(pkg["Table"]({"x": np.arange(3)}),
                                             pkg["window"].EventTimeTumblingWindows.of(10), lambda w: w)


def test_a_tensor_table_stays_on_its_device_through_the_windows():
    rng = np.random.default_rng(0)
    ts = rng.permutation(np.repeat(np.arange(5) * 100, 8))
    X = rng.random((40, 3)).astype(np.float32)
    seen = []

    def fn(w):
        seen.append(w)
        return w

    out = port_ds.window_all_and_process(
        Table({"x": torch.from_numpy(X), "timestamp": torch.from_numpy(ts)}),
        port_window.EventTimeTumblingWindows.of(100), fn)
    assert all(isinstance(w.column("x"), torch.Tensor) for w in seen)
    order = np.concatenate(jax_ds.event_time_window_groups(ts, jax_window.EventTimeTumblingWindows.of(100)))
    np.testing.assert_array_equal(out.column("x").numpy(), X[order])


def test_aggregate_map_partition_and_reduce_equal_jax():
    chunks = [np.arange(i, i + 4, dtype=np.float64) for i in range(0, 12, 4)]
    results = []
    for pkg in PACKAGES:
        stream = pkg["StreamTable"].from_batches([pkg["Table"]({"x": c}) for c in chunks])
        total = pkg["ds"].aggregate(stream, lambda: 0.0,
                                    lambda acc, b: acc + float(np.sum(_host(b.column("x")))),
                                    lambda acc: acc * 2)
        doubled = [np.asarray(t.column("x")) for t in pkg["ds"].map_partition(
            stream, lambda b: pkg["Table"]({"x": _host(b.column("x")) * 2}))]
        folded = pkg["ds"].reduce(stream, lambda a, b: a.concat(b))
        results.append((total, doubled, np.asarray(_host(folded.column("x")))))
    (t1, d1, f1), (t2, d2, f2) = results
    assert t1 == t2 and all(np.array_equal(a, b) for a, b in zip(d1, d2))
    np.testing.assert_array_equal(f1, f2)
    with pytest.raises(ValueError):
        port_ds.reduce(StreamTable.from_batches([]), lambda a, b: a)


WINDOWS = [lambda w: w.GlobalWindows(), lambda w: w.CountTumblingWindows.of(7),
           lambda w: w.EventTimeTumblingWindows.of(100), lambda w: w.ProcessingTimeTumblingWindows.of(50),
           lambda w: w.EventTimeSessionWindows.with_gap(30),
           lambda w: w.ProcessingTimeSessionWindows.with_gap(9)]


@pytest.mark.parametrize("which", range(len(WINDOWS)))
def test_windows_json_both_ways(which):
    make = WINDOWS[which]
    port, jax_w = make(port_window), make(jax_window)
    assert port.json_encode() == jax_w.json_encode()
    assert port.json_encode()["class"].startswith("org.apache.flink.ml.common.window.")
    assert port_window.Windows.json_decode(jax_w.json_encode()) == port
    assert jax_window.Windows.json_decode(port.json_encode()) == jax_w
    with pytest.raises(ValueError):
        port_window.Windows.json_decode({"class": "Nope"})


# -- AgglomerativeClustering per time window (TestAgglomerativeTimeWindows) ---------------


def _blob_table(pkg):
    """3 time groups of 4 rows; in each, two tight pairs far apart."""
    rng = np.random.RandomState(0)
    X = rng.rand(12, 2) * 0.01
    X[::2] += 5.0
    return pkg["Table"]({"features": X, "timestamp": np.repeat([0, 1000, 2000], 4)})


def _unsorted_table(pkg):
    X = np.array([[100.0, 100.0], [0.0, 0.0], [101.0, 101.0], [1.0, 1.0]])
    return pkg["Table"]({"features": X, "timestamp": np.array([1000, 0, 1000, 0])})


AGG_WINDOW_CASES = {
    "event_tumbling_small": (_blob_table, 2, lambda w: w.EventTimeTumblingWindows.of(500)),
    "event_tumbling_big": (_blob_table, 2, lambda w: w.EventTimeTumblingWindows.of(5000)),
    "event_session": (_blob_table, 2, lambda w: w.EventTimeSessionWindows.with_gap(500)),
    "processing_time_is_global": (_blob_table, 2, lambda w: w.ProcessingTimeTumblingWindows.of(1000)),
    "unsorted_timestamps": (_unsorted_table, 1, lambda w: w.EventTimeTumblingWindows.of(500)),
    "count_windows": (_blob_table, 2, lambda w: w.CountTumblingWindows.of(5)),
}


@pytest.mark.parametrize("case", sorted(AGG_WINDOW_CASES))
def test_agglomerative_time_windows_equal_jax(case):
    make_table, k, make_windows = AGG_WINDOW_CASES[case]
    outs = []
    for pkg in PACKAGES:
        stage = pkg["agg"].AgglomerativeClustering().set_num_clusters(k) \
            .set_windows(make_windows(pkg["window"]))
        outs.append(stage.transform(make_table(pkg)))
    (jo, jm), (po, pm) = outs
    _same_table(po, jo)
    _same_table(pm, jm)


# -- Graph (tests/test_graph.py) ------------------------------------------------------------


def _train_table(pkg):
    rng = np.random.RandomState(0)
    X = np.vstack([rng.randn(100, 4) + 2, rng.randn(100, 4) - 2])
    return pkg["Table"]({"features": X, "label": np.array([1.0] * 100 + [0.0] * 100)})


def _scaler_lr_graph(pkg, max_iter=20):
    b = pkg["graph"].GraphBuilder()
    source = b.create_table_id()
    scaled = b.add_estimator(pkg["ss"].StandardScaler().set_input_col("features")
                             .set_output_col("scaled"), [source])
    outputs = b.add_estimator(pkg["lr"].LogisticRegression().set_features_col("scaled")
                              .set_max_iter(max_iter), [scaled[0]])
    return b.build_estimator([source], [outputs[0]])


def _same_lr_output(got, want):
    np.testing.assert_array_equal(_host(got.column("prediction")), np.asarray(want.column("prediction")))
    np.testing.assert_allclose(_host(got.column("rawPrediction")),
                               np.asarray(want.column("rawPrediction")), **COEFF_TOL)


def test_chained_estimators_equal_jax():
    outs = []
    for pkg in PACKAGES:
        model = _scaler_lr_graph(pkg).fit(_train_table(pkg))
        assert isinstance(model, pkg["graph"].GraphModel)
        outs.append((model, model.transform(_train_table(pkg))[0]))
    (jm, jo), (pm, po) = outs
    _same_lr_output(po, jo)
    assert (_host(po.column("prediction")) == _host(po.column("label"))).mean() > 0.95
    np.testing.assert_allclose(pm.nodes[1].stage.coefficient, np.asarray(jm._nodes[1].stage.coefficient),
                               **COEFF_TOL)


def test_algo_operator_nodes_equal_jax():
    outs = []
    for pkg in PACKAGES:
        b = pkg["graph"].GraphBuilder()
        source = b.create_table_id()
        outputs = b.add_algo_operator(pkg["va"].VectorAssembler().set_input_cols("a", "b")
                                      .set_output_col("vec"), source)
        op = b.build_algo_operator([source], [outputs[0]])
        outs.append(op.transform(pkg["Table"]({"a": [1.0, 2.0], "b": [3.0, 4.0]}))[0])
    _same_table(outs[1], outs[0])
    np.testing.assert_array_equal(_host(outs[1].column("vec")), [[1, 3], [2, 4]])


def _model_data_graph(pkg):
    b = pkg["graph"].GraphBuilder()
    source = b.create_table_id()
    scaler = pkg["mms"].MinMaxScaler()
    b.add_estimator(scaler, [source])
    model_data = b.get_model_data_from_estimator(scaler)
    consumer = pkg["mms"].MinMaxScalerModel()
    b.set_model_data_on_model(consumer, model_data[0])
    outputs = b.add_algo_operator(consumer, source)
    return b.build_estimator([source], [outputs[0]])


def test_model_data_edges_equal_jax():
    outs = []
    for pkg in PACKAGES:
        t = pkg["Table"]({"input": np.arange(10, dtype=np.float64)[:, None]})
        outs.append(_model_data_graph(pkg).fit(t).transform(t)[0])
    _same_table(outs[1], outs[0])
    np.testing.assert_allclose(_host(outs[1].column("output"))[:, 0], np.arange(10) / 9.0, atol=1e-7)


@pytest.mark.parametrize("direction", ["same", "jax_to_port", "port_to_jax"])
def test_save_load_graph(direction, tmp_path):
    saver, loader = {"same": (PORT, PORT), "jax_to_port": (JAX, PORT),
                     "port_to_jax": (PORT, JAX)}[direction]
    path = str(tmp_path / "graph")
    _scaler_lr_graph(saver, max_iter=10).save(path)
    loaded = loader["graph"].Graph.load(path)
    out = loaded.fit(_train_table(loader)).transform(_train_table(loader))[0]
    want = _scaler_lr_graph(JAX, max_iter=10).fit(_train_table(JAX)).transform(_train_table(JAX))[0]
    assert "prediction" in out.column_names
    _same_lr_output(out, want) if loader is PORT else _same_lr_output(
        _scaler_lr_graph(PORT, max_iter=10).fit(_train_table(PORT)).transform(_train_table(PORT))[0],
        out)
    if saver is PORT:
        import json
        with open(f"{path}/metadata") as f:
            assert json.load(f)["className"] == "org.apache.flink.ml.builder.Graph"


@pytest.mark.parametrize("direction", ["same", "jax_to_port", "port_to_jax"])
def test_save_load_graph_model(direction, tmp_path):
    saver, loader = {"same": (PORT, PORT), "jax_to_port": (JAX, PORT),
                     "port_to_jax": (PORT, JAX)}[direction]
    model = _scaler_lr_graph(saver, max_iter=10).fit(_train_table(saver))
    expected = model.transform(_train_table(saver))[0]
    path = str(tmp_path / "graph_model")
    model.save(path)
    loaded = loader["graph"].GraphModel.load(path)
    got = loaded.transform(_train_table(loader))[0]
    if saver is loader:  # bit for bit
        for name in ("prediction", "rawPrediction"):
            np.testing.assert_array_equal(_host(got.column(name)), _host(expected.column(name)))
    else:  # the other package's float32 arithmetic: the LR tolerances
        _same_lr_output(got, expected)
    if loader is PORT:
        assert isinstance(read_write.load_stage(path), port_graph.GraphModel)


def test_unsatisfiable_graph_raises_as_in_jax():
    for pkg in PACKAGES:
        b = pkg["graph"].GraphBuilder()
        source = b.create_table_id()
        dangling = b.create_table_id()  # never produced
        outputs = b.add_estimator(pkg["ss"].StandardScaler(), [dangling])
        graph = b.build_estimator([source], [outputs[0]])
        with pytest.raises(ValueError, match="unsatisfiable"):
            graph.fit(pkg["Table"]({"input": [[1.0]]}))


def test_duplicate_stage_rejected_as_in_jax():
    for pkg in PACKAGES:
        b = pkg["graph"].GraphBuilder()
        source = b.create_table_id()
        scaler = pkg["ss"].StandardScaler()
        b.add_estimator(scaler, [source])
        with pytest.raises(ValueError, match="already added"):
            b.add_estimator(scaler, [source])


def test_a_graph_fits_twice_and_keeps_its_estimators():
    """ROADMAP C.12: the JAX package's fit puts the fitted models into the
    Graph's own nodes, so its second fit fails; the port's Graph is left as
    it was."""
    jax_g = _scaler_lr_graph(JAX)
    jax_g.fit(_train_table(JAX))
    with pytest.raises(AttributeError):
        jax_g.fit(_train_table(JAX))
    graph = _scaler_lr_graph(PORT)
    first = graph.fit(_train_table(PORT)).transform(_train_table(PORT))[0]
    second = graph.fit(_train_table(PORT)).transform(_train_table(PORT))[0]
    assert all(isinstance(n.stage, (port_ss.StandardScaler, port_lr.LogisticRegression))
               for n in graph._nodes)
    np.testing.assert_array_equal(first.column("rawPrediction"), second.column("rawPrediction"))


def test_get_model_data_of_a_graph_model():
    for pkg in PACKAGES:
        b = pkg["graph"].GraphBuilder()
        source = b.create_table_id()
        scaler = pkg["mms"].MinMaxScaler()
        b.add_estimator(scaler, [source])
        data = b.get_model_data_from_estimator(scaler)
        model = b.build_estimator([source], [source], output_model_data=[data[0]]).fit(
            pkg["Table"]({"input": np.arange(6, dtype=np.float64)[:, None]}))
        (table,) = model.get_model_data()
        assert sorted(table.column_names) == ["maxVector", "minVector"]


# -- the evaluation Graph -------------------------------------------------------------------

ROWS, TOKENS, TERMS, STOPS = 20_000, 20, 200, 30
NUM_FEATURES = 1 << 12


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    vocab = np.asarray(list(STOP_WORDS["english"][:STOPS]) + [f"term{i}" for i in range(TERMS - STOPS)])
    ids = rng.integers(0, TERMS, (ROWS, TOKENS)).astype(np.int32)
    ids[rng.random((ROWS, TOKENS)) < 0.05] = -1
    weight = np.where(np.arange(TERMS) < STOPS, 0.0, np.random.default_rng(100).standard_normal(TERMS))
    score = np.where(ids >= 0, weight[np.maximum(ids, 0)], 0.0).sum(axis=1)
    score += 1.5 * rng.standard_normal(ROWS)
    return vocab, ids, (score > np.median(score)).astype(np.float64)


def eval_graph(pkg):
    """RandomSplitter (0.8, 0.2) -> StopWordsRemover and HashingTF on each
    part -> IDF fitted on the train part, transforming the test part (a
    twin IDF carries the train features) -> LR fitted on the train
    features, transforming the test features -> the evaluator; the LR's
    model data feeds a twin LogisticRegressionModel on the test features."""
    b = pkg["graph"].GraphBuilder()
    source = b.create_table_id()
    train, test = b.add_algo_operator(pkg["rs"].RandomSplitter().set_weights(0.8, 0.2).set_seed(37),
                                      source)[:2]

    def tf(part):
        words = b.add_algo_operator(pkg["sw"].StopWordsRemover().set_input_cols("tokens")
                                    .set_output_cols("words"), part)[0]
        return b.add_algo_operator(pkg["htf"].HashingTF().set_input_col("words").set_output_col("tf")
                                   .set_num_features(NUM_FEATURES), words)[0]

    tf_train, tf_test = tf(train), tf(test)

    def idf():
        return pkg["idf"].IDF().set_input_col("tf").set_output_col("features")

    feats_test = b.add_estimator(idf(), [tf_train], [tf_test])[0]
    feats_train = b.add_estimator(idf(), [tf_train], [tf_train])[0]
    lr = pkg["lr"].LogisticRegression().set_max_iter(20).set_global_batch_size(2_000) \
        .set_learning_rate(0.5)
    pred = b.add_estimator(lr, [feats_train], [feats_test])[0]
    twin = pkg["lr"].LogisticRegressionModel()
    b.set_model_data_on_model(twin, b.get_model_data_from_estimator(lr)[0])
    twin_pred = b.add_algo_operator(twin, feats_test)[0]
    metrics = b.add_algo_operator(pkg["bce"].BinaryClassificationEvaluator()
                                  .set_metrics_names(*ALL_METRICS), pred)[0]
    return b.build_estimator([source], [metrics, pred, twin_pred])


@pytest.fixture(scope="module")
def graph_run():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            vocab, ids, label = _corpus()
            tables = (JaxTable({"tokens": JaxDictTokenMatrix(vocab, jax.device_put(ids)), "label": label}),
                      Table({"tokens": DictTokenMatrix(vocab, torch.from_numpy(ids.copy())),
                             "label": torch.from_numpy(label.astype(np.float32))}))
            runs = []
            for pkg, table in zip(PACKAGES, tables):
                model = eval_graph(pkg).fit(table)
                metrics, pred, twin = model.transform(table)
                runs.append(dict(table=table, model=model, pred=pred, twin=twin,
                                 metrics={k: float(v) for k, v in metrics.collect()[0].items()}))
            return runs


def _lr_node(model):
    nodes = model.nodes if hasattr(model, "nodes") else model._nodes
    return next(n.stage for n in nodes if type(n.stage).__name__ == "LogisticRegressionModel"
                and n.estimator_input_ids is not None)


def test_eval_graph_splits_and_fits_as_jax(graph_run):
    jax_run, port_run = graph_run
    assert port_run["pred"].num_rows == jax_run["pred"].num_rows
    np.testing.assert_array_equal(_host(port_run["pred"].column("tokens").ids),
                                  np.asarray(jax_run["pred"].column("tokens").ids))
    np.testing.assert_allclose(_lr_node(port_run["model"]).coefficient,
                               np.asarray(_lr_node(jax_run["model"]).coefficient), **COEFF_TOL)


def test_eval_graph_metrics_match_jax_and_the_oracle(graph_run):
    jax_run, port_run = graph_run
    for name in ALL_METRICS:
        assert abs(port_run["metrics"][name] - jax_run["metrics"][name]) < METRIC_TOL, name
    scores = _host(port_run["pred"].column("rawPrediction"))[:, 1].astype(np.float64)
    labels = _host(port_run["pred"].column("label")).astype(np.float64)
    oracle = jax_bce._binary_metrics(scores, labels, np.ones_like(labels))
    for name in ALL_METRICS:
        assert abs(port_run["metrics"][name] - oracle[name]) < 1e-12, name
    assert port_run["metrics"]["areaUnderROC"] > 0.8


def test_eval_graph_twin_model_equals_the_lr_node(graph_run):
    for run in graph_run:
        for name in ("prediction", "rawPrediction"):
            np.testing.assert_array_equal(_host(run["twin"].column(name)), _host(run["pred"].column(name)))


def test_eval_graph_reloads_bit_for_bit(graph_run, tmp_path):
    _, port_run = graph_run
    port_run["model"].save(str(tmp_path / "gm"))
    metrics, pred, twin = port_graph.GraphModel.load(str(tmp_path / "gm")).transform(port_run["table"])
    assert torch.equal(pred.column("rawPrediction"), port_run["pred"].column("rawPrediction"))
    assert torch.equal(twin.column("rawPrediction"), port_run["twin"].column("rawPrediction"))
    assert {k: float(v) for k, v in metrics.collect()[0].items()} == port_run["metrics"]


def test_eval_graph_saved_by_the_port_runs_in_jax(graph_run, tmp_path):
    jax_run, port_run = graph_run
    port_run["model"].save(str(tmp_path / "gm"))
    metrics, pred, _ = jax_graph.GraphModel.load(str(tmp_path / "gm")).transform(jax_run["table"])
    np.testing.assert_allclose(np.asarray(pred.column("rawPrediction")),
                               _host(port_run["pred"].column("rawPrediction")), rtol=1e-5, atol=1e-6)
