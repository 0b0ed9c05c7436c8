"""RandomSplitter, the split -> fit -> evaluate text path and the column
functions of the port against the JAX package's.

The same seeded numpy inputs go to both packages: the JAX side on a
one-device mesh (a device column is a `jax.Array`), the port under
`config.use_device("cpu")` (a device column is a CPU tensor).
Tolerances:

- RandomSplitter: row for row equal on dense, SparseBatch and
  DictTokenMatrix columns, each as a device column or in numpy;
- the path RandomSplitter(0.8, 0.2) -> StopWordsRemover -> HashingTF ->
  IDF -> LogisticRegression fitted on the train part -> transform of the
  test part -> BinaryClassificationEvaluator: the LR at the tolerances of
  the other LR paths (coefficients rtol 1e-4, atol 1e-6), the four
  metrics within 1e-5 of the JAX package's (its float32 evaluator; the
  port's sums are float64, ROADMAP C.11);
- `vector_to_array` / `array_to_vector`: equal outputs and round trips.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Pipeline as JaxPipeline
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import functions as jax_functions
from flink_ml_tpu.linalg import DenseVector as JaxDenseVector
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.evaluation import binaryclassification as jax_bce
from flink_ml_tpu.models.feature import hashingtf as jax_htf
from flink_ml_tpu.models.feature import idf as jax_idf
from flink_ml_tpu.models.feature import randomsplitter as jax_rs
from flink_ml_tpu.models.feature import stopwordsremover as jax_sw
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
import flink_ml_tpu_torch
from flink_ml_tpu_torch import DenseVector, Pipeline, PipelineModel, SparseBatch, Table, config
from flink_ml_tpu_torch import functions as port_functions
from flink_ml_tpu_torch.api import Stage
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.evaluation import binaryclassification as port_bce
from flink_ml_tpu_torch.models.feature import hashingtf as port_htf
from flink_ml_tpu_torch.models.feature import idf as port_idf
from flink_ml_tpu_torch.models.feature import randomsplitter as port_rs
from flink_ml_tpu_torch.models.feature import stopwordsremover as port_sw
from flink_ml_tpu_torch.models.feature._stopwords import STOP_WORDS
from flink_ml_tpu_torch.table import DictTokenMatrix

COEFF_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_TOL = 1e-5
ALL_METRICS = ("areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz")
ROWS, TOKENS, TERMS, STOPS = 4_000, 20, 200, 30
NUM_FEATURES = 1 << 12
WEIGHT_SEED = 100


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _host(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


# -- RandomSplitter ---------------------------------------------------------------

LAYOUTS = ["dense", "sparse", "tokens"]


def _split_tables(layout, device, n=1_001, seed=0):
    """(JAX table, port table, the row ids): a features column of the
    layout, a row-id column, and a label."""
    rng = np.random.default_rng(seed)
    row_id = np.arange(n, dtype=np.float64)
    if layout == "dense":
        X = rng.random((n, 3)).astype(np.float32)
        jcol, pcol = (jax.device_put(X), torch.from_numpy(X.copy())) if device else (X, X.copy())
    elif layout == "sparse":
        idx = rng.integers(-1, 50, (n, 4)).astype(np.int32)
        vals = rng.random((n, 4)).astype(np.float32)
        if device:
            jcol = JaxSparseBatch(50, jax.device_put(idx), jax.device_put(vals))
            pcol = SparseBatch(50, torch.from_numpy(idx.copy()), torch.from_numpy(vals.copy()))
        else:
            jcol, pcol = JaxSparseBatch(50, idx, vals), SparseBatch(50, idx.copy(), vals.copy())
    else:
        vocab = np.asarray([f"t{i}" for i in range(30)])
        ids = rng.integers(-1, 30, (n, 5)).astype(np.int32)
        jcol = JaxDictTokenMatrix(vocab, jax.device_put(ids) if device else ids)
        pcol = DictTokenMatrix(vocab, torch.from_numpy(ids.copy()) if device else ids.copy())
    label = (rng.random(n) > 0.5).astype(np.float64)
    return (JaxTable({"f": jcol, "id": row_id, "label": label}),
            Table({"f": pcol, "id": row_id.copy(), "label": label.copy()}))


def _same_column(got, want):
    if isinstance(got, SparseBatch):
        assert got.size == want.size
        np.testing.assert_array_equal(_host(got.indices), np.asarray(want.indices))
        np.testing.assert_array_equal(_host(got.values), np.asarray(want.values))
    elif isinstance(got, DictTokenMatrix):
        np.testing.assert_array_equal(got.vocab, want.vocab)
        np.testing.assert_array_equal(_host(got.ids), np.asarray(want.ids))
    else:
        np.testing.assert_array_equal(_host(got), np.asarray(want))


@pytest.mark.parametrize("weights,seed", [((0.8, 0.2), 7), ((1.0, 1.0), 0), ((3.0, 1.0, 2.0), 2**40 + 3),
                                          ((0.1, 0.1, 0.1, 0.7), -5)])
@pytest.mark.parametrize("device", [True, False], ids=["device", "numpy"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_random_splitter_equals_jax_row_for_row(layout, device, weights, seed):
    jax_table, port_table = _split_tables(layout, device)
    want = jax_rs.RandomSplitter().set_weights(*weights).set_seed(seed).transform(jax_table)
    got = port_rs.RandomSplitter().set_weights(*weights).set_seed(seed).transform(port_table)
    assert len(got) == len(want) == len(weights)
    assert sum(t.num_rows for t in got) == port_table.num_rows
    for g, w in zip(got, want):
        assert g.num_rows == w.num_rows
        for name in ("f", "id", "label"):
            _same_column(g.column(name), w.column(name))
        f = g.column("f")
        held = f.indices if isinstance(f, SparseBatch) else f.ids if isinstance(f, DictTokenMatrix) else f
        assert isinstance(held, torch.Tensor) == device  # a device column stays on its device


def test_random_splitter_default_params_are_jax_s(tmp_path):
    port, jax_stage = port_rs.RandomSplitter(), jax_rs.RandomSplitter()
    assert port.get_weights() == jax_stage.get_weights() == [1.0, 1.0]
    assert port.get_seed() == jax_stage.get_seed()
    with pytest.raises(ValueError):
        port_rs.RandomSplitter().set_weights(1.0)
    with pytest.raises(ValueError):
        port_rs.RandomSplitter().set_weights(1.0, 0.0)
    port.set_weights(2.0, 1.0).set_seed(9).save(str(tmp_path / "s"))
    assert jax_rs.RandomSplitter.load(str(tmp_path / "s")).get_weights() == [2.0, 1.0]
    assert Stage.load(str(tmp_path / "s")).get_seed() == 9


def test_split_assignments_are_the_numpy_draw():
    assign = port_rs.split_assignments(10_000, [0.8, 0.2], 7)
    draws = np.random.RandomState(7).random_sample(10_000)
    np.testing.assert_array_equal(assign, (draws >= 0.8).astype(np.int64))


# -- the split -> fit -> evaluate path ---------------------------------------------


def _corpus(seed=0, rows=ROWS):
    """A vocabulary whose first STOPS terms are English stop words, ids
    with a few holes, and labels planted on the non-stop terms: 1 when a
    row's sum of term weights plus noise is above the median."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray(list(STOP_WORDS["english"][:STOPS]) +
                       [f"term{i}" for i in range(TERMS - STOPS)])
    ids = rng.integers(0, TERMS, (rows, TOKENS)).astype(np.int32)
    ids[rng.random((rows, TOKENS)) < 0.05] = -1
    weight = np.where(np.arange(TERMS) < STOPS, 0.0,
                      np.random.default_rng(WEIGHT_SEED).standard_normal(TERMS))
    score = np.where(ids >= 0, weight[np.maximum(ids, 0)], 0.0).sum(axis=1)
    score += 1.5 * rng.standard_normal(rows)
    label = (score > np.median(score)).astype(np.float64)
    return vocab, ids, label


def _pipelines():
    stages = []
    for sw, htf, idf, lr in ((jax_sw, jax_htf, jax_idf, jax_lr),
                             (port_sw, port_htf, port_idf, port_lr)):
        stages.append([
            sw.StopWordsRemover().set_input_cols("tokens").set_output_cols("words"),
            htf.HashingTF().set_input_col("words").set_output_col("tf")
            .set_num_features(NUM_FEATURES),
            idf.IDF().set_input_col("tf").set_output_col("features"),
            lr.LogisticRegression().set_max_iter(20).set_global_batch_size(500)
            .set_learning_rate(0.5),
        ])
    return JaxPipeline(stages[0]), Pipeline(stages[1])


def _evaluators():
    return [m.BinaryClassificationEvaluator().set_metrics_names(*ALL_METRICS) for m in (jax_bce, port_bce)]


@pytest.fixture(scope="module")
def path_run():
    """Both packages through split -> fit -> transform -> evaluate."""
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            vocab, ids, label = _corpus()
            jax_table = JaxTable({"tokens": JaxDictTokenMatrix(vocab, jax.device_put(ids)), "label": label})
            port_table = Table({"tokens": DictTokenMatrix(vocab, torch.from_numpy(ids.copy())),
                                "label": torch.from_numpy(label.astype(np.float32))})
            runs = []
            for splitter, pipe, ev, table in zip(
                    (jax_rs.RandomSplitter(), port_rs.RandomSplitter()), _pipelines(), _evaluators(),
                    (jax_table, port_table)):
                train, test = splitter.set_weights(0.8, 0.2).set_seed(13).transform(table)
                model = pipe.fit(train)
                out = model.transform(test)[0]
                metrics = {k: float(v) for k, v in ev.transform(out)[0].collect()[0].items()}
                runs.append(dict(train=train, test=test, model=model, out=out, metrics=metrics))
            return runs


def test_eval_path_splits_equally(path_run):
    jax_run, port_run = path_run
    for part in ("train", "test"):
        np.testing.assert_array_equal(_host(port_run[part].column("tokens").ids),
                                      np.asarray(jax_run[part].column("tokens").ids))
        np.testing.assert_array_equal(_host(port_run[part].column("label")),
                                      np.asarray(jax_run[part].column("label"), np.float32))
    assert port_run["train"].num_rows + port_run["test"].num_rows == ROWS


def test_eval_path_fit_matches_jax(path_run):
    jax_run, port_run = path_run
    np.testing.assert_allclose(port_run["model"].stages[-1].coefficient,
                               np.asarray(jax_run["model"].stages[-1].coefficient), **COEFF_TOL)


def test_eval_path_metrics_match_jax(path_run):
    jax_run, port_run = path_run
    for name in ALL_METRICS:
        assert abs(port_run["metrics"][name] - jax_run["metrics"][name]) < METRIC_TOL, name
    assert port_run["metrics"]["areaUnderROC"] > 0.8


def test_eval_path_metrics_equal_the_float64_oracle(path_run):
    """The port's metrics on its own held-out scores equal the float64
    oracle fed the same float32 scores (C.11)."""
    _, port_run = path_run
    scores = _host(port_run["out"].column("rawPrediction"))[:, 1].astype(np.float64)
    labels = _host(port_run["out"].column("label")).astype(np.float64)
    oracle = jax_bce._binary_metrics(scores, labels, np.ones_like(labels))
    for name in ALL_METRICS:
        assert abs(port_run["metrics"][name] - oracle[name]) < 1e-12, name


def test_eval_path_reload_evaluates_bit_for_bit(path_run, tmp_path):
    _, port_run = path_run
    port_run["model"].save(str(tmp_path / "pm"))
    again = PipelineModel.load(str(tmp_path / "pm")).transform(port_run["test"])[0]
    assert torch.equal(again.column("rawPrediction"), port_run["out"].column("rawPrediction"))
    metrics = _evaluators()[1].transform(again)[0].collect()[0]
    assert {k: float(v) for k, v in metrics.items()} == port_run["metrics"]


# -- functions.py -------------------------------------------------------------------------


def _function_inputs():
    """name -> (JAX column, port column)."""
    rng = np.random.default_rng(3)
    X = rng.random((6, 3))
    ragged = [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]]
    idx = np.asarray([[0, 2], [1, -1], [3, 0]], np.int32)
    vals = np.asarray([[1.5, 2.5], [3.5, 0.0], [4.5, 5.5]])
    return {
        "matrix": (X, X.copy()),
        "float32_matrix": (X.astype(np.float32), X.astype(np.float32)),
        "device_matrix": (jax.device_put(X.astype(np.float32)), torch.from_numpy(X.astype(np.float32))),
        "sparse": (JaxSparseBatch(4, idx, vals), SparseBatch(4, idx.copy(), vals.copy())),
        "vectors": (np.asarray([JaxDenseVector(r) for r in X] + [None], dtype=object)[:-1],
                    np.asarray([DenseVector(r) for r in X] + [None], dtype=object)[:-1]),
        "ragged_vectors": (np.asarray([JaxDenseVector(r) for r in ragged] + [None], dtype=object)[:-1],
                           np.asarray([DenseVector(r) for r in ragged] + [None], dtype=object)[:-1]),
        "lists": ([list(r) for r in X], [list(r) for r in X]),
        "ragged_lists": (np.asarray(ragged + [None], dtype=object)[:-1],
                         np.asarray(ragged + [None], dtype=object)[:-1]),
    }


def _as_rows(col):
    if isinstance(col, np.ndarray) and col.dtype == object:
        return [list(v.to_array()) if hasattr(v, "to_array") else list(v) for v in col]
    return _host(col).tolist()


@pytest.mark.parametrize("fn", ["vector_to_array", "array_to_vector"])
@pytest.mark.parametrize("name", sorted(_function_inputs()))
def test_functions_equal_jax(name, fn):
    jax_col, port_col = _function_inputs()[name]
    if fn == "array_to_vector" and name == "sparse":  # not an array column: both refuse it
        pytest.raises(TypeError, getattr(jax_functions, fn), jax_col)
        pytest.raises(TypeError, getattr(port_functions, fn), port_col)
        return
    want = getattr(jax_functions, fn)(jax_col)
    got = getattr(port_functions, fn)(port_col)
    assert _as_rows(got) == _as_rows(want)
    assert isinstance(got, torch.Tensor) == (name == "device_matrix")
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape


@pytest.mark.parametrize("name", ["matrix", "device_matrix", "vectors", "ragged_vectors", "lists"])
def test_functions_round_trip(name):
    _, col = _function_inputs()[name]
    back = port_functions.vector_to_array(port_functions.array_to_vector(port_functions.vector_to_array(col)))
    assert _as_rows(back) == _as_rows(port_functions.vector_to_array(col))
    if name == "device_matrix":
        assert back is col  # a tensor passes through


def test_functions_are_exported_as_in_jax():
    assert flink_ml_tpu_torch.vector_to_array is port_functions.vector_to_array
    assert flink_ml_tpu_torch.array_to_vector is port_functions.array_to_vector
    assert {"vector_to_array", "array_to_vector"} <= set(flink_ml_tpu_torch.__all__)
    with pytest.raises(ValueError):
        port_functions.vector_to_array(np.zeros(3))
    with pytest.raises(ValueError):
        port_functions.array_to_vector(np.zeros(3))
