"""The text path of the port against the JAX package's:
StopWordsRemover -> HashingTF -> IDF -> LogisticRegression on a
`DictTokenMatrix`, the path on which the port's two sparse kernels train
and predict on features the library made itself.

The same seeded numpy ids (3,000 rows of 20 tokens over 200 terms, the
first 30 of them English stop words) and planted labels go into both
Pipelines: the JAX side holds the ids as a `jax.Array` on a one-device
mesh, the port as a CPU tensor under `config.use_device("cpu")`. The
stages before the LR are exact (their tests are test_torch_text_stages.py),
so the LR sees equal features; it is held to the LR tolerances of the
other LR paths: coefficients rtol 1e-4, atol 1e-6 (float32 sums in
another order); rawPrediction atol 1e-5; equal predictions. Both the
fitted PipelineModel and its reload, in either package, predict the same.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Pipeline as JaxPipeline
from flink_ml_tpu import PipelineModel as JaxPipelineModel
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.feature import hashingtf as jax_htf
from flink_ml_tpu.models.feature import idf as jax_idf
from flink_ml_tpu.models.feature import stopwordsremover as jax_sw
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import DictTokenMatrix as JaxDictTokenMatrix
from flink_ml_tpu_torch import Pipeline, PipelineModel, SparseBatch, Table, config
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.feature import hashingtf as port_htf
from flink_ml_tpu_torch.models.feature import idf as port_idf
from flink_ml_tpu_torch.models.feature import stopwordsremover as port_sw
from flink_ml_tpu_torch.models.feature._stopwords import STOP_WORDS
from flink_ml_tpu_torch.table import DictTokenMatrix

COEFF_TOL = dict(rtol=1e-4, atol=1e-6)
RAW_TOL = dict(rtol=0, atol=1e-5)
ROWS, TOKENS, TERMS, STOPS = 3000, 20, 200, 30
NUM_FEATURES = 1 << 12
WEIGHT_SEED = 100


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _corpus(seed=0, rows=ROWS):
    """A vocabulary whose first STOPS terms are English stop words, ids
    with a few holes, and labels planted on the non-stop terms: 1 when a
    row's sum of term weights (seeded once for every corpus) is above the
    median."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray(list(STOP_WORDS["english"][:STOPS]) +
                       [f"term{i}" for i in range(TERMS - STOPS)])
    ids = rng.integers(0, TERMS, (rows, TOKENS)).astype(np.int32)
    ids[rng.random((rows, TOKENS)) < 0.05] = -1
    weight = np.where(np.arange(TERMS) < STOPS, 0.0,
                      np.random.default_rng(WEIGHT_SEED).standard_normal(TERMS))
    score = np.where(ids >= 0, weight[np.maximum(ids, 0)], 0.0).sum(axis=1)
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


def _tables(vocab, ids, label=None):
    jax_cols = {"tokens": JaxDictTokenMatrix(vocab, jax.device_put(ids))}
    port_cols = {"tokens": DictTokenMatrix(vocab, torch.from_numpy(ids.copy()))}
    if label is not None:
        jax_cols["label"] = label
        port_cols["label"] = label.copy()
    return JaxTable(jax_cols), Table(port_cols)


def _predictions(table):
    raw = table.column("rawPrediction")
    raw = np.stack([np.asarray(v.to_array() if hasattr(v, "to_array") else v) for v in raw]) \
        if isinstance(raw, np.ndarray) and raw.dtype == object else np.asarray(raw)
    pred = table.column("prediction")
    pred = pred.numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
    return raw, pred


@pytest.fixture(scope="module")
def fitted():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            vocab, ids, label = _corpus()
            jax_pipe, port_pipe = _pipelines()
            jax_train, port_train = _tables(vocab, ids, label)
            return jax_pipe.fit(jax_train), port_pipe.fit(port_train), (vocab, ids, label)


def test_text_pipeline_fit_matches_jax(fitted):
    jax_model, port_model, _ = fitted
    np.testing.assert_allclose(port_model.stages[-1].coefficient,
                               np.asarray(jax_model.stages[-1].coefficient), **COEFF_TOL)
    np.testing.assert_array_equal(port_model.stages[2].idf, np.asarray(jax_model.stages[2].idf))


def test_text_pipeline_features_are_device_sparse_batches(fitted):
    """The IDF output that the LR trains on is a SparseBatch on the ids'
    device: int32 indices, float32 values, as wide as the JAX package's."""
    jax_model, port_model, (vocab, ids, _) = fitted
    jax_in, port_in = _tables(vocab, ids)
    for jax_stage, port_stage in zip(jax_model.stages[:3], port_model.stages[:3]):
        jax_in, port_in = jax_stage.transform(jax_in)[0], port_stage.transform(port_in)[0]
    jax_feats, port_feats = jax_in.column("features"), port_in.column("features")
    assert isinstance(port_feats, SparseBatch) and isinstance(port_feats.indices, torch.Tensor)
    assert port_feats.indices.dtype == torch.int32 and port_feats.values.dtype == torch.float32
    np.testing.assert_array_equal(port_feats.indices.numpy(), np.asarray(jax_feats.indices))
    np.testing.assert_array_equal(port_feats.values.numpy(), np.asarray(jax_feats.values))


def test_text_pipeline_transform_matches_jax(fitted):
    jax_model, port_model, _ = fitted
    vocab, ids, label = _corpus(seed=1, rows=800)
    jax_in, port_in = _tables(vocab, ids)
    want_raw, want_pred = _predictions(jax_model.transform(jax_in)[0])
    got_raw, got_pred = _predictions(port_model.transform(port_in)[0])
    np.testing.assert_allclose(got_raw, want_raw, **RAW_TOL)
    np.testing.assert_array_equal(got_pred, want_pred)
    assert (got_pred == label).mean() > 0.7


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_text_pipeline_model_loads_across_packages(fitted, tmp_path, direction):
    jax_model, port_model, _ = fitted
    vocab, ids, _ = _corpus(seed=2, rows=300)
    jax_in, port_in = _tables(vocab, ids)
    path = str(tmp_path / "pm")
    if direction == "jax_to_port":
        jax_model.save(path)
        got = _predictions(PipelineModel.load(path).transform(port_in)[0])
        want = _predictions(jax_model.transform(jax_in)[0])
    else:
        port_model.save(path)
        got = _predictions(port_model.transform(port_in)[0])
        want = _predictions(JaxPipelineModel.load(path).transform(jax_in)[0])
    np.testing.assert_allclose(got[0], want[0], **RAW_TOL)
    np.testing.assert_array_equal(got[1], want[1])


def test_text_pipeline_reload_predicts_bit_for_bit(fitted, tmp_path):
    _, port_model, _ = fitted
    vocab, ids, _ = _corpus(seed=3, rows=300)
    _, port_in = _tables(vocab, ids)
    port_model.save(str(tmp_path / "pm"))
    again = PipelineModel.load(str(tmp_path / "pm"))
    for a, b in zip(_predictions(port_model.transform(port_in)[0]),
                    _predictions(again.transform(port_in)[0])):
        np.testing.assert_array_equal(a, b)
