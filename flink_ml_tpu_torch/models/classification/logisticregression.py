"""LogisticRegression: binary logistic classifier trained with mini-batch SGD.

Port of flink_ml_tpu/models/classification/logisticregression.py (the
reference's LogisticRegression.java:60 and LogisticRegressionModel.java:
64,131-168). Training runs the one-device SGD engine (ops/optimizer.py);
inference is one matvec (dense) or one sparse row-dot kernel (SparseBatch)
plus the sigmoid over the whole table.

Tensor features give tensor predictions on their device; host features
are staged to `config.device()` and give float64 numpy predictions, read
back in one transfer.
"""

from __future__ import annotations

import torch

from ...api import Estimator, Model
from ...common.param import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasMultiClass,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasTol,
    HasWeightCol,
)
from ...ops.losses import BINARY_LOGISTIC_LOSS
from ...table import Table
from ...utils import javacodec
from ...utils.param_utils import update_existing_params
from .. import _linear


class LogisticRegressionModelParams(
    HasFeaturesCol, HasPredictionCol, HasRawPredictionCol
):
    pass


class LogisticRegressionParams(
    LogisticRegressionModelParams,
    HasLabelCol,
    HasWeightCol,
    HasMaxIter,
    HasReg,
    HasElasticNet,
    HasLearningRate,
    HasGlobalBatchSize,
    HasTol,
    HasMultiClass,
):
    pass


def _predict_from_dot(dot):
    """dot >= 0 -> label 1; rawPrediction = [1-p, p], p = sigmoid(dot)
    (LogisticRegressionModel.predictOneDataPoint:165-168)."""
    prob = 1.0 - 1.0 / (1.0 + torch.exp(dot))
    pred = torch.where(dot >= 0, 1.0, 0.0).to(dot.dtype)
    raw = torch.stack([1.0 - prob, prob], dim=1)
    return pred, raw


def _load_reference(path: str):
    """The coefficient of a reference-written LogisticRegressionModelData
    (its modelVersion is dropped, as the JAX package drops it); None
    without part files."""
    loaded = javacodec.load_reference_logisticregression(path)
    return None if loaded is None else loaded[0]


class LogisticRegressionModel(
    _linear.CoefficientModelData, Model, LogisticRegressionModelParams
):
    _load_reference = staticmethod(_load_reference)

    def transform_kernel(self, consts, cols, ctx):
        dot = _linear.raw_scores(cols[self.get_features_col()], consts["coefficient"])
        cols[self.get_prediction_col()], cols[self.get_raw_prediction_col()] = _predict_from_dot(dot)
        return cols


class LogisticRegression(Estimator, LogisticRegressionParams):
    """Estimator (LogisticRegression.java:60)."""

    # fits through run_sgd: checkpointed SGD under config.iteration_checkpoint_dir
    checkpointable = True

    def fit(self, *inputs: Table) -> LogisticRegressionModel:
        (table,) = inputs
        if self.get_multi_class() == "multinomial":
            raise ValueError(
                "Multinomial classification is not supported yet. "
                "Supported options: [auto, binomial]."
            )
        coeff, _, _ = _linear.run_sgd(
            self, table, BINARY_LOGISTIC_LOSS, self.get_weight_col(),
            validate_binomial=True,
        )
        model = LogisticRegressionModel()
        model.coefficient = coeff
        update_existing_params(model, self)
        return model
