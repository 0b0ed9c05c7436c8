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

from typing import List

import numpy as np
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
from ...linalg import DenseVector
from ...ops.losses import BINARY_LOGISTIC_LOSS
from ...table import Table
from ...utils import read_write
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


class LogisticRegressionModel(Model, LogisticRegressionModelParams):
    def __init__(self):
        self.coefficient: np.ndarray = None  # (d,) host array

    def set_model_data(self, *inputs: Table) -> "LogisticRegressionModel":
        (model_data,) = inputs
        rows = model_data.collect()
        self.coefficient = np.asarray(rows[0]["coefficient"].to_array(), dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"coefficient": [DenseVector(self.coefficient)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_features_col())
        coeff = torch.as_tensor(
            np.asarray(self.coefficient), dtype=torch.float32,
            device=_linear.column_device(col),
        )
        pred, raw = _predict_from_dot(_linear.raw_scores(col, coeff))
        if _linear.is_device_column(col):
            cols = {self.get_prediction_col(): pred, self.get_raw_prediction_col(): raw}
        else:
            # one packed readback: [pred | raw[:, 0] | raw[:, 1]]
            host = torch.cat([pred, raw.T.reshape(-1)]).cpu().numpy().astype(np.float64)
            n = pred.shape[0]
            cols = {
                self.get_prediction_col(): host[:n],
                self.get_raw_prediction_col(): host[n:].reshape(2, n).T.copy(),
            }
        return [table.with_columns(cols)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, coefficient=self.coefficient)

    def _load_extra(self, path: str) -> None:
        self.coefficient = read_write.load_model_arrays(path)["coefficient"]


class LogisticRegression(Estimator, LogisticRegressionParams):
    """Estimator (LogisticRegression.java:60)."""

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
