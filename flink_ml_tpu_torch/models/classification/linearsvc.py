"""LinearSVC: linear support vector classifier trained with mini-batch SGD.

Port of flink_ml_tpu/models/classification/linearsvc.py (the reference's
LinearSVC.java, LinearSVCModel.java:137-173 and LinearSVCModelParams.java:
36-52). Training runs the SGD engine on the default mesh (one device, or
every rank of a world on its own rows) with the hinge loss and
{0, 1} labels; a SparseBatch trains on the sparse kernels and is never
densified. The prediction thresholds the raw dot, and rawPrediction is
[dot, -dot].

Tensor features give tensor predictions on their device; host features
are staged to `config.device()` and give float64 numpy predictions, read
back in one transfer.
"""

from __future__ import annotations

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
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasTol,
    HasWeightCol,
)
from ...ops.losses import HINGE_LOSS
from ...param import FloatParam
from ...table import Table
from ...utils.param_utils import update_existing_params
from .. import _linear


class LinearSVCModelParams(HasFeaturesCol, HasPredictionCol, HasRawPredictionCol):
    THRESHOLD = FloatParam(
        "threshold",
        "Threshold in binary classification prediction applied to rawPrediction.",
        0.0,
    )

    def get_threshold(self) -> float:
        return self.get(self.THRESHOLD)

    def set_threshold(self, value: float):
        return self.set(self.THRESHOLD, value)


class LinearSVCParams(
    LinearSVCModelParams,
    HasLabelCol,
    HasWeightCol,
    HasMaxIter,
    HasReg,
    HasElasticNet,
    HasLearningRate,
    HasGlobalBatchSize,
    HasTol,
):
    pass


def _predict_from_dot(dot, threshold: float):
    """prediction = dot >= threshold ? 1 : 0, the threshold compared in the
    dot's dtype; rawPrediction = [dot, -dot]
    (LinearSVCModel.predictOneDataPoint:170-173)."""
    pred = (dot >= threshold).to(dot.dtype)
    raw = torch.stack([dot, -dot], dim=1)
    return pred, raw


class LinearSVCModel(_linear.CoefficientModelData, Model, LinearSVCModelParams):
    def _kernel_constants(self):
        return {
            "coefficient": np.asarray(self.coefficient, np.float32),
            "threshold": np.float32(self.get_threshold()),
        }

    def transform_kernel(self, consts, cols, ctx):
        dot = _linear.raw_scores(cols[self.get_features_col()], consts["coefficient"])
        pred, raw = _predict_from_dot(dot, consts["threshold"])
        cols[self.get_prediction_col()], cols[self.get_raw_prediction_col()] = pred, raw
        return cols


class LinearSVC(Estimator, LinearSVCParams):
    """Estimator (LinearSVC.java)."""

    # fits through run_sgd: checkpointed SGD under config.iteration_checkpoint_dir
    checkpointable = True

    def fit(self, *inputs: Table) -> LinearSVCModel:
        (table,) = inputs
        coeff, _, _ = _linear.run_sgd(
            self, table, HINGE_LOSS, self.get_weight_col(), validate_binomial=True
        )
        model = LinearSVCModel()
        model.coefficient = coeff
        update_existing_params(model, self)
        return model
