"""LinearRegression: least-squares linear model trained with mini-batch SGD.

Port of flink_ml_tpu/models/regression/linearregression.py (the
reference's LinearRegression.java:48 and LinearRegressionModel.java:
146-160). Training runs the one-device SGD engine with the least-square
loss; a SparseBatch trains on the sparse kernels and is never densified.
The prediction is the raw dot: one matvec (dense) or one sparse row-dot
kernel (SparseBatch).

Tensor features give a tensor prediction on their device; host features
are staged to `config.device()` and give a float64 numpy prediction.
"""

from __future__ import annotations

from ...api import Estimator, Model
from ...common.param import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasReg,
    HasTol,
    HasWeightCol,
)
from ...ops.losses import LEAST_SQUARE_LOSS
from ...table import Table
from ...utils.param_utils import update_existing_params
from .. import _linear


class LinearRegressionModelParams(HasFeaturesCol, HasPredictionCol):
    pass


class LinearRegressionParams(
    LinearRegressionModelParams,
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


class LinearRegressionModel(
    _linear.CoefficientModelData, Model, LinearRegressionModelParams
):
    def transform_kernel(self, consts, cols, ctx):
        cols[self.get_prediction_col()] = _linear.raw_scores(
            cols[self.get_features_col()], consts["coefficient"])
        return cols


class LinearRegression(Estimator, LinearRegressionParams):
    """Estimator (LinearRegression.java:48)."""

    # fits through run_sgd: checkpointed SGD under config.iteration_checkpoint_dir
    checkpointable = True

    def fit(self, *inputs: Table) -> LinearRegressionModel:
        (table,) = inputs
        coeff, _, _ = _linear.run_sgd(self, table, LEAST_SQUARE_LOSS, self.get_weight_col())
        model = LinearRegressionModel()
        model.coefficient = coeff
        update_existing_params(model, self)
        return model
