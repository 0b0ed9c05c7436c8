"""The Has* param mixins LogisticRegression uses.

Port of the matching mixins of flink_ml_tpu/common/param.py (the
reference's common/param/Has*.java): same param names, defaults and
validators, so saved param maps cross-load between the packages.
"""

from __future__ import annotations

from ..param import IntParam, FloatParam, ParamValidators, StringParam, WithParams


class HasFeaturesCol(WithParams):
    FEATURES_COL = StringParam(
        "featuresCol", "Features column name.", "features", ParamValidators.not_null()
    )

    def get_features_col(self) -> str:
        return self.get(self.FEATURES_COL)

    def set_features_col(self, value: str):
        return self.set(self.FEATURES_COL, value)


class HasLabelCol(WithParams):
    LABEL_COL = StringParam(
        "labelCol", "Label column name.", "label", ParamValidators.not_null()
    )

    def get_label_col(self) -> str:
        return self.get(self.LABEL_COL)

    def set_label_col(self, value: str):
        return self.set(self.LABEL_COL, value)


class HasPredictionCol(WithParams):
    PREDICTION_COL = StringParam(
        "predictionCol", "Prediction column name.", "prediction", ParamValidators.not_null()
    )

    def get_prediction_col(self) -> str:
        return self.get(self.PREDICTION_COL)

    def set_prediction_col(self, value: str):
        return self.set(self.PREDICTION_COL, value)


class HasRawPredictionCol(WithParams):
    RAW_PREDICTION_COL = StringParam(
        "rawPredictionCol", "Raw prediction column name.", "rawPrediction"
    )

    def get_raw_prediction_col(self) -> str:
        return self.get(self.RAW_PREDICTION_COL)

    def set_raw_prediction_col(self, value: str):
        return self.set(self.RAW_PREDICTION_COL, value)


class HasWeightCol(WithParams):
    WEIGHT_COL = StringParam("weightCol", "Weight column name.", None)

    def get_weight_col(self):
        return self.get(self.WEIGHT_COL)

    def set_weight_col(self, value: str):
        return self.set(self.WEIGHT_COL, value)


class HasMaxIter(WithParams):
    MAX_ITER = IntParam("maxIter", "Maximum number of iterations.", 20, ParamValidators.gt(0))

    def get_max_iter(self) -> int:
        return self.get(self.MAX_ITER)

    def set_max_iter(self, value: int):
        return self.set(self.MAX_ITER, value)


class HasReg(WithParams):
    REG = FloatParam("reg", "Regularization parameter.", 0.0, ParamValidators.gt_eq(0.0))

    def get_reg(self) -> float:
        return self.get(self.REG)

    def set_reg(self, value: float):
        return self.set(self.REG, value)


class HasElasticNet(WithParams):
    ELASTIC_NET = FloatParam(
        "elasticNet",
        "ElasticNet parameter: 0 = L2 penalty, 1 = L1 penalty.",
        0.0,
        ParamValidators.in_range(0.0, 1.0),
    )

    def get_elastic_net(self) -> float:
        return self.get(self.ELASTIC_NET)

    def set_elastic_net(self, value: float):
        return self.set(self.ELASTIC_NET, value)


class HasLearningRate(WithParams):
    LEARNING_RATE = FloatParam("learningRate", "Learning rate.", 0.1, ParamValidators.gt(0.0))

    def get_learning_rate(self) -> float:
        return self.get(self.LEARNING_RATE)

    def set_learning_rate(self, value: float):
        return self.set(self.LEARNING_RATE, value)


class HasGlobalBatchSize(WithParams):
    GLOBAL_BATCH_SIZE = IntParam(
        "globalBatchSize",
        "Global batch size of training algorithms.",
        32,
        ParamValidators.gt(0),
    )

    def get_global_batch_size(self) -> int:
        return self.get(self.GLOBAL_BATCH_SIZE)

    def set_global_batch_size(self, value: int):
        return self.set(self.GLOBAL_BATCH_SIZE, value)


class HasTol(WithParams):
    TOL = FloatParam(
        "tol", "Convergence tolerance for iterative algorithms.", 1e-6, ParamValidators.gt_eq(0.0)
    )

    def get_tol(self) -> float:
        return self.get(self.TOL)

    def set_tol(self, value: float):
        return self.set(self.TOL, value)


class HasMultiClass(WithParams):
    AUTO = "auto"
    BINOMIAL = "binomial"
    MULTINOMIAL = "multinomial"
    MULTI_CLASS = StringParam(
        "multiClass",
        "Classification type.",
        "auto",
        ParamValidators.in_array(["auto", "binomial", "multinomial"]),
    )

    def get_multi_class(self) -> str:
        return self.get(self.MULTI_CLASS)

    def set_multi_class(self, value: str):
        return self.set(self.MULTI_CLASS, value)
