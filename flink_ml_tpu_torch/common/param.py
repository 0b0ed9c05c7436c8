"""The Has* param mixins of the ported stages.

Port of the matching mixins of flink_ml_tpu/common/param.py (the
reference's common/param/Has*.java): same param names, defaults and
validators, so saved param maps cross-load between the packages.
"""

from __future__ import annotations

from ..param import (
    BooleanParam,
    FloatParam,
    IntParam,
    LongParam,
    ParamValidators,
    StringArrayParam,
    StringParam,
    WindowsParam,
    WithParams,
)
from .window import GlobalWindows


class HasRelativeError(WithParams):
    RELATIVE_ERROR = FloatParam(
        "relativeError",
        "The relative target precision for the approximate quantile algorithm.",
        0.001,
        ParamValidators.in_range(0.0, 1.0),
    )

    def get_relative_error(self) -> float:
        return self.get(self.RELATIVE_ERROR)

    def set_relative_error(self, value: float):
        return self.set(self.RELATIVE_ERROR, value)


class HasMissingValue(WithParams):
    MISSING_VALUE = FloatParam(
        "missingValue", "The placeholder for the missing values.", float("nan")
    )

    def get_missing_value(self) -> float:
        return self.get(self.MISSING_VALUE)

    def set_missing_value(self, value: float):
        return self.set(self.MISSING_VALUE, value)


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


class HasSeed(WithParams):
    SEED = LongParam("seed", "The random seed.", None)

    def get_seed(self) -> int:
        """The seed, or 0 when it is unset."""
        seed = self.get(self.SEED)
        return seed if seed is not None else 0

    def set_seed(self, value: int):
        return self.set(self.SEED, value)


class HasBatchStrategy(WithParams):
    COUNT_STRATEGY = "count"
    BATCH_STRATEGY = StringParam(
        "batchStrategy", "Strategy to create mini batch from online train data.", "count",
        ParamValidators.in_array(["count"]),
    )

    def get_batch_strategy(self) -> str:
        return self.get(self.BATCH_STRATEGY)


class HasDecayFactor(WithParams):
    DECAY_FACTOR = FloatParam(
        "decayFactor", "The forgetfulness of the previous centroids.", 0.0,
        ParamValidators.in_range(0.0, 1.0),
    )

    def get_decay_factor(self) -> float:
        return self.get(self.DECAY_FACTOR)

    def set_decay_factor(self, value: float):
        return self.set(self.DECAY_FACTOR, value)


class HasModelVersionCol(WithParams):
    MODEL_VERSION_COL = StringParam(
        "modelVersionCol", "Model version column name.", "modelVersion"
    )

    def get_model_version_col(self):
        return self.get(self.MODEL_VERSION_COL)

    def set_model_version_col(self, value: str):
        return self.set(self.MODEL_VERSION_COL, value)


class HasDistanceMeasure(WithParams):
    DISTANCE_MEASURE = StringParam(
        "distanceMeasure",
        "Distance measure. Supported options: 'euclidean', 'manhattan' and 'cosine'.",
        "euclidean",
        ParamValidators.in_array(["euclidean", "manhattan", "cosine"]),
    )

    def get_distance_measure(self) -> str:
        return self.get(self.DISTANCE_MEASURE)

    def set_distance_measure(self, value: str):
        return self.set(self.DISTANCE_MEASURE, value)


class HasHandleInvalid(WithParams):
    ERROR_INVALID = "error"
    SKIP_INVALID = "skip"
    KEEP_INVALID = "keep"
    HANDLE_INVALID = StringParam(
        "handleInvalid",
        "Strategy to handle invalid entries.",
        "error",
        ParamValidators.in_array(["error", "skip", "keep"]),
    )

    def get_handle_invalid(self) -> str:
        return self.get(self.HANDLE_INVALID)

    def set_handle_invalid(self, value: str):
        return self.set(self.HANDLE_INVALID, value)


class HasInputCol(WithParams):
    INPUT_COL = StringParam("inputCol", "Input column name.", "input", ParamValidators.not_null())

    def get_input_col(self) -> str:
        return self.get(self.INPUT_COL)

    def set_input_col(self, value: str):
        return self.set(self.INPUT_COL, value)


class HasInputCols(WithParams):
    INPUT_COLS = StringArrayParam(
        "inputCols", "Input column names.", None, ParamValidators.non_empty_array()
    )

    def get_input_cols(self):
        return self.get(self.INPUT_COLS)

    def set_input_cols(self, *values: str):
        return self.set(self.INPUT_COLS, list(values))


class HasOutputCol(WithParams):
    OUTPUT_COL = StringParam(
        "outputCol", "Output column name.", "output", ParamValidators.not_null()
    )

    def get_output_col(self) -> str:
        return self.get(self.OUTPUT_COL)

    def set_output_col(self, value: str):
        return self.set(self.OUTPUT_COL, value)


class HasOutputCols(WithParams):
    OUTPUT_COLS = StringArrayParam(
        "outputCols", "Output column names.", None, ParamValidators.non_empty_array()
    )

    def get_output_cols(self):
        return self.get(self.OUTPUT_COLS)

    def set_output_cols(self, *values: str):
        return self.set(self.OUTPUT_COLS, list(values))


class HasNumFeatures(WithParams):
    NUM_FEATURES = IntParam(
        "numFeatures", "Number of features.", 262144, ParamValidators.gt(0)
    )

    def get_num_features(self) -> int:
        return self.get(self.NUM_FEATURES)

    def set_num_features(self, value: int):
        return self.set(self.NUM_FEATURES, value)


class HasCategoricalCols(WithParams):
    CATEGORICAL_COLS = StringArrayParam(
        "categoricalCols", "Categorical column names.", []
    )

    def get_categorical_cols(self):
        return self.get(self.CATEGORICAL_COLS) or []

    def set_categorical_cols(self, *values: str):
        return self.set(self.CATEGORICAL_COLS, list(values))


class HasFlatten(WithParams):
    FLATTEN = BooleanParam(
        "flatten",
        "If false, the returned table contains only a single row of aggregate data; "
        "otherwise one row per item.",
        False,
    )

    def get_flatten(self) -> bool:
        return self.get(self.FLATTEN)

    def set_flatten(self, value: bool):
        return self.set(self.FLATTEN, value)


class HasWindows(WithParams):
    WINDOWS = WindowsParam(
        "windows",
        "Windowing strategy that determines how to create mini-batches from input data.",
        GlobalWindows(),
    )

    def get_windows(self):
        return self.get(self.WINDOWS)

    def set_windows(self, value):
        return self.set(self.WINDOWS, value)
