"""UnivariateFeatureSelector — selects features by univariate statistical tests.

Port of flink_ml_tpu/models/feature/univariatefeatureselector.py (the
reference's UnivariateFeatureSelector.java:305 and its model). The test
follows featureType x labelType: categorical + categorical is the
chi-square test, continuous + categorical the ANOVA F-test, continuous +
continuous the F-value test (ops/stats.py, each on its device or host
branch). selectionMode is numTopFeatures, percentile, fpr, fdr
(Benjamini-Hochberg) or fwe, with a default threshold for each. The model
is the selected indices; its transform gathers them
(`vectorslicer.select_columns`), where the JAX device path multiplies by a
0/1 matrix and spreads NaN and inf across a row (ROADMAP C.10).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasFeaturesCol, HasLabelCol, HasOutputCol
from ...ops import stats
from ...param import DoubleParam, ParamValidators, StringParam
from ...table import Table, as_dense_matrix
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from . import _columns
from .vectorslicer import select_columns

CATEGORICAL = "categorical"
CONTINUOUS = "continuous"
NUM_TOP_FEATURES = "numTopFeatures"
PERCENTILE = "percentile"
FPR = "fpr"
FDR = "fdr"
FWE = "fwe"

_DEFAULT_THRESHOLDS = {
    NUM_TOP_FEATURES: 50,
    PERCENTILE: 0.1,
    FPR: 0.05,
    FDR: 0.05,
    FWE: 0.05,
}


class UnivariateFeatureSelectorModelParams(HasFeaturesCol, HasOutputCol):
    pass


class UnivariateFeatureSelectorParams(UnivariateFeatureSelectorModelParams, HasLabelCol):
    FEATURE_TYPE = StringParam(
        "featureType",
        "The feature type.",
        None,
        ParamValidators.in_array([CATEGORICAL, CONTINUOUS]),
    )
    LABEL_TYPE = StringParam(
        "labelType",
        "The label type.",
        None,
        ParamValidators.in_array([CATEGORICAL, CONTINUOUS]),
    )
    SELECTION_MODE = StringParam(
        "selectionMode",
        "The feature selection mode.",
        NUM_TOP_FEATURES,
        ParamValidators.in_array([NUM_TOP_FEATURES, PERCENTILE, FPR, FDR, FWE]),
    )
    SELECTION_THRESHOLD = DoubleParam(
        "selectionThreshold",
        "The upper bound of the features that selector will select.",
        None,
    )

    def get_feature_type(self):
        return self.get(self.FEATURE_TYPE)

    def set_feature_type(self, value: str):
        return self.set(self.FEATURE_TYPE, value)

    def get_label_type(self):
        return self.get(self.LABEL_TYPE)

    def set_label_type(self, value: str):
        return self.set(self.LABEL_TYPE, value)

    def get_selection_mode(self) -> str:
        return self.get(self.SELECTION_MODE)

    def set_selection_mode(self, value: str):
        return self.set(self.SELECTION_MODE, value)

    def get_selection_threshold(self):
        return self.get(self.SELECTION_THRESHOLD)

    def set_selection_threshold(self, value: float):
        return self.set(self.SELECTION_THRESHOLD, value)


def select_indices_from_p_values(
    p_values: np.ndarray, mode: str, threshold: float
) -> np.ndarray:
    """SelectIndicesFromPValuesOperator logic."""
    d = p_values.shape[0]
    order = np.argsort(p_values, kind="stable")
    if mode == NUM_TOP_FEATURES:
        return np.sort(order[: int(threshold)])
    if mode == PERCENTILE:
        return np.sort(order[: int(d * threshold)])
    if mode == FPR:
        return np.nonzero(p_values < threshold)[0]
    if mode == FDR:
        # Benjamini-Hochberg: largest k with p_(k) < (alpha/d)*k — strict
        # comparison AND this exact operand order, matching
        # UnivariateFeatureSelector.java:236-238 bit for bit on boundary
        # p-values ((alpha/d)*k can differ from (k/d)*alpha by 1 ulp).
        sorted_p = p_values[order]
        ks = np.nonzero(sorted_p < (threshold / d) * np.arange(1, d + 1))[0]
        if ks.size == 0:
            return np.asarray([], dtype=np.int64)
        return np.sort(order[: ks[-1] + 1])
    if mode == FWE:
        return np.nonzero(p_values < threshold / d)[0]
    raise ValueError(f"Unsupported selection mode {mode!r}")


class UnivariateFeatureSelectorModel(Model, UnivariateFeatureSelectorModelParams):
    fusable = True

    def __init__(self):
        self.indices: np.ndarray = None

    def _constant_sources(self):
        return (self.indices,)

    def _kernel_constants(self):
        return {"indices": np.asarray(self.indices, dtype=np.int64)}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_features_col()])
        # a gather, not the JAX device path's 0/1 matmul (C.10)
        cols[self.get_output_col()] = select_columns(X, self.indices, consts["indices"])
        return cols

    def set_model_data(self, *inputs: Table) -> "UnivariateFeatureSelectorModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.indices = np.asarray(row["indices"], dtype=np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"indices": [self.indices.tolist()]})]

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_matrix)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, indices=self.indices)

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_univariatefeatureselector)
        self.indices = np.asarray(arrays["indices"], dtype=np.int64)


class UnivariateFeatureSelector(Estimator, UnivariateFeatureSelectorParams):

    checkpointable = False
    checkpoint_reason = "single-pass statistical test over the input; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> UnivariateFeatureSelectorModel:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        feature_type = self.get_feature_type()
        label_type = self.get_label_type()
        if feature_type is None or label_type is None:
            raise ValueError("featureType and labelType must be set")
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        y_col = table.column(self.get_label_col())
        # a tensor label stays where it is: the device branches use it there
        y = y_col if isinstance(y_col, torch.Tensor) else np.asarray(y_col, dtype=np.float64)
        if feature_type == CATEGORICAL and label_type == CATEGORICAL:
            p_values, _, _ = stats.chi_square_test(X, y)
        elif feature_type == CONTINUOUS and label_type == CATEGORICAL:
            p_values, _, _ = stats.anova_f_test(X, y)
        elif feature_type == CONTINUOUS and label_type == CONTINUOUS:
            p_values, _, _ = stats.f_value_test(X, y)
        else:
            raise ValueError(
                f"Unsupported combination of featureType {feature_type!r} "
                f"and labelType {label_type!r}."
            )
        threshold = self.get_selection_threshold()
        mode = self.get_selection_mode()
        if threshold is None:
            threshold = _DEFAULT_THRESHOLDS[mode]
        elif mode == NUM_TOP_FEATURES:
            # UnivariateFeatureSelector.java:168-181 validation
            if int(threshold) != threshold or threshold < 1:
                raise ValueError(
                    "SelectionThreshold needs to be a positive integer for "
                    f"selection mode {mode}."
                )
        elif not 0.0 <= threshold <= 1.0:
            raise ValueError(
                f"SelectionThreshold needs to be in the range [0, 1] for "
                f"selection mode {mode}."
            )
        model = UnivariateFeatureSelectorModel()
        model.indices = select_indices_from_p_values(p_values, mode, float(threshold))
        update_existing_params(model, self)
        return model
