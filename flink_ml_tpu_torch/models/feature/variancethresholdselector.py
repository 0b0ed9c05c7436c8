"""VarianceThresholdSelector: removes low-variance features.

Port of flink_ml_tpu/models/feature/variancethresholdselector.py (the
reference's VarianceThresholdSelector.java and
VarianceThresholdSelectorModel.java: a feature whose sample variance is
not above varianceThreshold is dropped; the model is the kept indices).
The fit is one two-pass variance on the device (the column mean, then the
sum of squared deviations over max(n - 1, 1)), in float32 for a host
column as the JAX package's `jnp.asarray` gives it, in its own dtype for a
tensor. The transform is an exact gather of the kept columns on the
column's device; when every column is kept it returns the column itself,
as a selection of all columns needs no copy.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...param import DoubleParam, ParamValidators
from ...table import Table
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from . import _columns
from .vectorslicer import select_columns


class VarianceThresholdSelectorModelParams(HasInputCol, HasOutputCol):
    pass


class VarianceThresholdSelectorParams(VarianceThresholdSelectorModelParams):
    VARIANCE_THRESHOLD = DoubleParam(
        "varianceThreshold",
        "Features with a variance not greater than this threshold will be removed.",
        0.0,
        ParamValidators.gt_eq(0.0),
    )

    def get_variance_threshold(self) -> float:
        return self.get(self.VARIANCE_THRESHOLD)

    def set_variance_threshold(self, value: float):
        return self.set(self.VARIANCE_THRESHOLD, value)


def sample_variance(X: torch.Tensor) -> torch.Tensor:
    n = X.shape[0]
    mean = torch.mean(X, dim=0)
    return torch.sum((X - mean) ** 2, dim=0) / max(n - 1, 1)


class VarianceThresholdSelectorModel(Model, VarianceThresholdSelectorModelParams):
    fusable = True

    def __init__(self):
        self.indices: np.ndarray = None  # the kept feature indices

    def _constant_sources(self):
        return (self.indices,)

    def _kernel_constants(self):
        return {"indices": np.asarray(self.indices, dtype=np.int64)}

    def _check_width(self, width: int) -> None:
        if self.indices.size > 0 and self.indices.max() >= width:
            raise ValueError("Model feature count does not match input vector size")

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        self._check_width(X.shape[1])
        # a gather, not the JAX device path's 0/1 matmul (C.10)
        cols[self.get_output_col()] = select_columns(X, self.indices, consts["indices"])
        return cols

    def set_model_data(self, *inputs: Table) -> "VarianceThresholdSelectorModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.indices = np.asarray(row["indices"], dtype=np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"indices": [self.indices.tolist()]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_matrix)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, indices=self.indices)

    def _load_extra(self, path: str) -> None:
        self.indices = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_variancethresholdselector)["indices"]


class VarianceThresholdSelector(Estimator, VarianceThresholdSelectorParams):

    checkpointable = False
    checkpoint_reason = "single-pass variance aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> VarianceThresholdSelectorModel:
        (table,) = inputs
        col = table.column(self.get_input_col())
        X = _columns.staged_matrix(col, torch.float32)
        # compared in the variance's dtype, as numpy compares the JAX
        # package's float32 variances with a Python float
        kept = sample_variance(X) > self.get_variance_threshold()
        model = VarianceThresholdSelectorModel()
        # tpulint: disable=host-sync-leak -- the fit's one readback (host indices)
        model.indices = torch.nonzero(kept).flatten().cpu().numpy()
        update_existing_params(model, self)
        return model
