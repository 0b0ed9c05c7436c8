"""MaxAbsScaler: rescales features to [-1, 1] by their largest absolute value.

Port of flink_ml_tpu/models/feature/maxabsscaler.py (the reference's
MaxAbsScaler.java and MaxAbsScalerModel.java: divide by the per-feature
maxAbs; a zero maxAbs leaves the feature as it is). The fit is one
column max of |X| on the device, in float32 for a host column as the JAX
package's `jnp.asarray` gives it, in its own dtype for a tensor; the
model keeps it as float64. The transform divides on the column's device:
a tensor by the scale in its dtype, a host column in float64.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...linalg import DenseVector
from ...table import Table
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns


class MaxAbsScalerParams(HasInputCol, HasOutputCol):
    pass


class MaxAbsScalerModel(Model, MaxAbsScalerParams):
    fusable = True

    def __init__(self):
        self.max_abs: np.ndarray = None

    def _constant_sources(self):
        return (self.max_abs,)

    def _kernel_constants(self):
        return {"scale": np.where(self.max_abs > 0, self.max_abs, 1.0)}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        cols[self.get_output_col()] = X / consts["scale"].to(X.dtype)
        return cols

    def set_model_data(self, *inputs: Table) -> "MaxAbsScalerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.max_abs = np.asarray(row["maxVector"].to_array(), dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"maxVector": [DenseVector(self.max_abs)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(
            table, lambda col: _columns.staged_matrix(col, torch.float64))]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, maxVector=self.max_abs)

    def _load_extra(self, path: str) -> None:
        self.max_abs = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_maxabsscaler)["maxVector"]


class MaxAbsScaler(Estimator, MaxAbsScalerParams):

    checkpointable = False
    checkpoint_reason = "single-pass abs-max aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> MaxAbsScalerModel:
        (table,) = inputs
        col = table.column(self.get_input_col())
        X = _columns.staged_matrix(col, torch.float32)
        (max_abs,) = _linear.packed_to_host(torch.amax(torch.abs(X), dim=0))
        model = MaxAbsScalerModel()
        model.max_abs = max_abs
        update_existing_params(model, self)
        return model
