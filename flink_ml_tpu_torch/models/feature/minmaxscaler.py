"""MinMaxScaler: rescales features to an output range [min, max].

Port of flink_ml_tpu/models/feature/minmaxscaler.py (the reference's
MinMaxScaler.java and MinMaxScalerModel.java: scale = (max - min) /
(eMax - eMin); a constant feature, |eMax - eMin| < 1e-5, maps to the
middle of the range). The fit is one column min and max on the device, in
float32 for a host column as the JAX package's `jnp.asarray` gives it, in
its own dtype for a tensor. The transform's scale and offset are derived
on the host in float64, as the JAX package derives them; then a tensor
column computes X * scale + offset in its dtype as one fused multiply-add
(`torch.addcmul`, one rounding), as XLA contracts the JAX device path's
expression, and a host column in float64 as a multiply then an add, as
numpy does. So a host column keeps a branch of its own beside the
transform kernel, which rounds once.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...linalg import DenseVector
from ...param import DoubleParam, ParamValidators
from ...table import Table
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns


class MinMaxScalerParams(HasInputCol, HasOutputCol):
    MIN = DoubleParam(
        "min", "Lower bound of the output feature range.", 0.0, ParamValidators.not_null()
    )
    MAX = DoubleParam(
        "max", "Upper bound of the output feature range.", 1.0, ParamValidators.not_null()
    )

    def get_min(self) -> float:
        return self.get(self.MIN)

    def set_min(self, value: float):
        return self.set(self.MIN, value)

    def get_max(self) -> float:
        return self.get(self.MAX)

    def set_max(self, value: float):
        return self.set(self.MAX, value)


class MinMaxScalerModel(Model, MinMaxScalerParams):
    fusable = True

    def __init__(self):
        self.min_vector: np.ndarray = None
        self.max_vector: np.ndarray = None

    def _constant_sources(self):
        return (self.min_vector, self.max_vector)

    def _kernel_constants(self):
        scale, offset = self.scale_offset()
        return {"scale": scale, "offset": offset}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        cols[self.get_output_col()] = torch.addcmul(
            consts["offset"].to(X.dtype), X, consts["scale"].to(X.dtype))
        return cols

    def scale_offset(self):
        """The transform's affine coefficients, host float64."""
        lo, hi = self.get_min(), self.get_max()
        span = self.max_vector - self.min_vector
        constant = np.abs(span) < 1.0e-5
        scale = np.where(constant, 0.0, (hi - lo) / np.where(constant, 1.0, span))
        offset = np.where(constant, (hi + lo) / 2.0, lo - self.min_vector * scale)
        return scale, offset

    def set_model_data(self, *inputs: Table) -> "MinMaxScalerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.min_vector = np.asarray(row["minVector"].to_array(), dtype=np.float64)
        self.max_vector = np.asarray(row["maxVector"].to_array(), dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"minVector": [DenseVector(self.min_vector)],
                       "maxVector": [DenseVector(self.max_vector)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_input_col())
        if _columns.is_device_column(col):  # a tensor SparseBatch densified on its device
            return [self._transform_with_kernel(table, _columns.staged_matrix)]
        X = _columns.staged_matrix(col)
        scale, offset = (_columns.model_constant(c, X, col) for c in self.scale_offset())
        # tpulint: disable=host-sync-leak -- a host column's output goes back to the host
        return [table.with_columns({self.get_output_col(): _columns.output(X * scale + offset, col)})]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, minVector=self.min_vector, maxVector=self.max_vector)

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(path, javacodec.load_reference_minmaxscaler)
        self.min_vector, self.max_vector = arrays["minVector"], arrays["maxVector"]


class MinMaxScaler(Estimator, MinMaxScalerParams):

    checkpointable = False
    checkpoint_reason = "single-pass min/max aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> MinMaxScalerModel:
        (table,) = inputs
        col = table.column(self.get_input_col())
        X = _columns.staged_matrix(col, torch.float32)
        mn, mx = torch.aminmax(X, dim=0)
        model = MinMaxScalerModel()
        model.min_vector, model.max_vector = _linear.packed_to_host(mn, mx)
        update_existing_params(model, self)
        return model
