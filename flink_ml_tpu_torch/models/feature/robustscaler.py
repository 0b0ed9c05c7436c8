"""RobustScaler: scales features by quantile-range statistics.

Port of flink_ml_tpu/models/feature/robustscaler.py (the reference's
RobustScaler.java and RobustScalerModelParams.java: withCentering default
false, withScaling default true; the model is each feature's median and
upper - lower quantile range). A bounded Table fits exactly on the
device: the column quantiles of `ops.quantile` at [0.5, lower, upper], as
`jnp.quantile` computes them in float32 (a host column is cast to
float32, as the JAX package's `jnp.asarray` casts it). A `StreamTable`
fits out of core on the host through one Greenwald-Khanna sketch per
feature at `relativeError`, as the JAX package does.

The transform subtracts the median and divides by the range (1 where the
range is 0) on the column's device: a tensor column in its dtype, a host
column in float64.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol, HasRelativeError
from ...common.quantilesummary import column_sketches, update_column_sketches
from ...linalg import DenseVector
from ...ops.quantile import jnp_quantile
from ...param import BooleanParam, DoubleParam, ParamValidators
from ...table import StreamTable, Table, as_dense_matrix
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns


class RobustScalerModelParams(HasInputCol, HasOutputCol):
    WITH_CENTERING = BooleanParam(
        "withCentering", "Whether to center the data with median before scaling.", False
    )
    WITH_SCALING = BooleanParam(
        "withScaling", "Whether to scale the data to quantile range.", True
    )

    def get_with_centering(self) -> bool:
        return self.get(self.WITH_CENTERING)

    def set_with_centering(self, value: bool):
        return self.set(self.WITH_CENTERING, value)

    def get_with_scaling(self) -> bool:
        return self.get(self.WITH_SCALING)

    def set_with_scaling(self, value: bool):
        return self.set(self.WITH_SCALING, value)


class RobustScalerParams(RobustScalerModelParams, HasRelativeError):
    LOWER = DoubleParam(
        "lower",
        "Lower quantile to calculate quantile range.",
        0.25,
        ParamValidators.in_range(0.0, 1.0, lower_inclusive=False, upper_inclusive=False),
    )
    UPPER = DoubleParam(
        "upper",
        "Upper quantile to calculate quantile range.",
        0.75,
        ParamValidators.in_range(0.0, 1.0, lower_inclusive=False, upper_inclusive=False),
    )

    def get_lower(self) -> float:
        return self.get(self.LOWER)

    def set_lower(self, value: float):
        return self.set(self.LOWER, value)

    def get_upper(self) -> float:
        return self.get(self.UPPER)

    def set_upper(self, value: float):
        return self.set(self.UPPER, value)


class RobustScalerModel(Model, RobustScalerModelParams):
    fusable = True

    def __init__(self):
        self.medians: np.ndarray = None
        self.ranges: np.ndarray = None

    def _constant_sources(self):
        return (self.medians, self.ranges)

    def _kernel_constants(self):
        return {"medians": self.medians, "scale": np.where(self.ranges > 0, self.ranges, 1.0)}

    def transform_kernel(self, consts, cols, ctx):
        out = as_kernel_matrix(cols[self.get_input_col()])
        if self.get_with_centering():
            out = out - consts["medians"].to(out.dtype)
        if self.get_with_scaling():
            out = out / consts["scale"].to(out.dtype)
        cols[self.get_output_col()] = out
        return cols

    def set_model_data(self, *inputs: Table) -> "RobustScalerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.medians = np.asarray(row["medians"].to_array(), dtype=np.float64)
        self.ranges = np.asarray(row["ranges"].to_array(), dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"medians": [DenseVector(self.medians)],
                       "ranges": [DenseVector(self.ranges)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(
            table, lambda col: _columns.staged_matrix(col, torch.float64))]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, medians=self.medians, ranges=self.ranges)

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(path, javacodec.load_reference_robustscaler)
        self.medians, self.ranges = arrays["medians"], arrays["ranges"]


class RobustScaler(Estimator, RobustScalerParams):

    checkpointable = False
    checkpoint_reason = "single-pass quantile aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> RobustScalerModel:
        (table,) = inputs
        if isinstance(table, StreamTable):
            med, lo, hi = self._fit_stream(table)
        else:
            col = table.column(self.get_input_col())
            X = _columns.staged_matrix(col, torch.float32)
            qs = jnp_quantile(X, [0.5, self.get_lower(), self.get_upper()])
            med, lo, hi = _linear.packed_to_host(qs)[0]
        model = RobustScalerModel()
        model.medians = med
        model.ranges = hi - lo
        update_existing_params(model, self)
        return model

    def _fit_stream(self, stream):
        """Out-of-core fit: per-feature Greenwald-Khanna sketches updated
        batch by batch at `relativeError`, on the host (the reference's
        QuantileSummary path)."""
        config.device()  # an entry point: no silent CPU without a request
        sketches = None
        for batch in stream:
            X = as_dense_matrix(batch.column(self.get_input_col()))
            if sketches is None:
                sketches = column_sketches(X.shape[1], self.get_relative_error())
            update_column_sketches(sketches, X)
        if sketches is None:
            raise ValueError("cannot fit RobustScaler on an empty stream")
        qs = np.asarray([0.5, self.get_lower(), self.get_upper()])
        out = np.stack([s.compress().query(qs) for s in sketches], axis=1)
        return out[0], out[1], out[2]
