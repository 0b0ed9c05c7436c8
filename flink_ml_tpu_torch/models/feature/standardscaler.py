"""StandardScaler: standardize features by mean removal and std scaling.

Port of flink_ml_tpu/models/feature/standardscaler.py (the reference's
StandardScaler.java:121-137 and StandardScalerModel.java:85-131). The fit
is one pass of column sums in float32, as the JAX package computes it: the
mean, and the sample std from the squared sums with n - 1. Model data holds
both; withMean and withStd choose what the transform applies, and a zero
std scales by 1.

The transform keeps the JAX package's precision on each path: host
features (staged to `config.device()` in float64) give float64 numpy, as
the JAX package's host arithmetic does; a tensor column is scaled on its
device in its own dtype and stays there.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...linalg import DenseVector
from ...param import BooleanParam
from ...table import Table
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns


class StandardScalerParams(HasInputCol, HasOutputCol):
    WITH_MEAN = BooleanParam(
        "withMean", "Whether centers the data with mean before scaling.", False
    )
    WITH_STD = BooleanParam(
        "withStd", "Whether scales the data with standard deviation.", True
    )

    def get_with_mean(self) -> bool:
        return self.get(self.WITH_MEAN)

    def set_with_mean(self, value: bool):
        return self.set(self.WITH_MEAN, value)

    def get_with_std(self) -> bool:
        return self.get(self.WITH_STD)

    def set_with_std(self, value: bool):
        return self.set(self.WITH_STD, value)


def _fit_stats(X):
    """(mean, sample std) of the columns of X, float32: one pass of sums,
    var = (sum x^2 - n mean^2) / max(n - 1, 1) (StandardScaler.java:121-131)."""
    n = X.shape[0]
    mean = torch.mean(X, dim=0)
    sq_sum = torch.sum(X * X, dim=0)
    var = (sq_sum - n * mean * mean) / max(n - 1, 1)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


class StandardScalerModel(Model, StandardScalerParams):
    fusable = True
    graph_shareable = True

    def __init__(self):
        self.mean: np.ndarray = None  # (d,) host array
        self.std: np.ndarray = None  # (d,) host array

    def _constant_sources(self):
        return (self.mean, self.std)

    def _kernel_constants(self):
        # the scale derived in host float64, as the eager path derives it
        return {"mean": self.mean, "scale": np.where(self.std > 0, self.std, 1.0)}

    def transform_kernel(self, consts, cols, ctx):
        out = as_kernel_matrix(cols[self.get_input_col()])
        if self.get_with_mean():
            out = out - consts["mean"].to(out.dtype)
        if self.get_with_std():
            out = out / consts["scale"].to(out.dtype)
        cols[self.get_output_col()] = out
        return cols

    def set_model_data(self, *inputs: Table) -> "StandardScalerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.mean = np.asarray(row["mean"].to_array(), dtype=np.float64)
        self.std = np.asarray(row["std"].to_array(), dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"mean": [DenseVector(self.mean)], "std": [DenseVector(self.std)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(
            table, lambda col: _columns.staged_matrix(col, torch.float64))]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, mean=self.mean, std=self.std)

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(path, javacodec.load_reference_standardscaler)
        self.mean, self.std = arrays["mean"], arrays["std"]


class StandardScaler(Estimator, StandardScalerParams):

    checkpointable = False
    checkpoint_reason = "single-pass moment aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> StandardScalerModel:
        (table,) = inputs
        X = _columns.staged_matrix(table.column(self.get_input_col()), torch.float64).to(torch.float32)
        mean, std = _fit_stats(X)
        host_mean, host_std = _linear.packed_to_host(mean, std)
        model = StandardScalerModel()
        model.mean, model.std = host_mean, host_std
        update_existing_params(model, self)
        return model
