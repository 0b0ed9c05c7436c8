"""VectorSlicer: selects a sub-vector of features by index.

Port of flink_ml_tpu/models/feature/vectorslicer.py (the reference's
VectorSlicer.java: `indices` non-negative and unique). One gather of the
chosen columns on the column's device, in the column's dtype; a host
column gives host numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Transformer, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...parallel.prefetch import to_device
from ...param import IntArrayParam, ParamValidator
from ...table import Table
from . import _columns


def _indices_validator() -> ParamValidator:
    def check(v):
        if v is None or len(v) == 0:
            return False
        vals = list(v)
        return all(i >= 0 for i in vals) and len(set(vals)) == len(vals)

    return ParamValidator(check, "non-empty, unique, non-negative indices")


class VectorSlicerParams(HasInputCol, HasOutputCol):
    INDICES = IntArrayParam(
        "indices",
        "An array of indices to select features from a vector column.",
        None,
        _indices_validator(),
    )

    def get_indices(self):
        return self.get(self.INDICES)

    def set_indices(self, *values: int):
        return self.set(self.INDICES, list(values))


def select_columns(X: torch.Tensor, indices, index_tensor=None) -> torch.Tensor:
    """Columns `indices` of X, in order, exactly, on X's device. A run of
    neighbouring columns is a slice made contiguous (X itself when it is
    every column); other indices are one gather over the output rows
    (index_select along columns would read X once per chosen column), by
    `index_tensor` (the indices on X's device) when given."""
    idx = np.asarray(indices, dtype=np.int64)
    if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
        return X[:, int(idx[0]):int(idx[0]) + idx.size].contiguous()
    if index_tensor is None:
        index_tensor = to_device(idx, X.device)
    return X[:, index_tensor]


class VectorSlicer(Transformer, VectorSlicerParams):
    fusable = True

    def _checked_indices(self, width: int):
        indices = self.get_indices()
        if indices is None:
            raise ValueError("Parameter indices must be set")
        if max(indices) >= width:
            raise ValueError(f"Index {max(indices)} out of range for vector size {width}")
        return indices

    def _kernel_constants(self):
        return {"indices": np.asarray(self.get_indices() or [], dtype=np.int64)}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        indices = self._checked_indices(X.shape[1])
        cols[self.get_output_col()] = select_columns(X, indices, consts["indices"])
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_matrix)]
