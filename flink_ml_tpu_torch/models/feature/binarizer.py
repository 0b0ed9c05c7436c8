"""Binarizer: thresholds continuous features to 0/1.

Port of flink_ml_tpu/models/feature/binarizer.py (the reference's
Binarizer.java: one threshold per input column; a value above it becomes
1.0, else 0.0; number and vector columns alike). One comparison per
column on the column's device. A tensor column gives float32, as the JAX
device path does; a host column compares in float64 and gives float64
numpy. A SparseBatch stays sparse: only its stored values are compared.
The transform kernel serves dense tensor columns; host columns and
SparseBatches keep a branch of their own, as their output dtype or
layout is not the kernel's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Transformer
from ...common.param import HasInputCols, HasOutputCols
from ...param import DoubleArrayParam, ParamValidators
from ...table import SparseBatch, Table
from . import _columns


def _binarize(arr: torch.Tensor, threshold: float, dtype: torch.dtype) -> torch.Tensor:
    return (arr > threshold).to(dtype)


class BinarizerParams(HasInputCols, HasOutputCols):
    THRESHOLDS = DoubleArrayParam(
        "thresholds",
        "The thresholds used to binarize continuous features; one per input column.",
        None,
        ParamValidators.non_empty_array(),
    )

    def get_thresholds(self):
        return self.get(self.THRESHOLDS)

    def set_thresholds(self, *values: float):
        return self.set(self.THRESHOLDS, list(values))


class Binarizer(Transformer, BinarizerParams):
    fusable = True

    def _checked_params(self):
        in_cols, out_cols = self.get_input_cols(), self.get_output_cols()
        thresholds = self.get_thresholds()
        if len(in_cols) != len(thresholds):
            raise ValueError("Binarizer: number of thresholds must match number of input columns")
        return in_cols, out_cols, thresholds

    def _kernel_constants(self):
        return {"thresholds": np.asarray(self.get_thresholds(), dtype=np.float64)}

    def kernel_output_dtypes(self, cols):
        return dict.fromkeys(self.kernel_output_cols(), torch.float32)

    def transform_kernel(self, consts, cols, ctx):
        in_cols, out_cols, _ = self._checked_params()
        for i, (name, out_name) in enumerate(zip(in_cols, out_cols)):
            col = cols[name]
            # the threshold in the column's dtype, as the JAX device path casts it
            cols[out_name] = _binarize(col, consts["thresholds"][i].to(col.dtype), torch.float32)
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        if self.kernel_takes(table):
            return [self._transform_with_kernel(table)]
        in_cols, out_cols, thresholds = self._checked_params()
        updates = {}
        for name, out_name, thr in zip(in_cols, out_cols, thresholds):
            col = table.column(name)
            if isinstance(col, SparseBatch):
                values = _columns.staged(col.values)
                # tpulint: disable=host-sync-leak -- a host SparseBatch's values go back to the host
                binary = _columns.output(_binarize(values, thr, values.dtype), col)
                indices = col.indices.clone() if _columns.is_device_column(col) else col.indices.copy()
                updates[out_name] = SparseBatch(col.size, indices, binary)
            elif _columns.is_device_column(col):
                updates[out_name] = _binarize(col, _columns.constant(thr, col), torch.float32)
            else:
                # tpulint: disable=host-sync-leak -- a host column's output goes back to the host
                updates[out_name] = _columns.output(
                    _binarize(_columns.staged_numbers(col), thr, torch.float64), col)
        return [table.with_columns(updates)]
