"""Bucketizer: maps continuous columns to bucket indices by split points.

Port of flink_ml_tpu/models/feature/bucketizer.py (the reference's
Bucketizer.java: `splitsArray`, strictly increasing split points per
column; a value in [splits[i], splits[i+1]) is bucket i and the last
bucket is closed on the right; `handleInvalid` error/skip/keep for NaN and
values outside the splits, `keep` putting them in the extra bucket
numSplits - 1). One `searchsorted` per column on its device.

A tensor column compares in its own dtype and gives float32 indices, as
the JAX device path does, when every split survives that dtype exactly.
When one does not (a float64 split with no float32 twin), the JAX package
pulls the column to the host and compares in float64; the port compares
on the device in float64 instead (ROADMAP C, port rule), which puts every
value in the same bucket as the host path. A host column compares in
float64 and gives float64 numpy. Tensor columns under 'error' or 'keep'
run the transform kernel (its check a guard); host columns (float64
output) and 'skip' (a data-dependent row count) keep a branch of their
own, where invalid rows cost one scalar probe and the mask is read back
only when a row is invalid.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Transformer
from ...common.param import HasHandleInvalid, HasInputCols, HasOutputCols
from ...parallel.prefetch import to_device
from ...param import DoubleArrayArrayParam, ParamValidators
from ...table import Table
from . import _columns


def bucketize(arr: torch.Tensor, splits: torch.Tensor):
    """(bucket index, invalid mask) of each value: value in [splits[i],
    splits[i+1]) -> i, the last split itself -> the last bucket; NaN and
    values outside [splits[0], splits[-1]] are invalid."""
    num_buckets = splits.shape[0] - 1
    idx = torch.searchsorted(splits, arr.contiguous(), right=True) - 1
    idx = torch.where(arr == splits[-1], num_buckets - 1, idx)
    bad = (arr < splits[0]) | (arr > splits[-1]) | torch.isnan(arr)
    return idx, bad


def splits_survive(splits: np.ndarray, dtype: torch.dtype) -> bool:
    """True when every split is exact in `dtype`."""
    s = torch.as_tensor(splits, dtype=torch.float64)
    return torch.equal(s.to(dtype).to(torch.float64), s)


_INVALID_MESSAGE = (
    "The input contains invalid value. See handleInvalid parameter for more options."
)


class BucketizerParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    SPLITS_ARRAY = DoubleArrayArrayParam(
        "splitsArray",
        "Array of split points for mapping continuous features into buckets.",
        None,
        ParamValidators.non_empty_array(),
    )

    def get_splits_array(self):
        return self.get(self.SPLITS_ARRAY)

    def set_splits_array(self, value):
        for splits in value:
            if len(splits) < 3 or np.any(np.diff(splits) <= 0):
                raise ValueError(
                    "Each splits array should have at least 3 strictly increasing points"
                )
        return self.set(self.SPLITS_ARRAY, [list(map(float, s)) for s in value])


class Bucketizer(Transformer, BucketizerParams):
    fusable = True

    def _checked_params(self):
        in_cols, out_cols = self.get_input_cols(), self.get_output_cols()
        splits_array = self.get_splits_array()
        if len(in_cols) != len(splits_array):
            raise ValueError(
                "Bucketizer: number of splits arrays must match number of input columns"
            )
        return in_cols, out_cols, splits_array

    def supports_fusion(self) -> bool:
        # 'skip' drops invalid rows: a data-dependent row count
        return self.get_handle_invalid() != HasHandleInvalid.SKIP_INVALID

    def kernel_ready(self, cols) -> bool:
        # the JAX package's veto: a split with no twin in the column's dtype
        # sends the column to the host there (C.6), so the plan runs eagerly
        for name, splits in zip(self.get_input_cols() or [], self.get_splits_array() or []):
            col = cols.get(name)
            if col is None or not splits_survive(np.asarray(splits, dtype=np.float64), col.dtype):
                return False
        return True

    def _kernel_constants(self):
        return {"splits": [np.asarray(s, dtype=np.float64) for s in self.get_splits_array()]}

    def kernel_output_dtypes(self, cols):
        return dict.fromkeys(self.kernel_output_cols(), torch.float32)

    def transform_kernel(self, consts, cols, ctx):
        in_cols, out_cols, splits_array = self._checked_params()
        keep = self.get_handle_invalid() == HasHandleInvalid.KEEP_INVALID
        for i, (name, out_name, splits) in enumerate(zip(in_cols, out_cols, splits_array)):
            col = cols[name]
            # a split with no twin in the column's dtype compares in float64 (C.6)
            exact = splits_survive(np.asarray(splits, dtype=np.float64), col.dtype)
            arr = col if exact else col.to(torch.float64)
            idx, bad = bucketize(arr, consts["splits"][i].to(arr.dtype))
            if keep:
                idx = torch.where(bad, len(splits) - 1, idx)
            else:
                ctx.guard(bad.any(), _INVALID_MESSAGE)
            cols[out_name] = idx.to(torch.float32)
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        if self.kernel_takes(table):
            return [self._transform_with_kernel(table)]
        in_cols, out_cols, splits_array = self._checked_params()
        keep = self.get_handle_invalid() == HasHandleInvalid.KEEP_INVALID
        updates, bads = {}, []
        for name, out_name, splits in zip(in_cols, out_cols, splits_array):
            col = table.column(name)
            splits = np.asarray(splits, dtype=np.float64)
            if _columns.is_device_column(col):
                arr = col if splits_survive(splits, col.dtype) else col.to(torch.float64)
                out_dtype = torch.float32
            else:
                arr, out_dtype = _columns.staged_numbers(col), torch.float64
            idx, bad = bucketize(arr, _columns.constant(splits, arr))
            if keep:
                idx = torch.where(bad, len(splits) - 1, idx)
            else:
                bads.append(bad)
            # tpulint: disable=host-sync-leak -- a host column's buckets go back to the host
            updates[out_name] = _columns.output(idx.to(out_dtype), col)
        out = table.with_columns(updates)
        if bads:
            invalid = torch.stack([to_device(b, bads[0].device) for b in bads]).any(dim=0)
            if bool(invalid.any()):
                if self.get_handle_invalid() == HasHandleInvalid.ERROR_INVALID:
                    raise ValueError(_INVALID_MESSAGE)
                out = out.take(torch.nonzero(~invalid).flatten())
        return [out]
