"""OneHotEncoder: encodes index columns as one-hot sparse vectors.

Port of flink_ml_tpu/models/feature/onehotencoder.py (the reference's
OneHotEncoder.java:246 and OneHotEncoderModel.java). `dropLast` (default
true) stores numCategories - 1 as the vector size, and the last category
encodes as the empty vector: index -1 with value 0 in the (n, 1)
SparseBatch each encoded column becomes. Only handleInvalid = 'error'
exists, as in the reference.

The fit reads each column to the host once and takes its largest index.
The transform encodes on the column's device (host columns are staged to
`config.device()`) and raises the JAX package's host-path errors (a
non-integer or negative index; an index out of range) for either kind of
column. Either kind runs the transform kernel (a host column staged in
float64), whose checks are guards read back once a transform (or once a
fused segment); a host column gives a host SparseBatch with float64
values, as the JAX host path does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Estimator, Model
from ...common.param import HasHandleInvalid, HasInputCols, HasOutputCols
from ...param import BooleanParam
from ...table import SparseBatch, Table, _to_numpy
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns


def _not_indexed(name: str) -> str:
    return f"Value cannot be parsed as indexed integer in column {name}"


def _out_of_range(name: str) -> str:
    return f"The input contains invalid index in column {name}."


def _onehot(col, vec_size: int, drop: bool):
    """(indices (n, 1) int32, values (n, 1) float32, [not_int, out_of_range])
    of a column of category indices, on its device."""
    int_idx = col.to(torch.int32)
    not_int = torch.any((int_idx.to(col.dtype) != col) | (col < 0))
    out_of_range = torch.any(int_idx > vec_size if drop else int_idx >= vec_size)
    indices = torch.where(int_idx < vec_size, int_idx, -1)[:, None]
    values = (indices >= 0).to(torch.float32)
    return indices, values, torch.stack([not_int, out_of_range])


class OneHotEncoderModelParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    DROP_LAST = BooleanParam("dropLast", "Whether to drop the last category.", True)

    def get_drop_last(self) -> bool:
        return self.get(self.DROP_LAST)

    def set_drop_last(self, value: bool):
        return self.set(self.DROP_LAST, value)


class OneHotEncoderParams(OneHotEncoderModelParams):
    pass


class OneHotEncoderModel(Model, OneHotEncoderModelParams):
    fusable = True
    kernel_emits_sparse = True

    def __init__(self):
        self.category_sizes: np.ndarray = None  # per column: largest index + 1

    def supports_fusion(self) -> bool:
        # only handleInvalid='error' exists (the reference's contract)
        return self.get_handle_invalid() == HasHandleInvalid.ERROR_INVALID

    def _constant_sources(self):
        return (self.category_sizes,)

    def transform_kernel(self, consts, cols, ctx):
        drop = bool(self.get_drop_last())
        for i, (name, out_name) in enumerate(zip(self.get_input_cols(), self.get_output_cols())):
            vec_size = int(self.category_sizes[i]) - int(drop)
            indices, values, (not_int, out_of_range) = _onehot(cols[name], vec_size, drop)
            # the JAX host path's two messages, which the eager tests pin
            ctx.guard(not_int, _not_indexed(name))
            ctx.guard(out_of_range, _out_of_range(name))
            cols[out_name] = SparseBatch(vec_size, indices, values)
        return cols

    def set_model_data(self, *inputs: Table) -> "OneHotEncoderModel":
        (model_data,) = inputs
        sizes = {int(row["columnIndex"]): int(row["categorySize"]) for row in model_data.collect()}
        self.category_sizes = np.asarray([sizes[i] for i in range(len(sizes))], dtype=np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({
            "columnIndex": np.arange(len(self.category_sizes)),
            "categorySize": np.asarray(self.category_sizes),
        })]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        # the reference supports only handleInvalid = 'error'
        # (OneHotEncoderModel.java:73 checkArgument)
        if self.get_handle_invalid() != HasHandleInvalid.ERROR_INVALID:
            raise ValueError("OneHotEncoder only supports handleInvalid = 'error'")
        return [self._transform_with_kernel(table, lambda col: _columns.staged(col, torch.float64))]

    def _host_outputs(self, out):
        # the JAX host path's float64 values
        host = {}
        for name, col in out.items():
            indices = col.indices.cpu().numpy()
            host[name] = SparseBatch(col.size, indices, (indices >= 0).astype(np.float64))
        return host

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, categorySizes=self.category_sizes)

    def _load_extra(self, path: str) -> None:
        self.category_sizes = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_onehotencoder)["categorySizes"]


class OneHotEncoder(Estimator, OneHotEncoderParams):

    checkpointable = False
    checkpoint_reason = "single-pass category-count aggregation; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> OneHotEncoderModel:
        (table,) = inputs
        sizes = []
        for name in self.get_input_cols():
            col = table.column(name)
            _linear.column_device(col)  # a stage runs on the card unless asked for the CPU
            idx = np.asarray(_to_numpy(col), dtype=np.float64)  # one readback
            int_idx = idx.astype(np.int64)
            if np.any(int_idx != idx) or np.any(int_idx < 0):
                raise ValueError(_not_indexed(name))
            sizes.append(int(int_idx.max()) + 1)
        model = OneHotEncoderModel()
        model.category_sizes = np.asarray(sizes, dtype=np.int64)
        update_existing_params(model, self)
        return model
