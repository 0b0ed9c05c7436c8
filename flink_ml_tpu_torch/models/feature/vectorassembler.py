"""VectorAssembler: concatenates number and vector columns into one vector.

Port of flink_ml_tpu/models/feature/vectorassembler.py (the reference's
VectorAssembler.java: inputCols in order, `inputSizes` to check each
column's width, `handleInvalid` error/skip/keep over NaN values). A
columnar concat: dense columns as they are and sparse ones densified.

With any tensor input, the inputs are joined on that device (a tensor
SparseBatch densified there, host columns staged to it) and the output is
a tensor there. With host inputs only, they are staged to
`config.device()` and the output comes back as numpy. Either way the
dtype is the inputs' promoted one, as numpy's hstack gives it in the JAX
package (a host SparseBatch densifies to float64). Under 'error' or
'keep' every input runs the transform kernel (host columns staged, a
tensor SparseBatch densified), whose NaN check is a guard (one readback,
drained at once eagerly or with its fused segment's); 'skip' reads back
which rows to drop.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Transformer
from ...common.param import HasHandleInvalid, HasInputCols, HasOutputCol
from ...parallel.prefetch import to_device
from ...param import IntArrayParam
from ...table import Table, as_dense_matrix
from . import _columns


class VectorAssemblerParams(HasInputCols, HasOutputCol, HasHandleInvalid):
    INPUT_SIZES = IntArrayParam(
        "inputSizes", "Sizes of the input elements to be assembled.", None
    )

    def get_input_sizes(self):
        return self.get(self.INPUT_SIZES)

    def set_input_sizes(self, *values: int):
        if any(v <= 0 for v in values):
            raise ValueError("Input sizes must be positive")
        return self.set(self.INPUT_SIZES, list(values))


_NAN_MESSAGE = (
    "Encountered NaN while assembling a row with handleInvalid = 'error'. "
    "Consider removing NaNs from dataset or using handleInvalid = 'keep' or 'skip'."
)


class VectorAssembler(Transformer, VectorAssemblerParams):
    fusable = True

    def supports_fusion(self) -> bool:
        # 'skip' drops NaN rows: a data-dependent row count
        return self.get_handle_invalid() != HasHandleInvalid.SKIP_INVALID

    def _matrices(self, column):
        """The input columns as (n, d) matrices, tensors left on their
        device; `column(name)` gives a column."""
        in_cols = self.get_input_cols()
        if not in_cols:
            raise ValueError("Parameter inputCols must be set")
        sizes = self.get_input_sizes()
        mats = []
        for i, name in enumerate(in_cols):
            m = as_dense_matrix(column(name), allow_device=True)
            if sizes is not None and m.shape[1] != sizes[i]:
                raise ValueError(
                    f"Input column {name} has size {m.shape[1]}, "
                    f"declared inputSizes[{i}] = {sizes[i]}"
                )
            mats.append(m)
        return mats

    def transform_kernel(self, consts, cols, ctx):
        out = torch.cat(self._matrices(cols.__getitem__), dim=1)
        if self.get_handle_invalid() == HasHandleInvalid.ERROR_INVALID:
            ctx.guard(torch.isnan(out).any(), _NAN_MESSAGE)
        cols[self.get_output_col()] = out
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        if self.supports_fusion():
            return [self._transform_with_kernel(table, _columns.staged_matrix)]
        # 'skip' drops the rows with a NaN: a row count the kernel cannot give
        mats = self._matrices(table.column)
        tensors = [m for m in mats if isinstance(m, torch.Tensor)]
        device = tensors[0].device if tensors else config.device()
        out = torch.cat([to_device(m, device) for m in mats], dim=1)
        keep = ~torch.isnan(out).any(dim=1)
        result = table.with_columns({self.get_output_col(): out if tensors else out.cpu().numpy()})
        return [result.take(np.nonzero(keep.cpu().numpy())[0])]

    def _outputs_on_host(self, cols) -> bool:
        # any tensor input joins the others on its device
        return not any(_columns.is_device_column(c) for c in cols.values())
