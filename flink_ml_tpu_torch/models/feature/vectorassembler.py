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
package (a host SparseBatch densifies to float64). The NaN check costs
one scalar probe; 'skip' then reads back which rows to drop.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Transformer
from ...common.param import HasHandleInvalid, HasInputCols, HasOutputCol
from ...param import IntArrayParam
from ...table import Table, as_dense_matrix


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


class VectorAssembler(Transformer, VectorAssemblerParams):
    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        in_cols = self.get_input_cols()
        if not in_cols:
            raise ValueError("Parameter inputCols must be set")
        sizes = self.get_input_sizes()
        mats = []
        for i, name in enumerate(in_cols):
            m = as_dense_matrix(table.column(name), allow_device=True)
            if sizes is not None and m.shape[1] != sizes[i]:
                raise ValueError(
                    f"Input column {name} has size {m.shape[1]}, "
                    f"declared inputSizes[{i}] = {sizes[i]}"
                )
            mats.append(m)
        tensors = [m for m in mats if isinstance(m, torch.Tensor)]
        device = tensors[0].device if tensors else config.device()
        out = torch.cat([torch.as_tensor(m, device=device) for m in mats], dim=1)
        bad_rows = torch.isnan(out).any(dim=1)
        result = table.with_columns({self.get_output_col(): out if tensors else out.cpu().numpy()})
        if bool(bad_rows.any()):
            handle = self.get_handle_invalid()
            if handle == HasHandleInvalid.ERROR_INVALID:
                raise ValueError(
                    "Encountered NaN while assembling a row with handleInvalid = 'error'. "
                    "Consider removing NaNs from dataset or using handleInvalid = 'keep' or 'skip'."
                )
            if handle == HasHandleInvalid.SKIP_INVALID:
                result = result.take(np.nonzero(~bad_rows.cpu().numpy())[0])
        return [result]
