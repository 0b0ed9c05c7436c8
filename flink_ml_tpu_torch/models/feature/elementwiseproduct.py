"""ElementwiseProduct: the Hadamard product of each vector with a scaling vector.

Port of flink_ml_tpu/models/feature/elementwiseproduct.py (the
reference's ElementwiseProduct.java: `scalingVec`, required). One
broadcast multiply on the column's device: a tensor column multiplies in
its own dtype (the JAX device path's float32 constants), a host column in
float64. Dense columns run the transform kernel (a host column staged in
float64). A SparseBatch, which the kernel does not take, stays sparse in
a branch of its own: its stored values are scaled, its padding slots
(index -1) keep 0.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api import Transformer, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...param import ParamValidators, VectorParam
from ...table import SparseBatch, Table
from . import _columns


class ElementwiseProductParams(HasInputCol, HasOutputCol):
    SCALING_VEC = VectorParam(
        "scalingVec",
        "The scaling vector to multiply with input vectors using hadamard product.",
        None,
        ParamValidators.not_null(),
    )

    def get_scaling_vec(self):
        return self.get(self.SCALING_VEC)

    def set_scaling_vec(self, value):
        return self.set(self.SCALING_VEC, value)


class ElementwiseProduct(Transformer, ElementwiseProductParams):
    fusable = True

    def _scaling_array(self) -> np.ndarray:
        scaling = self.get_scaling_vec()
        if scaling is None:
            raise ValueError("Parameter scalingVec must be set")
        return np.asarray(scaling.to_array(), dtype=np.float64)

    def _kernel_constants(self):
        return {"scaling": self._scaling_array()}

    def transform_kernel(self, consts, cols, ctx):
        sv = consts["scaling"]
        X = as_kernel_matrix(cols[self.get_input_col()])
        if X.shape[1] != sv.shape[0]:
            raise ValueError(
                f"Vector size {X.shape[1]} does not match scalingVec size {sv.shape[0]}")
        cols[self.get_output_col()] = X * sv.to(X.dtype)
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_input_col())
        if not isinstance(col, SparseBatch):
            return [self._transform_with_kernel(
                table, lambda c: _columns.staged_matrix(c, torch.float64))]
        # a SparseBatch keeps its layout, which the kernel does not take
        sv = self._scaling_array()
        indices = _columns.staged(col.indices, torch.long)
        values = _columns.staged(col.values)
        scale = _columns.constant(sv, values)[indices.clamp(min=0)]
        scaled = values * torch.where(indices >= 0, scale, 0.0)
        # tpulint: disable=host-sync-leak -- a host SparseBatch's indices go back to the host
        out_indices = _columns.output(indices.to(torch.int32), col)
        # tpulint: disable=host-sync-leak -- a host SparseBatch's values go back to the host
        out = SparseBatch(col.size, out_indices, _columns.output(scaled, col))
        return [table.with_columns({self.get_output_col(): out})]
