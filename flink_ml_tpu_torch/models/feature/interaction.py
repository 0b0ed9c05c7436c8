"""Interaction: the elementwise product space of several columns.

Port of flink_ml_tpu/models/feature/interaction.py (the reference's
Interaction.java: the output vector is the flattened outer product of the
input columns' vectors, earlier columns varying slowest; a number is a
1-dim vector). One chained outer product over the whole batch. With every
input a tensor the product stays on their device; otherwise every input
is read as host numpy (as the JAX package's host path reads it), staged
to `config.device()` in its own float dtype, and the output is host numpy.
"""

from __future__ import annotations

from typing import List

import torch

from ...api import Transformer, as_kernel_matrix
from ...common.param import HasInputCols, HasOutputCol
from ...table import Table
from . import _columns


def interact(mats: List[torch.Tensor]) -> torch.Tensor:
    out = mats[0]
    for m in mats[1:]:
        # (n, a) x (n, b) -> (n, a*b), earlier columns vary slowest
        out = (out[:, :, None] * m[:, None, :]).reshape(out.shape[0], -1)
    return out


class InteractionParams(HasInputCols, HasOutputCol):
    pass


class Interaction(Transformer, InteractionParams):
    fusable = True

    def transform_kernel(self, consts, cols, ctx):
        in_cols = self.get_input_cols()
        if not in_cols:
            raise ValueError("Parameter inputCols must be set")
        cols[self.get_output_col()] = interact([as_kernel_matrix(cols[name]) for name in in_cols])
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_matrix)]
