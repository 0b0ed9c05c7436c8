"""Normalizer: scales each vector to unit p-norm.

Port of flink_ml_tpu/models/feature/normalizer.py (the reference's
Normalizer.java: `p` >= 1, default 2). One batched expression on the
column's device: the row norm (sum |x|^p)^(1/p), floored at 1e-30, divides
the row. The JAX package computes it in float32 on either kind of column
(a host column goes through `jnp.asarray`), so the port does too: a
tensor column in its own dtype, a host column in float32, returned as
numpy.
"""

from __future__ import annotations

from typing import List

import torch

from ...api import Transformer
from ...common.param import HasInputCol, HasOutputCol
from ...param import DoubleParam, ParamValidators
from ...table import Table
from . import _columns


class NormalizerParams(HasInputCol, HasOutputCol):
    P = DoubleParam("p", "The p norm value.", 2.0, ParamValidators.gt_eq(1.0))

    def get_p(self) -> float:
        return self.get(self.P)

    def set_p(self, value: float):
        return self.set(self.P, value)


def normalize(X: torch.Tensor, p: float) -> torch.Tensor:
    p = _columns.constant(p, X)
    norms = torch.sum(torch.abs(X) ** p, dim=1) ** (1.0 / p)
    return X / torch.clamp(norms, min=1e-30)[:, None]


class Normalizer(Transformer, NormalizerParams):
    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_input_col())
        X = _columns.staged_matrix(col, torch.float32)
        return [table.with_columns({self.get_output_col(): _columns.output(normalize(X, self.get_p()), col)})]
