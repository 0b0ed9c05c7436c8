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

import numpy as np
import torch

from ...api import Transformer, as_kernel_matrix
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


def normalize(X: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Each row over its p-norm, with p (a 0-d tensor) in X's dtype."""
    p = p.to(X.dtype)
    norms = torch.sum(torch.abs(X) ** p, dim=1) ** (1.0 / p)
    return X / torch.clamp(norms, min=1e-30)[:, None]


class Normalizer(Transformer, NormalizerParams):
    fusable = True

    def _kernel_constants(self):
        return {"p": np.asarray(self.get_p(), dtype=np.float64)}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        cols[self.get_output_col()] = normalize(X, consts["p"])
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(
            table, lambda col: _columns.staged_matrix(col, torch.float32))]
