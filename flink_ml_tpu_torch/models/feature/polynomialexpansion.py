"""PolynomialExpansion: expands vectors into polynomial feature space.

Port of flink_ml_tpu/models/feature/polynomialexpansion.py (the
reference's PolynomialExpansion.java:103-117 recursion, f([a,b,c], 3) =
f([a,b], 3) ++ f([a,b], 2) * c ++ f([a,b], 1) * c^2 ++ [c^3]; the constant
term is left out, so the output has C(size + degree, degree) - 1
columns). The same recursion over whole columns on the column's device:
each monomial is one product of column tensors, built in the reference's
order and with the same chain of multiplies, so it rounds as the JAX
package's does; the recursion runs on the transposed column, so every
product reads and writes contiguous rows. A tensor column gives a tensor in its dtype, a host
column host numpy in its own float dtype.
"""

from __future__ import annotations

from math import comb
from typing import List

import torch

from ...api import Transformer, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...param import IntParam, ParamValidators
from ...table import Table
from . import _columns


class PolynomialExpansionParams(HasInputCol, HasOutputCol):
    DEGREE = IntParam(
        "degree", "Degree of the polynomial expansion.", 2, ParamValidators.gt_eq(1)
    )

    def get_degree(self) -> int:
        return self.get(self.DEGREE)

    def set_degree(self, value: int):
        return self.set(self.DEGREE, value)


def expand_columns(X: torch.Tensor, degree: int) -> torch.Tensor:
    """The monomial columns in the reference's recursion order
    (PolynomialExpansion.expandDenseVector:211-242), batched over rows.
    The recursion runs on X's transpose, so each feature and each monomial
    is a contiguous row; the (monomials, n) result is transposed back in
    one copy (stacking n-long columns side by side would write the output
    once per monomial)."""
    n_rows, size = X.shape
    XT = X.t().contiguous()
    out: List[torch.Tensor] = []

    def expand(last_idx: int, deg: int, factor: torch.Tensor) -> None:
        if deg == 0 or last_idx < 0:
            out.append(factor)
            return
        v = XT[last_idx]
        alpha = factor
        for i in range(deg + 1):
            expand(last_idx - 1, deg - i, alpha)
            alpha = alpha * v

    expand(size - 1, degree, torch.ones(n_rows, dtype=X.dtype, device=X.device))
    # the first monomial is the constant term, which the reference leaves out
    result = torch.stack(out[1:]).t().contiguous()
    assert result.shape[1] == comb(size + degree, degree) - 1
    return result


class PolynomialExpansion(Transformer, PolynomialExpansionParams):
    fusable = True

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        cols[self.get_output_col()] = expand_columns(X, self.get_degree())
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_matrix)]
