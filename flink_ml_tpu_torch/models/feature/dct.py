"""DCT: the 1-D discrete cosine transform (DCT-II, or DCT-III with
`inverse`) of each vector.

Port of flink_ml_tpu/models/feature/dct.py (the reference's DCT.java,
jtransforms' orthonormal scaled DCT). The whole column is one matrix
product with the orthonormal DCT-II basis, which the JAX package also
computes outside any Pallas kernel: `torch.matmul` in float32 on either
kind of column (the JAX package casts both to float32), at full float32
precision: TF32 is held off for the product whatever the global setting.
A host column's result comes back as float32 numpy.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache
from typing import Iterator, List

import numpy as np
import torch

from ...api import Transformer
from ...common.param import HasInputCol, HasOutputCol
from ...param import BooleanParam
from ...table import Table
from . import _columns


class DCTParams(HasInputCol, HasOutputCol):
    INVERSE = BooleanParam(
        "inverse",
        "Whether to perform the inverse DCT (true) or forward DCT (false).",
        False,
    )

    def get_inverse(self) -> bool:
        return self.get(self.INVERSE)

    def set_inverse(self, value: bool):
        return self.set(self.INVERSE, value)


@lru_cache(maxsize=16)
def dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix B (float64): y = B @ x."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    B = np.cos(np.pi * k * (2 * i + 1) / (2.0 * n))
    B *= np.sqrt(2.0 / n)
    B[0] /= np.sqrt(2.0)
    return B


@contextmanager
def full_float32_matmul() -> Iterator[None]:
    """float32 matrix products at full precision (no TF32) inside."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class DCT(Transformer, DCTParams):
    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        col = table.column(self.get_input_col())
        X = _columns.staged_matrix(col).to(torch.float32)
        B = dct_basis(X.shape[1])
        mat = B.T if self.get_inverse() else B
        with full_float32_matmul():
            out = torch.matmul(X, _columns.constant(mat.T, X))
        return [table.with_columns({self.get_output_col(): _columns.output(out, col)})]
