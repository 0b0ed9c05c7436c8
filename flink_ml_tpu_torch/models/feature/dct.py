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

from ...api import Transformer, as_kernel_matrix, upload_constants
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


def transform_matrix(n: int, inverse: bool) -> np.ndarray:
    """The float32 (n, n) matrix M of the transform, y = M @ x."""
    B = dct_basis(n)
    return np.ascontiguousarray(B.T if inverse else B, dtype=np.float32)


class DCT(Transformer, DCTParams):
    fusable = True

    def _basis(self, n: int, device: torch.device) -> torch.Tensor:
        """The transform's matrix on `device`, uploaded once per width: the
        first (eager) call of a fused segment makes it, so its captured
        graph reads a tensor that already exists."""
        memo = self.__dict__.setdefault("_dct_matrices", {})
        key = (n, bool(self.get_inverse()), device)
        if key not in memo:
            memo[key] = upload_constants(transform_matrix(n, key[1]), device)
        return memo[key]

    def kernel_output_dtypes(self, cols):
        return dict.fromkeys(self.kernel_output_cols(), torch.float32)

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()]).to(torch.float32)
        with full_float32_matmul():
            cols[self.get_output_col()] = torch.matmul(X, self._basis(X.shape[1], X.device).T)
        return cols

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, _columns.staged_matrix)]
