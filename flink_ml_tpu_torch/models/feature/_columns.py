"""Column staging shared by the feature stages.

A stage computes on the device of its input: a tensor column stays where
it is and the stage returns tensors there (device in, device out); a host
column is staged to `config.device()` and the result comes back as numpy.
A host column keeps the dtype the JAX package's host path computes in:
float64 for a column of numbers (it reads them with
`np.asarray(col, dtype=np.float64)`), and as `as_dense_matrix` gives it
for a vector column (float32 stays float32, everything else is float64),
so the port's float64 arithmetic is numpy's, op for op. Where the JAX
package sends a host column through `jnp.asarray` (float32 with x64 off),
the stage asks for float32 with `host_dtype`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import config
from ...parallel.prefetch import to_device
from ...table import as_dense_matrix
from .._linear import is_device_column


def staged(arr, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`arr` as a tensor to compute on: a tensor as it is (cast to `dtype`
    when given), a host array on `config.device()` (in `dtype` when given,
    else its own float dtype)."""
    if isinstance(arr, torch.Tensor):
        return arr if dtype is None else arr.to(dtype)
    arr = np.asarray(arr)
    if dtype is None and arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    return to_device(arr, config.device(), dtype)


def staged_numbers(col) -> torch.Tensor:
    """A column of numbers: a tensor as it is, a host column in float64."""
    return staged(col, None if is_device_column(col) else torch.float64)


def staged_matrix(col, host_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A vector column as a dense (n, d) tensor (`as_dense_matrix`; a tensor
    SparseBatch is densified on its device): a tensor column as it is, a
    host column staged in `host_dtype` (else its own float dtype)."""
    return staged(as_dense_matrix(col, allow_device=True),
                  None if is_device_column(col) else host_dtype)


def output(t: torch.Tensor, like):
    """`t` where the input column `like` lived: a tensor for a tensor
    column, else host numpy."""
    return t if is_device_column(like) else t.cpu().numpy()


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """Host values as a tensor in `like`'s dtype and device."""
    return to_device(np.asarray(values), like.device, like.dtype)


def model_constant(values, X: torch.Tensor, col) -> torch.Tensor:
    """A model's host float64 constants for an expression on X: in X's dtype
    for a tensor column (the JAX device path uploads them so, float32), in
    float64 for a host column (the JAX host path's numpy arithmetic, which
    promotes a float32 column to float64)."""
    dtype = X.dtype if is_device_column(col) else torch.float64
    return to_device(np.asarray(values), X.device, dtype)
