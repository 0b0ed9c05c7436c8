"""Column order statistics on the device: quantiles, as the JAX package
computes them, and distinct counts.

`torch.quantile` refuses more than 2^24 elements along the reduced
dimension, and `jnp.quantile` has no such limit. So the port sorts the
columns itself (`torch.sort`, a block of columns at a time: at 10M x 100 a
single sort would also make an 8 GB int64 index tensor) and reads the rows
it needs, then interpolates linearly as one of two references does:

- `jnp_quantile`: `jnp.quantile(X, qs, axis=0)` in X's dtype (the JAX
  device path, float32): position q * (n - 1) with n in that dtype, the
  floor and ceil rows, and low * (1 - w) + high * w, which XLA contracts
  into one fused multiply-add (`torch.addcmul` here);
- `numpy_quantile`: `np.quantile(X, qs, axis=0)` in float64 (the JAX
  host path): numpy's "linear" method with its two-sided lerp.

A column holding a NaN gives NaN in both, as in the references. Every
index is known on the host from n alone, so the only device work is the
sort and two gathers, and nothing is read back.

`count_distinct` counts each column's distinct values from the same
blocked sort (VectorIndexer's fit).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from ..parallel.prefetch import to_device

#: elements sorted at once; a block of columns is at most this many
#: values (its sort keeps an int64 index of the same count)
SORT_BLOCK_ELEMENTS = 1 << 27


def _sorted_blocks(X: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first column, (columns, n) block of X's columns sorted along n) for
    each block of columns; NaN sorts last."""
    n, d = X.shape
    step = max(1, SORT_BLOCK_ELEMENTS // max(n, 1))
    for c0 in range(0, d, step):
        yield c0, torch.sort(X[:, c0:c0 + step].t().contiguous(), dim=1).values


def sorted_rows(X: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """Rows `rows` of X sorted column by column: (len(rows), d), on X's
    device, in X's dtype."""
    idx = to_device(np.asarray(rows, dtype=np.int64), X.device)
    out = torch.empty((idx.numel(), X.shape[1]), dtype=X.dtype, device=X.device)
    for c0, block in _sorted_blocks(X):
        out[:, c0:c0 + block.shape[0]] = block.index_select(1, idx).t()
    return out


def count_distinct(X: torch.Tensor, nan_equal: bool = False) -> torch.Tensor:
    """(d,) int64 count of the distinct values of each column: 1 + the
    changes between neighbours in sorted order. NaNs are all distinct, as
    the JAX device path counts them, or one value with `nan_equal`, as
    `np.unique` counts them."""
    counts = torch.empty(X.shape[1], dtype=torch.int64, device=X.device)
    for c0, S in _sorted_blocks(X):
        change = S[:, 1:] != S[:, :-1]
        if nan_equal:
            change &= ~(torch.isnan(S[:, 1:]) & torch.isnan(S[:, :-1]))
        counts[c0:c0 + S.shape[0]] = 1 + change.sum(dim=1)
    return counts


def _nan_columns(result: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """NaN in every column whose sorted last row is NaN."""
    return torch.where(torch.isnan(last)[None, :], last[None, :], result)


def jnp_quantile(X: torch.Tensor, qs) -> torch.Tensor:
    """(len(qs), d) quantiles of X's columns as `jnp.quantile` computes
    them in X's dtype (method "linear")."""
    n = X.shape[0]
    np_dtype = torch.empty(0, dtype=X.dtype).numpy().dtype.type
    q = np.asarray(qs, dtype=np_dtype) * (np_dtype(n) - np_dtype(1))
    low, high = np.floor(q), np.ceil(q)
    w_high = q - low
    w_low = np_dtype(1) - w_high
    low_i = np.clip(low, 0, n - 1).astype(np.int64)
    high_i = np.clip(high, 0, n - 1).astype(np.int64)
    k = q.size
    rows = sorted_rows(X, np.concatenate([low_i, high_i, [n - 1]]))
    lo_v, hi_v, last = rows[:k], rows[k:2 * k], rows[2 * k]
    w_low = to_device(w_low, X.device)[:, None]
    w_high = to_device(w_high, X.device)[:, None]
    return _nan_columns(torch.addcmul(hi_v * w_high, lo_v, w_low), last)


def numpy_quantile(X: torch.Tensor, qs) -> torch.Tensor:
    """(len(qs), d) quantiles of X's columns as `np.quantile` computes them
    (method "linear"); X is float64."""
    n = X.shape[0]
    virtual = (n - 1) * np.asarray(qs, dtype=np.float64)
    prev = np.floor(virtual)
    nxt = prev + 1
    above = virtual >= n - 1
    prev[above], nxt[above] = -1, -1
    below = virtual < 0
    prev[below], nxt[below] = 0, 0
    prev_i, nxt_i = prev.astype(np.intp), nxt.astype(np.intp)
    gamma = virtual - prev_i  # numpy's gamma, taken after the index fix-up
    k = virtual.size
    rows = sorted_rows(X, np.concatenate([prev_i % n, nxt_i % n, [n - 1]]))
    a, b, last = rows[:k], rows[k:2 * k], rows[2 * k]
    g = to_device(gamma, X.device, X.dtype)[:, None]
    diff = b - a
    out = torch.where(g >= 0.5, b - diff * (1 - g), a + diff * g)
    return _nan_columns(out, last)
