"""Host token-column helpers shared by the string feature stages.

Port of flink_ml_tpu/models/feature/_tokens.py (numpy only; the port keeps
its own copy). A host token column is a (n, k) fixed-width unicode matrix
(one row per token array) worked on with whole-column numpy ops: it is
dictionary-encoded once (`encode`), then the stages count and map int32
id matrices. Object columns of ragged token lists take each stage's
per-row path. A `DictTokenMatrix` takes the device ops of `ops/tokens.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...table import SparseBatch


def token_matrix(col) -> Optional[np.ndarray]:
    """The (n, k) unicode token matrix, or None if `col` is not one."""
    if isinstance(col, np.ndarray) and col.ndim == 2 and col.dtype.kind in "US":
        return col
    return None


def string_column(col) -> Optional[np.ndarray]:
    """The (n,) unicode string column, or None if `col` is not one."""
    if isinstance(col, np.ndarray) and col.ndim == 1 and col.dtype.kind in "US":
        return col
    return None


def encode(A: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dictionary-encode: unique terms + an int32 id array shaped like A.

    Fixed-width unicode whose itemsize fits an integer word is compared as
    raw bits instead of unicode (np.unique on '<U2' sorts ~20x slower than
    on the same bytes viewed as int64); the unique TERMS come back in raw-
    bit order, so re-sort lexicographically to keep the documented
    contract (uniq ascending) — for pure-ASCII fixed-width data the orders
    already agree."""
    if A.dtype.kind == "U" and A.dtype.itemsize in (4, 8):
        view = np.ascontiguousarray(A).view(
            np.int32 if A.dtype.itemsize == 4 else np.int64
        )
        uniq_bits, inv = np.unique(view.ravel(), return_inverse=True)
        uniq = uniq_bits.view(A.dtype)
        order = np.argsort(uniq, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        uniq = uniq[order]
        inv = rank[inv]
        return uniq, inv.reshape(A.shape).astype(np.int32)
    uniq, inv = np.unique(A, return_inverse=True)
    return uniq, inv.reshape(A.shape).astype(np.int32)


def row_run_counts(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row value counts over an id matrix; entries marked -1 are ignored.

    Returns (rows, values, counts) for every distinct non-negative value in
    every row, ordered by (row, value ascending) — the ordering the
    reference's sorted sparse outputs require.
    """
    n, k = ids.shape
    S = np.sort(ids, axis=1)
    first = np.ones_like(S, dtype=bool)
    first[:, 1:] = S[:, 1:] != S[:, :-1]
    flat = S.ravel()
    pos = np.flatnonzero(first.ravel())
    # runs never cross rows: each row's first element is always a run start
    counts = np.diff(np.append(pos, n * k))
    rows = pos // k
    values = flat[pos]
    keep = values >= 0
    return rows[keep], values[keep], counts[keep]


def sparse_from_runs(
    n: int, size: int, rows, values, counts, dtype=np.float64
) -> SparseBatch:
    """Assemble (row, value, count) runs sorted by (row, value) into a
    padded-CSR SparseBatch."""
    row_nnz = np.bincount(rows, minlength=n)
    width = int(row_nnz.max()) if len(rows) else 0
    width = max(width, 1)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(row_nnz, out=offsets[1:])
    within = np.arange(len(rows)) - offsets[rows]
    indices = np.full((n, width), -1, np.int32)
    vals = np.zeros((n, width), dtype)
    indices[rows, within] = values
    vals[rows, within] = counts
    return SparseBatch(size, indices, vals)


def ragged_from_mask(A: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Filter a token matrix row-wise by a boolean mask, producing the
    object-array-of-lists column shape ragged outputs need."""
    n = A.shape[0]
    counts = keep.sum(axis=1)
    flat = A[keep]
    out = np.empty(n, dtype=object)
    pieces = np.split(flat, np.cumsum(counts)[:-1])
    for i, piece in enumerate(pieces):
        out[i] = piece.tolist()
    return out


def map_rows_by_unique(col: np.ndarray, fn) -> np.ndarray:
    """Apply `fn(str) -> object` to a string column through its dictionary:
    fn runs once per DISTINCT value, results are gathered back by id. Rows
    with equal strings share the resulting object (treat as read-only).
    Uses `encode`'s raw-bit unique fast path when the dtype allows."""
    uniq, ids = encode(col.reshape(-1, 1))
    results = np.empty(len(uniq), dtype=object)
    results[:] = [fn(str(u)) for u in uniq]
    return results[ids.reshape(-1)]


def lookup(uniq: np.ndarray, mapping, default: int = -1) -> np.ndarray:
    """Map each unique term through a {str: int} dict -> int32 array."""
    out = np.full(len(uniq), default, dtype=np.int32)
    for j, t in enumerate(uniq):
        v = mapping.get(str(t))
        if v is not None:
            out[j] = v
    return out
