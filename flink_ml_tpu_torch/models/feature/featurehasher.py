"""FeatureHasher: hashes numeric and categorical columns into one sparse vector.

Port of flink_ml_tpu/models/feature/featurehasher.py (the reference's
FeatureHasher.java: guava murmur3_32(0) of the column name for a numeric
column, whose value is the coefficient, summed on collisions, and of
"column=value" for a categorical one, coefficient 1.0; Math.abs then a
non-negative mod into `numFeatures` buckets, default 262144). Host work:
the JAX package's vectorized path in 1M-row chunks, where the native
kernels of `native/src/hashkernels.cc` render and hash the categorical
cells and merge each row's (bucket, value) pairs (`native/hashkernels.py`,
built at first use). The numpy forms below (`_combine_hashed`, the
rendered-string murmur3) compute the same functions; they run where an
input is outside the native envelope, and the tests hold the two
against each other. The output is a host float64 SparseBatch, one slot a
column.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ... import config
from ...api import Transformer
from ...common.param import HasCategoricalCols, HasInputCols, HasNumFeatures, HasOutputCol
from ...native import hashkernels as _native
from ...table import SparseBatch, Table, _to_numpy, rows_to_sparse_batch
from ...utils.hashing import (
    murmur3_batch_unencoded_chars,
    murmur3_hash_unencoded_chars,
)
from .stringindexer import _java_double_to_string, _java_float_to_string


def _hash_index(s: str, num_features: int) -> int:
    """FeatureHasher.updateMap: Math.abs(hash) then floorMod — including
    Java's Math.abs(Integer.MIN_VALUE) == MIN_VALUE quirk."""
    h = murmur3_hash_unencoded_chars(s)
    h = h if h == -(2**31) else abs(h)
    return h % num_features


def _render_java_floats(values: np.ndarray, scalar_fmt) -> np.ndarray:
    """Vectorized Java Double/Float.toString: numpy's shortest-repr
    rendering (identical digits at the column's own precision) with
    per-row fixups where the forms diverge — |v| outside [1e-3, 1e7),
    non-finite, and negative zero."""
    s = values.astype(str)
    a = np.abs(values)
    bad = ~((a >= 1e-3) & (a < 1e7)) & (a != 0)
    bad |= ~np.isfinite(values)
    if bad.any():
        idx = np.nonzero(bad)[0]
        fixed = [scalar_fmt(values[i]) for i in idx]
        width = max(s.dtype.itemsize // 4, max(len(x) for x in fixed))
        s = s.astype(f"U{width}")
        s[idx] = fixed
    return s


def _render_java_doubles(values: np.ndarray) -> np.ndarray:
    return _render_java_floats(values, lambda v: _java_double_to_string(float(v)))


def _hash_categorical_column(values: np.ndarray, prefix: str, n_features: int) -> np.ndarray:
    """Per-row bucket indices for one categorical column: the native
    single-pass render and hash, or numpy's murmur3 of the rendered
    strings where a column name is outside the native envelope."""
    if values.dtype == np.float64:
        out = _native.hash_categorical_doubles(values, prefix, n_features)
        if out is not None:
            return out.astype(np.int64)
        rendered = _render_java_doubles(values)
    elif values.dtype.kind == "f":
        # float32/16 render at float32 precision (Java Float.toString),
        # not the repr of the widened double
        rendered = _render_java_floats(
            values.astype(np.float32), _java_float_to_string
        )
    elif values.dtype.kind == "b":
        # java_str: Java Boolean.toString is lowercase
        rendered = np.where(values, "true", "false")
    else:
        rendered = values.astype(str)
    out = _native.hash_categorical_strings(rendered, prefix, n_features)
    if out is not None:
        return out.astype(np.int64)
    strs = np.char.add(prefix, rendered)
    h = murmur3_batch_unencoded_chars(strs)
    h = np.where(h == -(2**31), h, np.abs(h))
    return h % n_features


class FeatureHasherParams(HasInputCols, HasCategoricalCols, HasOutputCol, HasNumFeatures):
    pass


class FeatureHasher(Transformer, FeatureHasherParams):
    fusable = False
    fusable_reason = "murmur-hashes 'col=value' strings rendered on host (prefers_host_input)"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        input_cols = self.get_input_cols()
        if not input_cols:
            raise ValueError("Parameter inputCols must be set")
        categorical = set(self.get_categorical_cols())
        if not categorical.issubset(input_cols):
            raise ValueError("CategoricalCols must be included in inputCols!")
        host_cols = {c: _to_numpy(table.column(c)) for c in input_cols}
        # string/boolean columns are categorical even when not declared
        # (FeatureHasher.generateCategoricalCols)
        for col, values in host_cols.items():
            if values.dtype == object or values.dtype.kind in "USb":
                categorical.add(col)
        n_features = self.get_num_features()
        numeric_cols = [c for c in input_cols if c not in categorical]
        n = table.num_rows

        def java_str(v) -> str:
            if isinstance(v, (bool, np.bool_)):
                return "true" if v else "false"
            if isinstance(v, (np.float32, np.float16)):
                return _java_float_to_string(v)
            if isinstance(v, (float, np.floating)):
                return _java_double_to_string(float(v))
            return str(v)

        vectorizable = all(
            arr.ndim == 1 and arr.dtype.kind in "fiubU" for arr in host_cols.values()
        )
        if vectorizable and input_cols:
            # vectorized path: bucket indices from the hashes of
            # `col=value` strings (categorical) or of the column name
            # (numeric, one constant bucket a column, value summed), in
            # row chunks so the per-column stacks stay bounded
            ncol = len(input_cols)
            chunk = 1_000_000
            out_idx = np.empty((n, ncol), np.int32)
            out_val = np.empty((n, ncol), np.float64)
            numeric_bucket = {c: _hash_index(c, n_features) for c in numeric_cols}
            for s in range(0, n, chunk):
                e = min(n, s + chunk)
                idx_cols, val_cols = [], []
                for c in numeric_cols:
                    idx_cols.append(np.full(e - s, numeric_bucket[c], np.int64))
                    val_cols.append(host_cols[c][s:e].astype(np.float64))
                for c in input_cols:
                    if c not in categorical:
                        continue
                    idx_cols.append(
                        _hash_categorical_column(host_cols[c][s:e], f"{c}=", n_features)
                    )
                    val_cols.append(np.ones(e - s, np.float64))
                idxs = np.stack(idx_cols, axis=1)
                vals = np.stack(val_cols, axis=1)
                combined = _native.combine_hashed(idxs, vals)
                if combined is None:  # more columns than the native scratch holds
                    combined = _combine_hashed(idxs, vals)
                out_idx[s:e], out_val[s:e] = combined
            return [
                table.with_columns(
                    {self.get_output_col(): SparseBatch(n_features, out_idx, out_val)})
            ]
        features = [dict() for _ in range(n)]
        for col in numeric_cols:
            idx = _hash_index(col, n_features)
            values = np.asarray(table.column(col), dtype=np.float64)
            for r in range(n):
                features[r][idx] = features[r].get(idx, 0.0) + float(values[r])
        for col in input_cols:
            if col not in categorical:
                continue
            values = table.column(col)
            for r in range(n):
                idx = _hash_index(f"{col}={java_str(values[r])}", n_features)
                features[r][idx] = features[r].get(idx, 0.0) + 1.0
        row_idx = [sorted(f) for f in features]
        row_val = [[f[i] for i in keys] for f, keys in zip(features, row_idx)]
        return [
            table.with_columns(
                {self.get_output_col(): rows_to_sparse_batch(n_features, row_idx, row_val)})
        ]


def _combine_hashed(idxs: np.ndarray, vals: np.ndarray):
    """Merge per-row (bucket, value) pairs: equal buckets sum, outputs are
    padded-CSR (indices ascending per row, -1 padding), the TreeMap order
    of FeatureHasher.updateMap, vectorized over all rows at once. The
    plain numpy form of `native.hashkernels.combine_hashed`; a run's sum is
    a difference of prefix sums, so it may differ from the native
    in-order sum in the last bits where non-integer values collide."""
    n, k = idxs.shape
    order = np.argsort(idxs, axis=1, kind="stable")
    I = np.take_along_axis(idxs, order, axis=1)
    V = np.take_along_axis(vals, order, axis=1)
    first = np.ones((n, k), dtype=bool)
    first[:, 1:] = I[:, 1:] != I[:, :-1]
    cum = np.cumsum(V, axis=1)
    pos = np.arange(k)
    first_pos = np.where(first, pos, k)
    # next run start after p = min(first_pos[p+1:]) (suffix minimum)
    suffix = np.minimum.accumulate(first_pos[:, ::-1], axis=1)[:, ::-1]
    next_first = np.concatenate(
        [suffix[:, 1:], np.full((n, 1), k, first_pos.dtype)], axis=1
    )
    run_end = np.minimum(next_first - 1, k - 1)
    prev_cum = np.concatenate([np.zeros((n, 1), cum.dtype), cum[:, :-1]], axis=1)
    run_sum = np.take_along_axis(cum, run_end, axis=1) - prev_cum
    # compact first-of-run entries to the left, order preserved
    comp = np.argsort(np.where(first, pos, k), axis=1, kind="stable")
    indices = np.take_along_axis(np.where(first, I, -1), comp, axis=1).astype(np.int32)
    values = np.take_along_axis(np.where(first, run_sum, 0.0), comp, axis=1)
    return indices, values
