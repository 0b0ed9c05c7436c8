"""HashingTF: term sequences to sparse term-frequency vectors by the
hashing trick.

Port of flink_ml_tpu/models/feature/hashingtf.py (the reference's
HashingTF.java:125-185: guava murmur3_32(0) of each term, `utils/hashing.py`
bit for bit, a non-negative mod into `numFeatures` buckets (default
262144); `binary` caps frequencies at 1).

A `DictTokenMatrix` hashes only its vocabulary on the host; the bucket
map and the per-row counts run on the ids' device
(`ops.tokens.map_term_runs_chunked`) and the SparseBatch stays there:
int32 indices and float32 counts, as wide as the JAX package's device
output. A unicode token matrix hashes each distinct term once and counts
runs with numpy; token lists go row by row. Both give a host float64
SparseBatch as wide as its widest row.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ... import config
from ...api import Transformer
from ...common.param import HasInputCol, HasNumFeatures, HasOutputCol
from ...ops import tokens as tokens_ops
from ...param import BooleanParam
from ...table import DictTokenMatrix, SparseBatch, Table, rows_to_sparse_batch
from ...utils.hashing import hash_term
from . import _tokens


class HashingTFParams(HasInputCol, HasOutputCol, HasNumFeatures):
    BINARY = BooleanParam(
        "binary", "Whether each dimension of the output vector is binary or not.", False
    )

    def get_binary(self) -> bool:
        return self.get(self.BINARY)

    def set_binary(self, value: bool):
        return self.set(self.BINARY, value)


def bucket_lut(terms, num_features: int) -> np.ndarray:
    """Each term's bucket, hash_term(t) mod numFeatures (non-negative), int32."""
    return np.asarray([hash_term(str(t)) % num_features for t in terms], np.int32)


class HashingTF(Transformer, HashingTFParams):
    fusable = False
    fusable_reason = "murmur-hashes host token strings into term frequencies"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        col = table.column(self.get_input_col())
        n_features = self.get_num_features()
        binary = self.get_binary()
        if isinstance(col, DictTokenMatrix):
            thr = np.ones(col.n, np.float32)
            indices, values = tokens_ops.map_term_runs_chunked(
                col.ids, bucket_lut(col.vocab, n_features), thr, binary=binary,
                num_terms=n_features)
            out = SparseBatch(n_features, indices, values)
        elif (A := _tokens.token_matrix(col)) is not None:
            uniq, ids = _tokens.encode(A)
            rows, values, counts = _tokens.row_run_counts(bucket_lut(uniq, n_features)[ids])
            if binary:
                counts = np.ones_like(counts, np.float64)
            out = _tokens.sparse_from_runs(A.shape[0], n_features, rows, values, counts)
        else:
            row_indices, row_values = [], []
            for terms in col:
                counts = {}
                for term in terms:
                    idx = hash_term(term) % n_features
                    counts[idx] = 1 if binary else counts.get(idx, 0) + 1
                ordered = sorted(counts)
                row_indices.append(ordered)
                row_values.append([float(counts[i]) for i in ordered])
            out = rows_to_sparse_batch(n_features, row_indices, row_values)
        return [table.with_columns({self.get_output_col(): out})]
