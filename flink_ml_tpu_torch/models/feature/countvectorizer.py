"""CountVectorizer: learns a vocabulary and encodes token arrays as
term-count sparse vectors.

Port of flink_ml_tpu/models/feature/countvectorizer.py (the reference's
CountVectorizer.java, CountVectorizerParams.java: vocabularySize default
2^18, minDF/maxDF a count when >= 1 else a share of the documents;
CountVectorizerModelParams.java: minTF, binary). The vocabulary is in
descending corpus term frequency, ties by the term (`np.lexsort((terms,
-tf))`); on a `DictTokenMatrix` only terms that occur (df > 0) enter it.

A `DictTokenMatrix` is counted on the ids' device: tf and df in one pass
(`ops.tokens.term_counts_chunked`, one readback) for the fit; the
transform maps dictionary ids to vocabulary indices through a host lookup
table and counts each row's runs there (`map_term_runs_chunked`), so the
SparseBatch stays on the device. A fractional minTF is a float32 share of
each row's present tokens, `float32(minTF) * float32(count)`, as the JAX
device path computes it. A unicode token matrix is encoded and counted
with numpy (its fractional minTF is a share of the row width k, as in
the JAX package), token lists row by row; both give host float64 batches.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import HasInputCol, HasOutputCol
from ...ops import tokens as tokens_ops
from ...parallel.prefetch import to_device
from ...param import BooleanParam, DoubleParam, IntParam, ParamValidators
from ...table import DictTokenMatrix, SparseBatch, Table, rows_to_sparse_batch
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from . import _tokens


class CountVectorizerModelParams(HasInputCol, HasOutputCol):
    MIN_TF = DoubleParam(
        "minTF",
        "Filter to ignore rare words in a document: counts below the threshold "
        "(absolute if >= 1, else fraction of the document's token count) are ignored.",
        1.0,
        ParamValidators.gt_eq(0.0),
    )
    BINARY = BooleanParam(
        "binary", "Binary toggle to control the output vector values.", False
    )

    def get_min_tf(self) -> float:
        return self.get(self.MIN_TF)

    def set_min_tf(self, value: float):
        return self.set(self.MIN_TF, value)

    def get_binary(self) -> bool:
        return self.get(self.BINARY)

    def set_binary(self, value: bool):
        return self.set(self.BINARY, value)


class CountVectorizerParams(CountVectorizerModelParams):
    VOCABULARY_SIZE = IntParam(
        "vocabularySize",
        "Max size of the vocabulary (top terms by corpus frequency).",
        1 << 18,
        ParamValidators.gt(0),
    )
    MIN_DF = DoubleParam(
        "minDF",
        "Minimum number (>= 1) or fraction (< 1) of documents a term must appear in.",
        1.0,
        ParamValidators.gt_eq(0.0),
    )
    MAX_DF = DoubleParam(
        "maxDF",
        "Maximum number (>= 1) or fraction (< 1) of documents a term may appear in.",
        2**63 - 1.0,
        ParamValidators.gt_eq(0.0),
    )

    def get_vocabulary_size(self) -> int:
        return self.get(self.VOCABULARY_SIZE)

    def set_vocabulary_size(self, value: int):
        return self.set(self.VOCABULARY_SIZE, value)

    def get_min_df(self) -> float:
        return self.get(self.MIN_DF)

    def set_min_df(self, value: float):
        return self.set(self.MIN_DF, value)

    def get_max_df(self) -> float:
        return self.get(self.MAX_DF)

    def set_max_df(self, value: float):
        return self.set(self.MAX_DF, value)


def min_tf_thresholds(ids, min_tf: float) -> torch.Tensor:
    """Each row's minTF threshold in float32 on the ids' device: minTF itself
    when >= 1, else float32(minTF) times the row's count of present tokens."""
    device = ids.device if isinstance(ids, torch.Tensor) else config.device()
    if min_tf >= 1.0:
        return torch.full((ids.shape[0],), min_tf, dtype=torch.float32, device=device)
    if isinstance(ids, torch.Tensor):
        valid = (ids >= 0).sum(dim=1)
    else:
        valid = to_device((np.asarray(ids) >= 0).sum(axis=1), device)
    return to_device(min_tf, device, torch.float32) * valid.to(torch.float32)


class CountVectorizerModel(Model, CountVectorizerModelParams):
    fusable = False
    fusable_reason = "consumes host token documents; the vocabulary lookup is string-keyed"

    def __init__(self):
        self.vocabulary: List[str] = None

    def set_model_data(self, *inputs: Table) -> "CountVectorizerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.vocabulary = list(row["vocabulary"])
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"vocabulary": [list(self.vocabulary)]})]

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        index = {t: i for i, t in enumerate(self.vocabulary)}
        min_tf = self.get_min_tf()
        binary = self.get_binary()
        col = table.column(self.get_input_col())
        size = len(self.vocabulary)
        if isinstance(col, DictTokenMatrix):
            indices, values = tokens_ops.map_term_runs_chunked(
                col.ids, _tokens.lookup(col.vocab, index), min_tf_thresholds(col.ids, min_tf),
                binary=binary, num_terms=size)
            out = SparseBatch(size, indices, values)
        elif (A := _tokens.token_matrix(col)) is not None:
            uniq, ids = _tokens.encode(A)
            rows, values, counts = _tokens.row_run_counts(_tokens.lookup(uniq, index)[ids])
            threshold = min_tf if min_tf >= 1.0 else min_tf * A.shape[1]
            keep = counts >= threshold
            rows, values, counts = rows[keep], values[keep], counts[keep]
            if binary:
                counts = np.ones_like(counts, np.float64)
            out = _tokens.sparse_from_runs(A.shape[0], size, rows, values, counts)
        else:
            row_idx, row_val = [], []
            for tokens in col:
                tokens = list(tokens)
                counts = Counter(t for t in tokens if t in index)
                threshold = min_tf if min_tf >= 1.0 else min_tf * len(tokens)
                kept = {index[t]: c for t, c in counts.items() if c >= threshold}
                ordered = sorted(kept)
                row_idx.append(ordered)
                row_val.append([1.0 if binary else float(kept[i]) for i in ordered])
            out = rows_to_sparse_batch(size, row_idx, row_val)
        return [table.with_columns({self.get_output_col(): out})]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, vocabulary=np.asarray(self.vocabulary, dtype=object))

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_countvectorizer, allow_pickle=True)
        self.vocabulary = [str(v) for v in arrays["vocabulary"]]


class CountVectorizer(Estimator, CountVectorizerParams):

    checkpointable = False
    checkpoint_reason = "single-pass vocabulary count over the input; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> CountVectorizerModel:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        col = table.column(self.get_input_col())
        n_docs = len(col)
        min_df, max_df = self.get_min_df(), self.get_max_df()
        min_count = min_df if min_df >= 1.0 else min_df * n_docs
        max_count = max_df if max_df >= 1.0 else max_df * n_docs
        if isinstance(col, DictTokenMatrix):
            # tpulint: disable=host-sync-leak -- the fit's one readback (a host vocabulary)
            tf_arr, df_arr = tokens_ops.term_counts_chunked(col.ids, len(col.vocab)).cpu().numpy()
            # df > 0: dictionary entries absent from the corpus (stop words
            # filtered upstream of an unchanged vocabulary) stay out, as the
            # row paths never see them
            keep = (df_arr >= min_count) & (df_arr <= max_count) & (df_arr > 0)
            order = np.lexsort((col.vocab, -tf_arr))
            terms = [str(col.vocab[i]) for i in order if keep[i]]
        elif (A := _tokens.token_matrix(col)) is not None:
            uniq, ids = _tokens.encode(A)
            tf_arr = np.bincount(ids.ravel(), minlength=len(uniq))
            _, doc_vals, _ = _tokens.row_run_counts(ids)
            df_arr = np.bincount(doc_vals, minlength=len(uniq))
            keep = (df_arr >= min_count) & (df_arr <= max_count)
            order = np.lexsort((uniq, -tf_arr))
            terms = [str(uniq[i]) for i in order if keep[i]]
        else:
            tf, df = Counter(), Counter()
            for tokens in col:
                tokens = list(tokens)
                tf.update(tokens)
                df.update(set(tokens))
            terms = [t for t in tf if min_count <= df[t] <= max_count]
            terms.sort(key=lambda t: (-tf[t], t))
        model = CountVectorizerModel()
        model.vocabulary = terms[: self.get_vocabulary_size()]
        update_existing_params(model, self)
        return model
