"""NGram: token arrays to arrays of space-joined n-grams.

Port of flink_ml_tpu/models/feature/ngram.py (the reference's NGram.java
and NGramParams.java: `n` default 2; an input shorter than n gives an
empty array).

A `DictTokenMatrix` whose u^n code space fits int32 stays encoded: the
n-gram codes are computed on the ids' device (`ops.tokens.ngram_codes`);
a code space of at most NGRAM_EAGER_VOCAB_MAX joins the whole vocabulary
on the host (codes index it as they are), a larger one only the codes
that occur (one sorted `torch.unique`, the codes reindexed to it). A
larger code space falls back to token lists, as in the JAX package. A
unicode token matrix gives a unicode n-gram matrix; token lists give lists.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ... import config
from ...api import Transformer
from ...common.param import HasInputCol, HasOutputCol
from ...ops import tokens as tokens_ops
from ...param import IntParam, ParamValidators
from ...table import DictTokenMatrix, Table
from . import _tokens


class NGramParams(HasInputCol, HasOutputCol):
    N = IntParam("n", "Number of elements per n-gram (>=1).", 2, ParamValidators.gt_eq(1))

    def get_n(self) -> int:
        return self.get(self.N)

    def set_n(self, value: int):
        return self.set(self.N, value)


def _empty_lists(rows: int) -> np.ndarray:
    out = np.empty(rows, dtype=object)
    out[:] = [[] for _ in range(rows)]
    return out


class NGram(Transformer, NGramParams):
    fusable = False
    fusable_reason = "assembles n-gram strings from host token lists"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        n = self.get_n()
        out_name = self.get_output_col()
        col = table.column(self.get_input_col())
        if isinstance(col, DictTokenMatrix):
            u = len(col.vocab)
            if col.k < n:
                return [table.with_columns({out_name: _empty_lists(len(col))})]
            if u**n < 2**31:
                codes = tokens_ops.ngram_codes(col.ids, u, n)
                if u**n <= tokens_ops.NGRAM_EAGER_VOCAB_MAX:
                    vocab = tokens_ops.ngram_vocab_full(col.vocab, n)
                else:
                    vocab, codes = tokens_ops.ngram_vocab_observed(col.vocab, n, codes)
                return [table.with_columns({out_name: DictTokenMatrix(vocab, codes)})]
            col = col.to_object_column()
        A = _tokens.token_matrix(col)
        if A is not None:
            k = A.shape[1]
            if k < n:
                return [table.with_columns({out_name: _empty_lists(len(col))})]
            grams = []
            for j in range(k - n + 1):
                g = A[:, j]
                for t in range(1, n):
                    g = np.char.add(np.char.add(g, " "), A[:, j + t])
                grams.append(g)
            return [table.with_columns({out_name: np.stack(grams, axis=1)})]
        out = np.empty(len(col), dtype=object)
        for i, tokens in enumerate(col):
            tokens = list(tokens)
            out[i] = [" ".join(tokens[j:j + n]) for j in range(len(tokens) - n + 1)]
        return [table.with_columns({out_name: out})]
