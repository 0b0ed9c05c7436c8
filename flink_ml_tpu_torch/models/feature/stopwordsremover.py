"""StopWordsRemover: filters stop words out of token arrays.

Port of flink_ml_tpu/models/feature/stopwordsremover.py (the reference's
StopWordsRemover.java and StopWordsRemoverParams.java: `stopWords`
default the English list, `caseSensitive` default false, `locale` for the
case-insensitive fold; several columns through inputCols/outputCols). The
lists are the NLTK corpus of `_stopwords.py`.

A `DictTokenMatrix` stays dictionary-encoded: the keep mask over its
vocabulary is made on the host, the tokens are filtered on the ids'
device (`ops.tokens.filter_tokens_chunked`; with nothing to drop the ids
come back as they are). A unicode token matrix is filtered with one
`np.isin`, an object column of token lists row by row; both give token
lists.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ... import config
from ...api import Transformer
from ...common.param import HasInputCols, HasOutputCols
from ...ops import tokens as tokens_ops
from ...param import BooleanParam, ParamValidators, StringArrayParam, StringParam
from ...table import DictTokenMatrix, Table
from . import _tokens
from ._stopwords import STOP_WORDS


def load_default_stop_words(language: str) -> List[str]:
    """StopWordsRemover.loadDefaultStopWords: the bundled corpus list."""
    if language not in STOP_WORDS:
        raise ValueError(
            f"{language} is not in the supported language list: {sorted(STOP_WORDS)}.")
    return list(STOP_WORDS[language])


def get_default_or_us() -> str:
    return "en_US"


class StopWordsRemoverParams(HasInputCols, HasOutputCols):
    STOP_WORDS_PARAM = StringArrayParam(
        "stopWords",
        "The words to be filtered out.",
        list(STOP_WORDS["english"]),
        ParamValidators.non_empty_array(),
    )
    CASE_SENSITIVE = BooleanParam(
        "caseSensitive",
        "Whether to do a case-sensitive comparison over the stop words.",
        False,
    )
    LOCALE = StringParam(
        "locale",
        "Locale of the input for case insensitive matching. Ignored when caseSensitive is true.",
        get_default_or_us(),
    )

    def get_stop_words(self):
        return self.get(self.STOP_WORDS_PARAM)

    def set_stop_words(self, *values: str):
        return self.set(self.STOP_WORDS_PARAM, list(values))

    def get_case_sensitive(self) -> bool:
        return self.get(self.CASE_SENSITIVE)

    def set_case_sensitive(self, value: bool):
        return self.set(self.CASE_SENSITIVE, value)

    def get_locale(self) -> str:
        return self.get(self.LOCALE)

    def set_locale(self, value: str):
        return self.set(self.LOCALE, value)


class StopWordsRemover(Transformer, StopWordsRemoverParams):
    fusable = False
    fusable_reason = "string filtering over host token lists"

    @staticmethod
    def load_default_stop_words(language: str) -> List[str]:
        return load_default_stop_words(language)

    @staticmethod
    def get_available_locales() -> List[str]:
        return ["en_US"]

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        in_cols, out_cols = self.get_input_cols(), self.get_output_cols()
        if len(in_cols) != len(out_cols):
            raise ValueError("inputCols and outputCols must have the same length")
        case_sensitive = self.get_case_sensitive()
        stop = set(self.get_stop_words())
        if not case_sensitive:
            stop = {w.lower() for w in stop}
        stop_arr = np.asarray(sorted(stop))
        updates = {}
        for name, out_name in zip(in_cols, out_cols):
            col = table.column(name)
            if isinstance(col, DictTokenMatrix):
                vocab = col.vocab if case_sensitive else np.char.lower(col.vocab.astype(str))
                keep_vocab = ~np.isin(vocab, stop_arr)
                updates[out_name] = DictTokenMatrix(
                    col.vocab, tokens_ops.filter_tokens_chunked(col.ids, keep_vocab))
                continue
            A = _tokens.token_matrix(col)
            if A is not None:
                probe = A if case_sensitive else np.char.lower(A)
                updates[out_name] = _tokens.ragged_from_mask(A, ~np.isin(probe, stop_arr))
                continue
            out = np.empty(len(col), dtype=object)
            for i, tokens in enumerate(col):
                if case_sensitive:
                    out[i] = [t for t in tokens if t not in stop]
                else:
                    out[i] = [t for t in tokens if t.lower() not in stop]
            updates[out_name] = out
        return [table.with_columns(updates)]
