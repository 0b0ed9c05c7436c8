"""Tokenizer: lowercases strings and splits them on whitespace.

Port of flink_ml_tpu/models/feature/tokenizer.py (the reference's
Tokenizer.java, `input.toLowerCase().split("\\s")`). String work is host
work: a unicode string column is split once per distinct string
(`_tokens.map_rows_by_unique`), any other column row by row; the output is
an object column of token lists, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ... import config
from ...api import Transformer
from ...common.param import HasInputCol, HasOutputCol
from ...table import Table
from . import _tokens


class TokenizerParams(HasInputCol, HasOutputCol):
    pass


def split_one(s: str) -> list:
    """Java's String.split("\\s"): empty tokens between separators stay,
    trailing empty ones go."""
    tokens = re.split(r"\s", s.lower())
    while tokens and tokens[-1] == "":
        tokens.pop()
    return tokens


class Tokenizer(Transformer, TokenizerParams):
    fusable = False
    fusable_reason = "host string splitting"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        col = table.column(self.get_input_col())
        S = _tokens.string_column(col)
        if S is not None:
            out = _tokens.map_rows_by_unique(S, split_one)
        else:
            out = np.empty(len(col), dtype=object)
            for i, s in enumerate(col):
                out[i] = split_one(str(s))
        return [table.with_columns({self.get_output_col(): out})]
