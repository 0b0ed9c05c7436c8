"""RegexTokenizer: splits strings on a regex, or keeps its matches.

Port of flink_ml_tpu/models/feature/regextokenizer.py (the reference's
RegexTokenizer.java and RegexTokenizerParams.java: `pattern` default
"\\s+", `gaps` (the pattern matches separators when true, tokens when
false), `minTokenLength`, `toLowercase`). Host work, as Tokenizer's: a
unicode string column is tokenized once per distinct string.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ... import config
from ...api import Transformer
from ...common.param import HasInputCol, HasOutputCol
from ...param import BooleanParam, IntParam, ParamValidators, StringParam
from ...table import Table
from . import _tokens


class RegexTokenizerParams(HasInputCol, HasOutputCol):
    MIN_TOKEN_LENGTH = IntParam(
        "minTokenLength", "Minimum token length", 1, ParamValidators.gt_eq(0)
    )
    GAPS = BooleanParam("gaps", "Set regex to match gaps or tokens", True)
    PATTERN = StringParam("pattern", "Regex pattern used for tokenizing", r"\s+")
    TO_LOWERCASE = BooleanParam(
        "toLowercase",
        "Whether to convert all characters to lowercase before tokenizing",
        True,
    )

    def get_min_token_length(self) -> int:
        return self.get(self.MIN_TOKEN_LENGTH)

    def set_min_token_length(self, value: int):
        return self.set(self.MIN_TOKEN_LENGTH, value)

    def get_gaps(self) -> bool:
        return self.get(self.GAPS)

    def set_gaps(self, value: bool):
        return self.set(self.GAPS, value)

    def get_pattern(self) -> str:
        return self.get(self.PATTERN)

    def set_pattern(self, value: str):
        return self.set(self.PATTERN, value)

    def get_to_lowercase(self) -> bool:
        return self.get(self.TO_LOWERCASE)

    def set_to_lowercase(self, value: bool):
        return self.set(self.TO_LOWERCASE, value)


class RegexTokenizer(Transformer, RegexTokenizerParams):
    fusable = False
    fusable_reason = "host regex matching over a string column"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        pattern = re.compile(self.get_pattern())
        gaps = self.get_gaps()
        min_len = self.get_min_token_length()
        lower = self.get_to_lowercase()
        col = table.column(self.get_input_col())

        def tokenize(s: str) -> list:
            text = s.lower() if lower else s
            if gaps:
                tokens = pattern.split(text)
            else:  # whole matches, not groups (RegexTokenizer.java matcher.group())
                tokens = [m.group(0) for m in pattern.finditer(text)]
            return [t for t in tokens if len(t) >= min_len]

        S = _tokens.string_column(col)
        if S is not None:
            out = _tokens.map_rows_by_unique(S, tokenize)
        else:
            out = np.empty(len(col), dtype=object)
            for i, s in enumerate(col):
                out[i] = tokenize(str(s))
        return [table.with_columns({self.get_output_col(): out})]
