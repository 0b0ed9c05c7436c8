"""RandomSplitter — randomly splits a table into weighted fractions.

Port of flink_ml_tpu/models/feature/randomsplitter.py (the reference's
RandomSplitter.java and RandomSplitterParams.java: `weights` default
[1.0, 1.0], each > 0; `seed`). One host draw of
`RandomState(seed % 2**32).random_sample(n)`, a searchsorted into the
cumulative fractions, then `Table.take` of each part: a tensor column is
gathered on its device with the indices staged there once, so the split
equals the JAX package's row for row on every column layout and a device
table is never read back.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ... import config
from ...api import AlgoOperator
from ...common.param import HasSeed
from ...param import DoubleArrayParam, ParamValidator
from ...table import Table


def _weights_validator():
    def check(v):
        return v is not None and len(v) >= 2 and all(w > 0 for w in v)

    return ParamValidator(check, "at least two positive weights")


class RandomSplitterParams(HasSeed):
    WEIGHTS = DoubleArrayParam(
        "weights",
        "The weights of data splitting.",
        [1.0, 1.0],
        _weights_validator(),
    )

    def get_weights(self):
        return self.get(self.WEIGHTS)

    def set_weights(self, *values: float):
        return self.set(self.WEIGHTS, list(values))


def split_assignments(num_rows: int, weights, seed: int) -> np.ndarray:
    """The part each row goes to: a uniform host draw placed into the
    cumulative fractions of `weights`."""
    weights = np.asarray(weights, dtype=np.float64)
    fractions = np.cumsum(weights) / weights.sum()
    draws = np.random.RandomState(seed % (2**32)).random_sample(num_rows)
    return np.searchsorted(fractions, draws, side="right")


class RandomSplitter(AlgoOperator, RandomSplitterParams):
    fusable = False
    fusable_reason = "1-to-many split with data-dependent per-output row counts (host RNG + boolean take)"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        weights = self.get_weights()
        assign = split_assignments(table.num_rows, weights, self.get_seed())
        return [table.take(np.nonzero(assign == i)[0]) for i in range(len(weights))]
