"""ChiSqTest — Pearson chi-square independence test stage.

Port of flink_ml_tpu/models/stats/chisqtest.py (the reference's
stats/chisqtest/ChiSqTest.java). The contingency math is host work in
both packages (ops/stats.py `chi_square_test`): a tensor column is read
back.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ... import config
from ...api import AlgoOperator
from ...common.param import HasFeaturesCol, HasFlatten, HasLabelCol
from ...ops import stats
from ...table import Table, _to_numpy, as_dense_matrix
from ._common import result_table


class ChiSqTestParams(HasFeaturesCol, HasLabelCol, HasFlatten):
    pass


class ChiSqTest(AlgoOperator, ChiSqTestParams):
    fusable = False
    fusable_reason = "aggregate statistic: reduces the input to a single results row, not a record-wise transform"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        y = np.asarray(_to_numpy(table.column(self.get_label_col())), dtype=np.float64)
        p_values, dofs, statistics = stats.chi_square_test(X, y)
        return [result_table(self.get_flatten(), p_values, dofs, statistics,
                             "statistic", "statistics")]
