"""ANOVATest — one-way ANOVA F-test stage.

Port of flink_ml_tpu/models/stats/anovatest.py (the reference's
stats/anovatest/ANOVATest.java:287). A tensor features column takes the device branch
of ops/stats.py `anova_f_test`, with the label where it lives (a host
label is staged to the column's device); a host column takes the float64
branch.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import AlgoOperator
from ...common.param import HasFeaturesCol, HasFlatten, HasLabelCol
from ...ops import stats
from ...table import Table, as_dense_matrix
from ._common import result_table


class ANOVATestParams(HasFeaturesCol, HasLabelCol, HasFlatten):
    pass


class ANOVATest(AlgoOperator, ANOVATestParams):
    fusable = False
    fusable_reason = "aggregate statistic: reduces the input to a single results row, not a record-wise transform"

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        y_col = table.column(self.get_label_col())
        y = y_col if isinstance(y_col, torch.Tensor) else np.asarray(y_col, dtype=np.float64)
        p_values, dofs, f_values = stats.anova_f_test(X, y)
        return [result_table(self.get_flatten(), p_values, dofs, f_values, "fValue", "fValues")]
