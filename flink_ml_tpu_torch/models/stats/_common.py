"""The result tables the three statistical test stages share.

Port of the output half of flink_ml_tpu/models/stats/{chisqtest,
anovatest,fvaluetest}.py: flatten=false gives one row {pValues: vector,
degreesOfFreedom: int array, <statistics>: vector}; flatten=true gives one
row per feature {featureIndex, pValue, degreeOfFreedom, <statistic>}
(ChiSqTest.java, ANOVATest.java:287, FValueTest.java).
"""

from __future__ import annotations

import numpy as np

from ...linalg import DenseVector
from ...table import Table


def result_table(flatten: bool, p_values, dofs, values, name: str, names: str) -> Table:
    """The test's result: `name` is the flattened statistic's column, `names`
    the vector column of the one-row form."""
    if flatten:
        return Table({
            "featureIndex": np.arange(len(p_values), dtype=np.int64),
            "pValue": p_values,
            "degreeOfFreedom": dofs,
            name: values,
        })
    return Table({
        "pValues": [DenseVector(p_values)],
        "degreesOfFreedom": [dofs.tolist()],
        names: [DenseVector(values)],
    })
