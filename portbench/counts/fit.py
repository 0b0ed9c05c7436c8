"""Bytes and operations of one whole fit of a linear model by mini-batch
SGD: what the least implementation must read and write, from the shapes.

- each epoch reads its batch once: the rows (dense float32, or padded-CSR
  int32 indices and float32 values) and, where the table has one, the
  weight column; epoch e reads batch e mod num_batches, and maxIter
  epochs run (a log loss stays far above the configurations' tol);
- the label check reads every label of the table once;
- the coefficient goes in once (the initial zeros) and comes out once.

Operations: the row dots and the gradient, a multiply and an add each per
feature read; the pointwise loss and multiplier, 12 a row; the update and
the proximal step, 6 a coefficient, each epoch. The bytes bound every
configuration here by orders of magnitude.
"""

import math


def shapes(config):
    """(rows, features a row, coefficient width, weighted) of a
    configuration's table."""
    data = config["data"]
    if "nnz" in data:
        return int(data["numValues"]), int(data["nnz"]), int(data["numFeatures"]), False
    weighted = bool(config["estimator"]["params"].get("weightCol"))
    return int(data["numValues"]), int(data["vectorDim"]), int(data["vectorDim"]), weighted


def row_bytes(config) -> int:
    """Bytes of one row's features."""
    return shapes(config)[1] * (8 if "nnz" in config["data"] else 4)


def count(config, params=None):
    """(bytes, operations) of one fit of `config` (its estimator's
    parameters, or `params` over them)."""
    p = {**config["estimator"]["params"], **(params or {})}
    n, k, d, weighted = shapes(config)
    batch, epochs = int(p["globalBatchSize"]), int(p["maxIter"])
    num_batches = math.ceil(n / batch)
    per_epoch = 0
    flops = 0
    for e in range(epochs):
        lo = (e % num_batches) * batch
        rows = min(batch, n - lo)
        per_epoch += rows * (row_bytes(config) + (4 if weighted else 0))
        flops += 4 * rows * k + 12 * rows + 6 * d
    return per_epoch + n * 4 + 2 * d * 4, flops
