"""Bytes and operations of one transform of `rows` rows by a linear
classifier: each row's features read once (dense float32, or padded-CSR
int32 indices and float32 values), the coefficient read once, and the
outputs written once: the float32 prediction and the two float32 columns
of rawPrediction. A multiply and an add per feature read, 6 a row for the
sigmoid and the label."""

from . import fit


def count(config, rows: int):
    """(bytes, operations)."""
    _, k, d, _ = fit.shapes(config)
    return rows * fit.row_bytes(config) + d * 4 + rows * (4 + 8), rows * (2 * k + 6)
