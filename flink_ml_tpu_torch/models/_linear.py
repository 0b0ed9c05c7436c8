"""Shared machinery for linear-model estimators: train-data extraction,
SGD wiring and the batched predict path.

Port of the bounded-Table half of flink_ml_tpu/models/_linear.py (the
reference's LogisticRegression.java:70-114 and
LogisticRegressionModel.java:64,131). Tensor columns stay on their device;
host columns become float64 numpy and the SGD engine casts them once to
its float32 compute dtype as it stages them to `config.device()`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import config
from ..ops.losses import LossFunc, predict_raw, sparse_dot, sparse_variant
from ..ops.optimizer import SGD, read_train_result
from ..table import SparseBatch, Table, as_dense_matrix


def extract_train_data(
    table: Table,
    features_col: str,
    label_col: Optional[str],
    weight_col: Optional[str],
) -> Tuple[object, Optional[object], Optional[object]]:
    """A SparseBatch features column stays sparse and is returned as the
    (indices, values, dim) triple the SGD engine trains on natively."""
    col = table.column(features_col)
    if isinstance(col, SparseBatch):
        X = (col.indices, col.values, col.size)
    else:
        X = as_dense_matrix(col, allow_device=True)
    y = None if label_col is None else _as_host_or_device_vector(table.column(label_col))
    w = None if weight_col is None else _as_host_or_device_vector(table.column(weight_col))
    return X, y, w


def _as_host_or_device_vector(col):
    if isinstance(col, torch.Tensor):
        return col
    return np.asarray(col, dtype=np.float64)


def run_sgd(params, table: Table, loss_func: LossFunc, weight_col: Optional[str],
            validate_binomial: bool = False):
    """Wire a Has*-param stage into the SGD optimizer; returns
    (coefficient, final_loss, num_epochs). Host labels are validated on the
    host before training; tensor labels inside the fit, read back with its
    packed result."""
    optimizer = SGD(
        max_iter=params.get_max_iter(),
        learning_rate=params.get_learning_rate(),
        global_batch_size=params.get_global_batch_size(),
        tol=params.get_tol(),
        reg=params.get_reg(),
        elastic_net=params.get_elastic_net(),
    )
    X, y, w = extract_train_data(
        table, params.get_features_col(), params.get_label_col(), weight_col
    )
    validate_on_device = False
    if validate_binomial:
        if isinstance(y, torch.Tensor):
            validate_on_device = True
        else:
            validate_binomial_labels(y)
    if isinstance(X, tuple):  # sparse: train on padded CSR, no densify
        indices, values, dim = X
        X = (indices, values)
        loss_func = sparse_variant(loss_func.name)
        init_coeff = np.zeros(dim, dtype=np.float64)
    else:
        init_coeff = np.zeros(X.shape[1], dtype=np.float64)
    result = optimizer.optimize_async(
        init_coeff, X, y, w, loss_func, validate_labels=validate_on_device
    )
    flag, coeff, criteria, epochs = read_train_result(result)
    _raise_if_invalid(flag)
    return coeff, criteria, epochs


def is_device_column(col) -> bool:
    """True when a features column is a tensor: transforms then return
    tensors on its device (device in, device out)."""
    if isinstance(col, SparseBatch):
        return isinstance(col.indices, torch.Tensor)
    return isinstance(col, torch.Tensor)


def column_device(col) -> torch.device:
    """The device a transform of `col` computes on: a tensor column's own,
    else `config.device()` for host columns."""
    if isinstance(col, SparseBatch):
        col = col.indices
    return col.device if isinstance(col, torch.Tensor) else config.device()


def sparse_raw_scores(indices, values, coeff):
    """Per-row dot of padded-CSR features with the coefficient, the sparse
    inference hot loop (LogisticRegressionModel.java:131)."""
    return sparse_dot(indices, values, coeff)


def raw_scores(col, coeff: torch.Tensor) -> torch.Tensor:
    """X @ coeff for any features layout, on coeff's device: dense host or
    tensor columns, or a SparseBatch, which is never densified."""
    device = coeff.device
    if isinstance(col, SparseBatch):
        indices = torch.as_tensor(col.indices, dtype=torch.int32, device=device)
        values = torch.as_tensor(col.values, dtype=torch.float32, device=device)
        return sparse_raw_scores(indices.contiguous(), values.contiguous(), coeff)
    X = as_dense_matrix(col, allow_device=True)
    return predict_raw(torch.as_tensor(X, dtype=coeff.dtype, device=device), coeff)


def _raise_if_invalid(flag) -> None:
    if flag is not None and not bool(flag):
        raise ValueError(
            "Multinomial classification is not supported yet. "
            "Supported options: [auto, binomial]."
        )


def validate_binomial_labels(y) -> None:
    """The reference supports only {0, 1} labels for binary linear
    classifiers (LogisticRegression.java:78-87)."""
    _raise_if_invalid(bool(np.all((y == 0.0) | (y == 1.0))))
