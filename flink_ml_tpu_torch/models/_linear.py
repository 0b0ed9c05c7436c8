"""Shared machinery for linear-model estimators: train-data extraction,
SGD wiring, the batched predict path and the coefficient model data that
LogisticRegression, LinearSVC and LinearRegression models share.

Port of flink_ml_tpu/models/_linear.py (the
reference's LogisticRegression.java:70-114 and
LogisticRegressionModel.java:64,131). Tensor columns stay on their device;
host columns become float64 numpy and the SGD engine casts them once to
its float32 compute dtype as it stages them to `config.device()`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..api import as_kernel_matrix
from ..linalg import DenseVector
from ..ops.losses import LossFunc, predict_raw, sparse_dot, sparse_variant
from ..ops.optimizer import SGD, read_train_result
from ..parallel.prefetch import to_device
from ..table import SparseBatch, StreamTable, Table, as_dense_matrix
from ..utils import javacodec, read_write
from ..utils.packing import packed_device_get


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


def run_sgd(params, table, loss_func: LossFunc, weight_col: Optional[str],
            validate_binomial: bool = False):
    """Wire a Has*-param stage into the SGD optimizer; returns
    (coefficient, final_loss, num_epochs). Host labels are validated on the
    host before training; tensor labels inside the fit, read back with its
    packed result.

    A bounded `Table` trains on the device; a `StreamTable` trains out of
    core (`SGD.optimize_stream`) on the same batch schedule, so both give
    the same coefficients for the same rows. Checkpoint and resume follow
    `config.iteration_checkpoint_dir`, the files named by the stage's
    `checkpoint_job_key`."""
    from ..parallel.iteration import checkpoint_job_key

    ckpt_dir = config.iteration_checkpoint_dir
    optimizer = SGD(
        max_iter=params.get_max_iter(),
        learning_rate=params.get_learning_rate(),
        global_batch_size=params.get_global_batch_size(),
        tol=params.get_tol(),
        reg=params.get_reg(),
        elastic_net=params.get_elastic_net(),
        checkpoint_dir=ckpt_dir,
        checkpoint_interval=config.iteration_checkpoint_interval,
        checkpoint_key=checkpoint_job_key(params) if ckpt_dir is not None else None,
    )
    if isinstance(table, StreamTable):
        chunks = _stream_chunks(table, params.get_features_col(), params.get_label_col(),
                                weight_col, validate_binomial)
        coeff, loss, epochs, _ = optimizer.optimize_stream(None, chunks, loss_func)
        return coeff, loss, epochs
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


def _stream_chunks(stream, features_col, label_col, weight_col, validate_binomial):
    """Host (X, y, w) chunks from a StreamTable's Tables, dense (a sparse
    column is densified, as the JAX package's stream path does); labels are
    validated chunk by chunk when asked."""
    for batch in stream:
        X = _host(as_dense_matrix(batch.column(features_col), allow_device=True))
        y = _host(batch.column(label_col)).astype(np.float64, copy=False)
        w = None if weight_col is None else _host(batch.column(weight_col))
        if validate_binomial:
            validate_binomial_labels(y)
        yield X, y, w


def _host(col) -> np.ndarray:
    return col.detach().cpu().numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


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


def packed_to_host(*tensors, sync_kind: str = "fit"):
    """Read tensors back in ONE accounted transfer
    (`utils.packing.packed_device_get`, one `iteration.host_sync.<sync_kind>`):
    float64 numpy arrays of the original shapes."""
    return [a.astype(np.float64) for a in packed_device_get(*tensors, sync_kind=sync_kind)]


def sparse_raw_scores(indices, values, coeff):
    """Per-row dot of padded-CSR features with the coefficient, the sparse
    inference hot loop (LogisticRegressionModel.java:131)."""
    return sparse_dot(indices, values, coeff)


def raw_scores(col, coeff: torch.Tensor) -> torch.Tensor:
    """X @ coeff for a tensor features column on coeff's device: dense
    rows, or a SparseBatch, which is never densified."""
    if isinstance(col, SparseBatch):
        return sparse_raw_scores(col.indices.to(torch.int32).contiguous(),
                                 col.values.to(torch.float32).contiguous(), coeff)
    return predict_raw(as_kernel_matrix(col).to(coeff.dtype), coeff)


def staged_features(col):
    """A host features column as the kernels take it, on `config.device()`:
    a SparseBatch as int32 indices and float32 values (never densified),
    dense rows as float32."""
    device = config.device()
    if isinstance(col, SparseBatch):
        return SparseBatch(col.size, to_device(col.indices, device, torch.int32),
                           to_device(col.values, device, torch.float32))
    return to_device(as_dense_matrix(col), device, torch.float32)


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


class CoefficientModelData:
    """The model data of a linear model: one coefficient vector, a float64
    host array. As a one-row Table of a DenseVector (get/set_model_data),
    and as `coefficient` in the `.npz` model data (save/load); a directory
    the reference wrote loads through `_load_reference`. On the card the
    kernels read it as float32 constants (`device_constants`), and take a
    dense or a SparseBatch features column."""

    coefficient: np.ndarray = None
    fusable = True
    graph_shareable = True
    kernel_supports_sparse = True
    #: decodes a reference-written model directory to the coefficient
    #: (LinearSVCModelData and LinearRegressionModelData: one DenseVector)
    _load_reference = staticmethod(javacodec.load_reference_coefficient)

    def set_model_data(self, *inputs: Table):
        (model_data,) = inputs
        rows = model_data.collect()
        self.coefficient = np.asarray(rows[0]["coefficient"].to_array(), dtype=np.float64)
        return self

    def get_model_data(self):
        return [Table({"coefficient": [DenseVector(self.coefficient)]})]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, coefficient=self.coefficient)

    def _load_extra(self, path: str) -> None:
        loaded = read_write.load_arrays_or_reference(path, self._load_reference)
        self.coefficient = loaded["coefficient"] if isinstance(loaded, dict) else loaded

    def _constant_sources(self):
        return (self.coefficient,)

    def _kernel_constants(self):
        return {"coefficient": np.asarray(self.coefficient, np.float32)}

    def kernel_output_dtypes(self, cols):
        return dict.fromkeys(self.kernel_output_cols(), torch.float32)

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(table, staged_features)]

    def _host_outputs(self, out):
        # float64 host arrays, read back in one accounted transfer
        return dict(zip(out, packed_to_host(*out.values(), sync_kind="transform")))
