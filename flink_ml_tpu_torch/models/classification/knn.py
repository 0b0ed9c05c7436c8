"""Knn — k-nearest-neighbors classification by brute force.

Port of flink_ml_tpu/models/classification/knn.py (the reference's
classification/knn/Knn.java, whose model is the training matrix and its
labels, and KnnModel.java, a distance scan and a top-k majority vote a
row). The scan is one float32 matmul a chunk of test rows on the card,
t2 - 2 X Yᵀ + r2 as the JAX package computes it, then the k nearest
training rows in `lax.top_k`'s order: nearer first and, among equal
distances, the lower training index first. torch.topk promises no order
among equal values, so the order is made explicit: each distance's
order-preserving int32 bits and its column index form one int64 key,
and the k smallest keys are unique. The indices come back in one
readback; the vote is on the host, and a tie goes to the smallest label.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import HasFeaturesCol, HasLabelCol, HasPredictionCol
from ...parallel.prefetch import to_device
from ...param import IntParam, ParamValidators
from ...table import Table, _to_numpy, as_dense_matrix
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .._linear import is_device_column

#: bytes a chunk of test rows may take for its distances and keys
_CHUNK_BYTES = 1 << 30


class KnnModelParams(HasFeaturesCol, HasPredictionCol):
    K = IntParam("k", "The number of nearest neighbors.", 5, ParamValidators.gt(0))

    def get_k(self) -> int:
        return self.get(self.K)

    def set_k(self, value: int):
        return self.set(self.K, value)


class KnnParams(KnnModelParams, HasLabelCol):
    pass


def ordered_keys(dists: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as (distance, column index): the float32
    distance's bits made order-preserving as int32 (negative values have
    their magnitude bits flipped; -0.0 counts as 0.0) in the high half, the
    column in the low half."""
    bits = (dists + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(dists.shape[1], dtype=torch.int64, device=dists.device)
    return (bits.to(torch.int64) << 32) | cols


def top_k_indices(X_test: torch.Tensor, X_train: torch.Tensor, k: int) -> torch.Tensor:
    """(n_test, k) indices of the nearest training rows by squared
    euclidean distance in float32, in `lax.top_k(-dists, k)`'s order."""
    n_train = X_train.shape[0]
    t2 = torch.sum(X_test * X_test, dim=1, keepdim=True)
    r2 = torch.sum(X_train * X_train, dim=1)[None, :]
    chunk = max(1, _CHUNK_BYTES // (24 * max(n_train, 1)))
    out = []
    for s in range(0, X_test.shape[0], chunk):
        dists = t2[s:s + chunk] - 2.0 * (X_test[s:s + chunk] @ X_train.T) + r2
        keys = torch.topk(ordered_keys(dists), k, dim=1, largest=False, sorted=True).values
        out.append(keys & 0xFFFFFFFF)
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int64, device=X_test.device)


def _majority_vote(neighbor_labels: np.ndarray) -> np.ndarray:
    """Per-row majority label over (n, k) neighbors, vectorized
    (KnnModel.java voting; ties break to the smallest label value, like
    np.unique + first-argmax)."""
    n, k = neighbor_labels.shape
    S = np.sort(neighbor_labels, axis=1)
    first = np.ones((n, k), dtype=bool)
    first[:, 1:] = S[:, 1:] != S[:, :-1]
    pos = np.arange(k)
    first_pos = np.where(first, pos, k)
    suffix = np.minimum.accumulate(first_pos[:, ::-1], axis=1)[:, ::-1]
    next_first = np.concatenate([suffix[:, 1:], np.full((n, 1), k)], axis=1)
    run_len = np.where(first, next_first - pos, 0)
    best = np.argmax(run_len, axis=1)  # first max = smallest tied label
    return S[np.arange(n), best].astype(np.float64)


class KnnModel(Model, KnnModelParams):
    fusable = False
    fusable_reason = "top-k search runs as its own chunked device driver; the k-neighbor label vote is host-side f64"

    def __init__(self):
        self.features = None  # (n_train, d): host array or tensor
        self.labels = None  # (n_train,): host float64 or tensor

    def set_model_data(self, *inputs: Table) -> "KnnModel":
        (model_data,) = inputs
        self.features = as_dense_matrix(model_data.column("features"))
        self.labels = np.asarray(_to_numpy(model_data.column("labels")), dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"features": self.features, "labels": self.labels})]

    def transform(self, *inputs: Table) -> List[Table]:
        device = config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        if isinstance(X, torch.Tensor):
            device = X.device
        k = min(self.get_k(), self.features.shape[0])
        idx = top_k_indices(to_device(X, device, torch.float32),
                            to_device(self.features, device, torch.float32), k)
        # one readback either way: the neighbours' labels gathered on the
        # card, or their indices (never packed with float labels: float32
        # would round an index above 2**24)
        if isinstance(self.labels, torch.Tensor):
            # tpulint: disable=host-sync-leak -- the transform's one readback (host predictions)
            neighbor_labels = to_device(self.labels, device)[idx].double().cpu().numpy()
        else:
            # tpulint: disable=host-sync-leak -- the transform's one readback
            neighbor_labels = np.asarray(self.labels, dtype=np.float64)[idx.cpu().numpy()]
        pred = _majority_vote(neighbor_labels)
        return [table.with_columns({self.get_prediction_col(): pred})]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, features=_to_numpy(self.features),
                                     labels=_to_numpy(self.labels))

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(path, javacodec.load_reference_knn)
        self.features, self.labels = arrays["features"], arrays["labels"]


class Knn(Estimator, KnnParams):

    checkpointable = False
    checkpoint_reason = (
        "fit materializes the training set as the model (no "
        "iterations); a restart recomputes the repack"
    )

    def fit(self, *inputs: Table) -> KnnModel:
        """The training set is the model (Knn.java): a tensor column stays
        on its device, a host one stays on the host."""
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        model = KnnModel()
        model.features = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        labels = table.column(self.get_label_col())
        model.labels = labels if is_device_column(labels) else np.asarray(labels, dtype=np.float64)
        update_existing_params(model, self)
        return model
