"""NaiveBayes — multinomial naive Bayes over categorical feature values.

Port of flink_ml_tpu/models/classification/naivebayes.py (the reference's
NaiveBayes.java GenerateModelFunction, whose smoothing math is matched
exactly:
theta[i][j][v] = log(count(label i, feature j = v) + smoothing)
              - log(count(label i) + smoothing * numCategories[j]);
pi[i] = log(count(label i) * featureSize + smoothing)
      - log(totalDocs * featureSize + numLabels * smoothing);
NaiveBayesModel.java calculateProb, the sum of per-feature log-probs and
pi with the argmax by label; NaiveBayesModelData.java:57-69). An unseen
feature value at predict time raises, as the reference's map lookup does.

A float32 tensor column fits and predicts on its device:

- fit: a column sort gives each column's category set; the counts over
  (label, column, category) are one integer bincount a chunk of rows, so
  they are exact and the model data equals the JAX package's bit for bit;
  NaN and +inf guards and the category count ride one readback, and the
  counts another;
- predict: float32 scores in chunks of `_nb_chunk_rows` rows (a gather
  of each value's log-probs), the argmax on the card, and a float64 host
  rescore of every row whose top-2 score gap, normalised by the float32
  error scale, is below 2, so the predictions equal the float64 argmax.

The host paths are the JAX package's own: a host column, a category set
past DEVICE_MAX_CATEGORIES, a trained +inf category (the padding
sentinel), categories or labels that float32 cannot hold exactly.
`HOST_COUNTS` counts each time one is taken, and the rows rescored.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model
from ...common.param import HasFeaturesCol, HasLabelCol, HasPredictionCol
from ...parallel.prefetch import to_device
from ...param import DoubleParam, ParamValidators, StringParam
from ...table import Table, _to_numpy, as_dense_matrix
from ...utils import javacodec, read_write
from ...utils.param_utils import update_existing_params
from .._linear import packed_to_host

# Largest per-feature category count served by the device path; bigger
# category sets take the host path (the predict gathers grow with it).
DEVICE_MAX_CATEGORIES = 512
# Bound on chunk * d * m elements a predict chunk (the JAX package's).
_CHUNK_BUDGET = 5 * 10**8
# Bound on chunk * d elements a fit chunk counts (int64 bins, 512 MB).
_COUNT_BUDGET = 1 << 26
# float32 rounding scale of the top-2 gap (the JAX package's constant)
_EPS32 = 1.2e-7

#: how often each host path was taken, and the rows the gap rule rescored
HOST_COUNTS: collections.Counter = collections.Counter()


def _nb_chunk_rows(d: int, m: int) -> int:
    return max(1, min(_CHUNK_BUDGET // max(1, d * m), 1 << 24))


class NaiveBayesModelParams(HasFeaturesCol, HasPredictionCol):
    MODEL_TYPE = StringParam(
        "modelType",
        "The model type.",
        "multinomial",
        ParamValidators.in_array(["multinomial"]),
    )

    def get_model_type(self) -> str:
        return self.get(self.MODEL_TYPE)

    def set_model_type(self, value: str):
        return self.set(self.MODEL_TYPE, value)


class NaiveBayesParams(NaiveBayesModelParams, HasLabelCol):
    SMOOTHING = DoubleParam(
        "smoothing", "The smoothing parameter.", 1.0, ParamValidators.gt_eq(0.0)
    )

    def get_smoothing(self) -> float:
        return self.get(self.SMOOTHING)

    def set_smoothing(self, value: float):
        return self.set(self.SMOOTHING, value)


def _category_index(cats: torch.Tensor, Xc: torch.Tensor):
    """(d, c) positions of a chunk's values in each column's sorted
    categories (clamped into range), and whether each value is there."""
    idx = torch.searchsorted(cats, Xc.T.contiguous()).clamp_(max=cats.shape[1] - 1)
    return idx, torch.gather(cats, 1, idx) == Xc.T


class NaiveBayesModel(Model, NaiveBayesModelParams):
    fusable = False
    fusable_reason = "exactness contract needs host f64 rescoring of near-tie rows and a data-dependent unseen-category error, both mid-transform readbacks"

    def __init__(self):
        self.theta: List[List[Dict[float, float]]] = None  # [label][feature] -> {value: logp}
        self.pi: np.ndarray = None  # (numLabels,) log priors
        self.labels: np.ndarray = None  # (numLabels,) label values
        self._device_tensors = {}  # device -> (cats, logp, pi, labels), or why the host serves

    def set_model_data(self, *inputs: Table) -> "NaiveBayesModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.theta = row["theta"]
        self.pi = np.asarray(row["piArray"].to_array(), dtype=np.float64)
        self.labels = np.asarray(row["labels"].to_array(), dtype=np.float64)
        self._device_tensors = {}
        return self

    def get_model_data(self) -> List[Table]:
        from ...linalg import DenseVector

        return [
            Table(
                {
                    "theta": [self.theta],
                    "piArray": [DenseVector(self.pi)],
                    "labels": [DenseVector(self.labels)],
                }
            )
        ]

    def _theta_tensors(self):
        """(cats (d, m_max) +inf-padded, logp (d, m_max, L)) float32 views
        of the log-prob dictionaries for the device path, or (None, reason)
        when the model must be served on the host."""
        num_labels = len(self.labels)
        d = len(self.theta[0])
        per_col = [np.asarray(sorted(self.theta[0][j]), np.float64) for j in range(d)]
        m_max = max(v.size for v in per_col)
        cats = np.full((d, m_max), np.inf, np.float32)
        logp = np.zeros((d, m_max, num_labels), np.float32)
        labels_cast = self.labels.astype(np.float32)
        if not np.array_equal(labels_cast.astype(np.float64), self.labels):
            return None, "labels not exact in float32"
        for j, values in enumerate(per_col):
            if not np.isfinite(values).all():
                # +inf IS the padding sentinel, and NaN/-inf are not worth
                # a device story of their own: the host scores them exactly
                return None, "a category that is not finite"
            cast = values.astype(np.float32)
            if not np.array_equal(cast.astype(np.float64), values):
                # the float32 compare would accept values the host rejects
                return None, "categories not exact in float32"
            if np.unique(cast).size != cast.size:
                return None, "categories that float32 merges"
            cats[j, : values.size] = cast
            for r, v in enumerate(values):
                for i in range(num_labels):
                    logp[j, r, i] = self.theta[i][j][float(v)]
        return cats, logp

    def _device_model(self, device: torch.device):
        """The model's float32 tensors on `device`, uploaded as one flat
        array the first time and kept; None for a model the host serves."""
        if device not in self._device_tensors:
            self._device_tensors[device] = self._upload(device)
        tensors = self._device_tensors[device]
        if isinstance(tensors, str):
            HOST_COUNTS[f"NaiveBayes predict on the host: {tensors}"] += 1
            return None
        return tensors

    def _upload(self, device: torch.device):
        """The device tensors, or the reason the host serves the model."""
        cats_h, logp_h = self._theta_tensors()
        if cats_h is None:
            return logp_h
        d, m = cats_h.shape
        L = self.labels.size
        flat = to_device(np.concatenate([
            cats_h.ravel(), logp_h.ravel(), self.pi.astype(np.float32),
            self.labels.astype(np.float32)]), device=device)
        cm = d * m
        return (flat[:cm].reshape(d, m), flat[cm:cm + cm * L].reshape(d, m, L),
                flat[cm + cm * L:cm + cm * L + L], flat[cm + cm * L + L:])

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        n, d = X.shape
        dev = None
        if isinstance(X, torch.Tensor) and n > 0:
            if X.dtype == torch.float32:
                dev = self._device_model(X.device)
            else:  # a float64 tensor would lose category identity in float32
                HOST_COUNTS["NaiveBayes predict on the host: a column that is not float32"] += 1
        if dev is None:
            pred = self._predict_host(np.asarray(_to_numpy(X)))
            return [table.with_columns({self.get_prediction_col(): pred})]
        cats, logp, pi, labels = dev
        m_max, L = cats.shape[1], labels.shape[0]
        chunk = _nb_chunk_rows(d, m_max)
        starts = list(range(0, n, chunk))
        cols = torch.arange(d, device=X.device)[:, None] * m_max
        eps = to_device(_EPS32, X.device, torch.float32)
        preds, flags, gaps = [], [], []
        for s in starts:
            Xc = X[s:s + chunk]
            idx, seen = _category_index(cats, Xc)
            # (c, L) scores: pi plus each column's log-probs of its value
            probs = pi + logp.reshape(d * m_max, L)[cols + idx].sum(dim=0)
            preds.append(labels[torch.argmax(probs, dim=1)])
            flags.append(seen.all())
            if L >= 2:  # the top-2 gap over the float32 accumulation scale
                top2 = torch.topk(probs, 2, dim=1).values
                scale = d * eps * (top2.abs().sum(dim=1) + 1.0)
                gaps.append((top2[:, 0] - top2[:, 1]) / scale)
            else:
                gaps.append(torch.full((Xc.shape[0],), float("inf"), device=X.device))
        pred = torch.cat(preds)
        near = torch.cat(gaps) < 2.0
        ok, n_near = packed_to_host(torch.stack(flags).all().double(), near.sum().double())
        if not bool(ok):
            for s, ok_c in zip(starts, flags):
                if bool(ok_c):
                    continue
                _, seen = _category_index(cats, X[s:s + chunk])
                rows, cols_bad = np.nonzero(~seen.T.cpu().numpy())
                bad = float(X[s + rows[0], cols_bad[0]])
                raise ValueError(
                    f"Feature value {bad} in column {int(cols_bad[0])} "
                    "was not seen during training"
                )
        if n_near:
            # exactness: a row whose top-2 gap lies inside the float32 error
            # bound is rescored in float64 on the host, so every prediction
            # equals the reference's double-precision argmax
            ties = torch.nonzero(near).flatten()
            HOST_COUNTS["NaiveBayes rows rescored on the host"] += int(n_near)
            host = self._predict_host(X[ties].double().cpu().numpy())
            pred[ties] = to_device(host, pred.device, pred.dtype)
        return [table.with_columns({self.get_prediction_col(): pred})]

    def _predict_host(self, X: np.ndarray) -> np.ndarray:
        """Reference-precision (float64) scoring, columnwise on host."""
        n, d = X.shape
        num_labels = len(self.labels)
        probs = np.tile(self.pi, (n, 1))  # (n, numLabels)
        for j in range(d):
            # columnwise: sorted category values + (num_values, num_labels)
            # log-prob matrix, then one searchsorted gather per feature
            values = np.asarray(sorted(self.theta[0][j]), dtype=np.float64)
            logp = np.stack(
                [[self.theta[i][j][v] for i in range(num_labels)] for v in values]
            )  # (num_values, num_labels)
            col = X[:, j]
            pos = np.searchsorted(values, col)
            pos_clipped = np.clip(pos, 0, values.size - 1)
            unseen = (pos >= values.size) | (values[pos_clipped] != col)
            if unseen.any():
                bad = float(col[np.nonzero(unseen)[0][0]])
                raise ValueError(
                    f"Feature value {bad} in column {j} was not seen during training"
                )
            probs += logp[pos_clipped]
        return self.labels[np.argmax(probs, axis=1)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(
            path,
            theta=np.asarray(self.theta, dtype=object),
            piArray=self.pi,
            labels=self.labels,
        )

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_naivebayes, allow_pickle=True)
        self.theta = [list(row) for row in arrays["theta"]]
        self.pi = arrays["piArray"]
        self.labels = arrays["labels"]
        self._device_tensors = {}


def _device_label(y, X: torch.Tensor):
    """The label as a float32 tensor on X's device, or None when float32
    cannot hold it exactly (the counts would merge labels)."""
    if isinstance(y, torch.Tensor):
        return to_device(y, X.device) if y.dtype == torch.float32 else None
    y_np = np.asarray(y)
    y32 = y_np.astype(np.float32)
    if not np.array_equal(y32.astype(y_np.dtype), y_np, equal_nan=True):
        return None
    return to_device(y32, X.device)


class NaiveBayes(Estimator, NaiveBayesParams):

    checkpointable = False
    checkpoint_reason = "single-pass label/feature count aggregation; a restart recomputes the fit"

    def _fit_stats_device(self, X: torch.Tensor, y):
        """(labels, per-label counts, per-column categories (d, m_max),
        per-column category counts, (L, d, m_max) co-occurrence counts),
        aggregated on X's device in two readbacks; None when the JAX
        package would take its host path. Every count is an integer
        (bincount), so the statistics are exact."""
        n, d = X.shape
        if n == 0:
            return None, "an empty column"
        if X.dtype != torch.float32:
            return None, "a column that is not float32"
        y_dev = _device_label(y, X)
        if y_dev is None:
            return None, "labels not exact in float32"
        Xs = torch.sort(X, dim=0).values
        first = torch.ones((n, d), dtype=torch.bool, device=X.device)
        first[1:] = Xs[1:] != Xs[:-1]
        m_per_col = first.sum(dim=0)
        ys = torch.sort(y_dev).values
        nunique = 1 + (ys[1:] != ys[:-1]).sum()
        # readback 1: the sizes the later work is shaped by, and the
        # guards: NaN features would inflate the category sets (NaN != NaN)
        nan_y, nan_x, inf_x, m_max, num_labels = packed_to_host(
            torch.isnan(y_dev).any().double(), torch.isnan(X).any().double(),
            torch.isposinf(X).any().double(), m_per_col.max().double(), nunique.double())
        if nan_y:
            raise ValueError("Label column contains null/NaN values")
        if nan_x:
            raise ValueError("Feature column contains null/NaN values")
        if inf_x:
            # +inf is the category padding below; the host trains it exactly
            return None, "a +inf feature value"
        m_max, num_labels = int(m_max), int(num_labels)
        if m_max > DEVICE_MAX_CATEGORIES:
            return None, f"more than {DEVICE_MAX_CATEGORIES} categories in a column"
        # each column's distinct values in order, +inf padded: the first
        # m_max row positions where a new value starts, then a gather
        pos = torch.where(first, torch.arange(n, dtype=torch.int32, device=X.device)[:, None], n)
        pos = torch.topk(pos, m_max, dim=0, largest=False, sorted=True).values
        vals = torch.gather(Xs, 0, pos.clamp(max=n - 1).long())
        cats = torch.where(pos < n, vals, float("inf")).T.contiguous()  # (d, m_max)
        del Xs, first, pos, vals
        labels = torch.unique_consecutive(ys)
        bins = num_labels * d * m_max
        counts = torch.zeros(bins, dtype=torch.int64, device=X.device)
        cols = torch.arange(d, device=X.device)[:, None] * m_max
        chunk = max(1, _COUNT_BUDGET // d)
        for s in range(0, n, chunk):
            idx, _ = _category_index(cats, X[s:s + chunk])
            lab = torch.searchsorted(labels, y_dev[s:s + chunk])
            counts += torch.bincount((lab[None, :] * (d * m_max) + cols + idx).reshape(-1),
                                     minlength=bins)
        label_counts = torch.bincount(torch.searchsorted(labels, y_dev), minlength=num_labels)
        # readback 2: the statistics and the arrays that shape the model
        counts_h, label_counts_h, cats_h, m_h, labels_h = packed_to_host(
            counts.double(), label_counts.double(), cats.double(), m_per_col.double(),
            labels.double())
        return (labels_h, label_counts_h, cats_h, m_h.astype(np.int64),
                counts_h.reshape(num_labels, d, m_max)), None

    def fit(self, *inputs: Table) -> NaiveBayesModel:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        smoothing = self.get_smoothing()
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        y_col = table.column(self.get_label_col())
        n, d = X.shape
        stats = None
        if isinstance(X, torch.Tensor):
            stats, reason = self._fit_stats_device(X, y_col)
            if stats is None:
                HOST_COUNTS[f"NaiveBayes fit on the host: {reason}"] += 1
        if stats is not None:
            labels_h, label_counts_arr, cats_h, m_h, counts = stats
            num_labels = len(labels_h)
            theta: List[List[Dict[float, float]]] = []
            for i in range(num_labels):
                label_theta = []
                for j in range(d):
                    m_j = int(m_h[j])
                    theta_log = math.log(label_counts_arr[i] + smoothing * m_j)
                    label_theta.append(
                        {
                            float(cats_h[j, r]): math.log(counts[i, j, r] + smoothing)
                            - theta_log
                            for r in range(m_j)
                        }
                    )
                theta.append(label_theta)
            pi_log = math.log(n * d + num_labels * smoothing)
            pi = np.asarray(
                [
                    math.log(label_counts_arr[i] * d + smoothing) - pi_log
                    for i in range(num_labels)
                ]
            )
            model = NaiveBayesModel()
            model.theta = theta
            model.pi = pi
            model.labels = labels_h
            update_existing_params(model, self)
            return model
        X = np.asarray(_to_numpy(X))
        y = np.asarray(_to_numpy(y_col), dtype=np.float64)
        if np.isnan(y).any():
            raise ValueError("Label column contains null/NaN values")
        if np.isnan(X).any():
            # a NaN "category" can never be matched at predict time
            # (NaN != NaN): reject it like a NaN label
            raise ValueError("Feature column contains null/NaN values")
        labels = np.unique(y)
        num_labels = len(labels)
        label_counts = {float(l): int(np.sum(y == l)) for l in labels}
        # per-feature category sets across ALL labels
        categories = [np.unique(X[:, j]) for j in range(d)]
        theta: List[List[Dict[float, float]]] = []
        for l in labels:
            rows = X[y == l]
            label_theta = []
            for j in range(d):
                values, counts = np.unique(rows[:, j], return_counts=True)
                count_map = dict(zip(values, counts))
                theta_log = math.log(label_counts[float(l)] + smoothing * len(categories[j]))
                label_theta.append(
                    {
                        float(v): math.log(count_map.get(v, 0.0) + smoothing) - theta_log
                        for v in categories[j]
                    }
                )
            theta.append(label_theta)
        pi_log = math.log(n * d + num_labels * smoothing)
        pi = np.asarray(
            [
                math.log(label_counts[float(l)] * d + smoothing) - pi_log
                for l in labels
            ]
        )
        model = NaiveBayesModel()
        model.theta = theta
        model.pi = pi
        model.labels = labels.astype(np.float64)
        update_existing_params(model, self)
        return model
