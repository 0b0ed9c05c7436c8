"""KBinsDiscretizer: bins continuous features by the uniform, quantile or
kmeans strategy.

Port of flink_ml_tpu/models/feature/kbinsdiscretizer.py (the reference's
KBinsDiscretizer.java:341 and KBinsDiscretizerModel.java): the model is
each feature's increasing bin edges, duplicate edges collapse, and a
feature left with at most 2 edges (a constant one) bins everything to 0.
A value's bin is the number of edges at or below it, minus one, clamped
to [0, numBins - 1]; NaN goes to the top bin.

The fit first keeps `subSamples` rows, drawn on the host with
`RandomState(0).choice(n, subSamples, replace=False)` as the JAX package
draws them (so both keep the same rows, and even the uniform strategy's
min and max see only those; the draw is kept for the next fit of as many
rows) and gathered on the device. Then:

- uniform: the column min and max on the device, in the column's dtype,
  edges linspace(min, max) in float64 on the host;
- quantile: the column quantiles of `ops.quantile`, as `jnp.quantile`
  computes them for a tensor column and as `np.quantile` does for a host
  column in float64;
- kmeans: the JAX package's host 1-D Lloyd on each column of the sample.

A `StreamTable` fits out of core on the host as the JAX package does:
Greenwald-Khanna sketches (relative error 1e-4) for quantile, a running
min and max for uniform, and for kmeans a reservoir of `subSamples` rows
(`utils.datastream.sample`, seed 0) fitted as a bounded Table.

The transform bins on the column's device with one `searchsorted` per
feature against its edges: a tensor column gives a tensor in its dtype, a
host column float64 numpy.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model, as_kernel_matrix
from ...common.param import HasInputCol, HasOutputCol
from ...common.quantilesummary import column_sketches, update_column_sketches
from ...ops.quantile import jnp_quantile, numpy_quantile
from ...parallel.prefetch import to_device
from ...param import IntParam, ParamValidators, StringParam
from ...table import StreamTable, Table, as_dense_matrix
from ...utils import javacodec, read_write
from ...utils.datastream import sample as reservoir_sample
from ...utils.param_utils import update_existing_params
from .. import _linear
from . import _columns

UNIFORM = "uniform"
QUANTILE = "quantile"
KMEANS = "kmeans"
#: the GK relative error of the stream quantile fit: a bin boundary's rank
#: error well under one bin at the reference's default numBins
STREAM_RELATIVE_ERROR = 1e-4


class KBinsDiscretizerModelParams(HasInputCol, HasOutputCol):
    pass


class KBinsDiscretizerParams(KBinsDiscretizerModelParams):
    STRATEGY = StringParam(
        "strategy",
        "Strategy used to define the width of the bin.",
        QUANTILE,
        ParamValidators.in_array([UNIFORM, QUANTILE, KMEANS]),
    )
    NUM_BINS = IntParam("numBins", "Number of bins to produce.", 5, ParamValidators.gt_eq(2))
    SUB_SAMPLES = IntParam(
        "subSamples",
        "Maximum number of samples used to fit the model.",
        200000,
        ParamValidators.gt_eq(2),
    )

    def get_strategy(self) -> str:
        return self.get(self.STRATEGY)

    def set_strategy(self, value: str):
        return self.set(self.STRATEGY, value)

    def get_num_bins(self) -> int:
        return self.get(self.NUM_BINS)

    def set_num_bins(self, value: int):
        return self.set(self.NUM_BINS, value)

    def get_sub_samples(self) -> int:
        return self.get(self.SUB_SAMPLES)

    def set_sub_samples(self, value: int):
        return self.set(self.SUB_SAMPLES, value)


def kmeans_1d_edges(col: np.ndarray, num_bins: int) -> np.ndarray:
    """1-D Lloyd on the column; edges are the midpoints of the sorted
    centroids, between the column's min and max (the KMEANS strategy)."""
    uniq = np.unique(col)
    k = min(num_bins, uniq.size)
    centroids = np.quantile(col, np.linspace(0, 1, k))
    centroids = np.unique(centroids)
    for _ in range(100):
        assign = np.argmin(np.abs(col[:, None] - centroids[None, :]), axis=1)
        new_c = np.array([col[assign == j].mean() if np.any(assign == j) else centroids[j]
                          for j in range(centroids.size)])
        if np.allclose(new_c, centroids):
            break
        centroids = new_c
    centroids = np.sort(centroids)
    mids = (centroids[1:] + centroids[:-1]) / 2.0
    return np.concatenate([[col.min()], mids, [col.max()]])


def bin_all(X: torch.Tensor, bin_edges: List[np.ndarray], edge_tensors=None) -> torch.Tensor:
    """Each feature's bin on X's device, in X's dtype: #edges <= x minus
    one, clamped to [0, edges - 2]; NaN to the top bin; a feature with at
    most 2 edges to bin 0. The edges are cast to X's dtype, as the JAX
    device path casts them. A NaN edge (a quantile fit over a column with
    +inf interpolates inf - inf) never counts as <= x, as in both JAX paths
    (np.searchsorted sorts NaN last, the compare-sum finds it false), so
    only the other edges are searched; the top bin still counts it.
    `edge_tensors` are those searched edges already on X's device (any
    float dtype), one a feature; without them they are uploaded here."""
    out = torch.empty_like(X)
    for j, edges in enumerate(bin_edges):
        top = max(edges.size - 2, 0)
        if top == 0:
            out[:, j] = 0
            continue
        if edge_tensors is None:
            e = to_device(edges[~np.isnan(edges)], X.device, X.dtype)
        else:
            e = edge_tensors[j].to(X.dtype)
        idx = torch.searchsorted(e, X[:, j].contiguous(), right=True) - 1
        idx = torch.where(torch.isnan(X[:, j]), top, idx.clamp(0, top))
        out[:, j] = idx.to(X.dtype)
    return out


class KBinsDiscretizerModel(Model, KBinsDiscretizerModelParams):
    fusable = True

    def __init__(self):
        self.bin_edges: List[np.ndarray] = None  # per feature, increasing

    def _constant_sources(self):
        return (self.bin_edges,)

    def _kernel_constants(self):
        return {"edges": [e[~np.isnan(e)] for e in self.bin_edges]}

    def transform_kernel(self, consts, cols, ctx):
        X = as_kernel_matrix(cols[self.get_input_col()])
        cols[self.get_output_col()] = bin_all(X, self.bin_edges, consts["edges"])
        return cols

    def set_model_data(self, *inputs: Table) -> "KBinsDiscretizerModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.bin_edges = [np.asarray(e, dtype=np.float64) for e in row["binEdges"]]
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"binEdges": [[e.tolist() for e in self.bin_edges]]})]

    def transform(self, *inputs: Table) -> List[Table]:
        (table,) = inputs
        return [self._transform_with_kernel(
            table, lambda col: _columns.staged_matrix(col, torch.float64))]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(
            path, binEdges=np.asarray([np.asarray(e) for e in self.bin_edges], dtype=object))

    def _load_extra(self, path: str) -> None:
        arrays = read_write.load_arrays_or_reference(
            path, javacodec.load_reference_kbinsdiscretizer, allow_pickle=True)
        self.bin_edges = [np.asarray(e, dtype=np.float64) for e in arrays["binEdges"]]


@lru_cache(maxsize=8)
def subsample_rows(n: int, sub: int) -> torch.Tensor:
    """The rows the fit keeps, RandomState(0).choice(n, sub, replace=False),
    as a host int64 tensor (not to be written). The draw permutes all n
    rows on the host, so it is kept for the next fit of as many rows."""
    return torch.from_numpy(np.random.RandomState(0).choice(n, size=sub, replace=False))


class KBinsDiscretizer(Estimator, KBinsDiscretizerParams):

    checkpointable = False
    checkpoint_reason = "single-pass quantile/width binning; a restart recomputes the fit"

    def fit(self, *inputs: Table) -> KBinsDiscretizerModel:
        (table,) = inputs
        if isinstance(table, StreamTable):
            return self._fit_stream(table)
        col = table.column(self.get_input_col())
        on_device = _columns.is_device_column(col)
        X = _columns.staged_matrix(col)
        if X.shape[0] > self.get_sub_samples():
            X = X[to_device(subsample_rows(X.shape[0], self.get_sub_samples()), X.device)]
        strategy, num_bins = self.get_strategy(), self.get_num_bins()
        if strategy == UNIFORM:
            # a host column's float32 stays float32, as numpy's min/max keep it
            lo_hi = _linear.packed_to_host(torch.stack(torch.aminmax(X, dim=0)))[0]
            # unique collapses a constant feature to <= 2 edges, which the
            # transform maps to bin 0 (KBinsDiscretizer.java:63-64)
            edges = [np.unique(np.linspace(lo_hi[0, j], lo_hi[1, j], num_bins + 1))
                     for j in range(X.shape[1])]
        elif strategy == QUANTILE:
            qs = np.linspace(0.0, 1.0, num_bins + 1)
            if on_device:
                all_edges = jnp_quantile(X, qs)
            else:
                all_edges = numpy_quantile(X.to(torch.float64), qs)
            all_edges = _linear.packed_to_host(all_edges)[0]
            edges = [np.unique(all_edges[:, j]) for j in range(X.shape[1])]
        else:  # kmeans: the JAX package's host 1-D Lloyd on each sampled column
            # tpulint: disable=host-sync-leak -- the kmeans strategy's host 1-D Lloyd
            X_host = X.cpu().numpy()
            edges = [np.asarray(kmeans_1d_edges(X_host[:, j], num_bins), dtype=np.float64)
                     for j in range(X_host.shape[1])]
        model = KBinsDiscretizerModel()
        model.bin_edges = edges
        update_existing_params(model, self)
        return model

    def _fit_stream(self, stream) -> KBinsDiscretizerModel:
        """Out-of-core fit over a StreamTable on the host, as the JAX
        package's: GK sketches for quantile, a running min and max for
        uniform, a reservoir sample for kmeans."""
        config.device()  # the sample's fit computes there; no silent CPU
        strategy, num_bins = self.get_strategy(), self.get_num_bins()
        if strategy == KMEANS:
            return self.fit(reservoir_sample(stream, self.get_sub_samples(), seed=0))
        sketches = mins = maxs = None
        for batch in stream:
            X = as_dense_matrix(batch.column(self.get_input_col()))
            if X.shape[0] == 0:
                continue
            if strategy == QUANTILE:
                if sketches is None:
                    sketches = column_sketches(X.shape[1], STREAM_RELATIVE_ERROR)
                update_column_sketches(sketches, X)
            else:
                bmin, bmax = X.min(axis=0), X.max(axis=0)
                mins = bmin if mins is None else np.minimum(mins, bmin)
                maxs = bmax if maxs is None else np.maximum(maxs, bmax)
        if sketches is None and mins is None:
            raise ValueError("cannot fit KBinsDiscretizer on an empty stream")
        if strategy == QUANTILE:
            qs = np.linspace(0.0, 1.0, num_bins + 1)
            edges = [np.unique(np.asarray(s.compress().query(qs), dtype=np.float64))
                     for s in sketches]
        else:
            edges = [np.unique(np.linspace(mins[j], maxs[j], num_bins + 1))
                     for j in range(mins.size)]
        model = KBinsDiscretizerModel()
        model.bin_edges = edges
        update_existing_params(model, self)
        return model
