"""AgglomerativeClustering — hierarchical clustering with four linkages.

Port of flink_ml_tpu/models/clustering/agglomerativeclustering.py (the
reference's clustering/agglomerativeclustering/AgglomerativeClustering.java:
nearest-neighbour agglomeration, linkage ward, complete, single or average
through Lance-Williams updates, a stop at numClusters or at
distanceThreshold, computeFullTree to log the merges past the stop; ward
needs euclidean). The output is two tables: the input with the prediction
column, and the merge log (clusterId1, clusterId2, distance,
sizeOfMergedCluster).

The work is host work, as in the JAX package (its `prefers_host_input`):
a tensor column is read back first; the pairwise matrix is built in
float64 numpy with the JAX package's formulas, so it has the same bits;
the merge loop is `native/src/agglomerative.cc`, built at first use
(`native.load_agglomerative`). The stage has no other loop: the numpy
loop (`cluster_block_plain`) is kept as the plain version the tests and
`chip_smoke.py` hold the native loop against, and it takes the same
merges in the same order. The windows param picks the rows each local
clustering runs over (AgglomerativeClustering.java:122-133).
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from ... import config
from ...api import AlgoOperator
from ...common.param import HasDistanceMeasure, HasFeaturesCol, HasPredictionCol, HasWindows
from ...common.window import (
    CountTumblingWindows,
    EventTimeSessionWindows,
    EventTimeTumblingWindows,
    GlobalWindows,
    ProcessingTimeSessionWindows,
    ProcessingTimeTumblingWindows,
)
from ...native import load_agglomerative
from ...parallel.prefetch import to_device
from ...param import BooleanParam, DoubleParam, IntParam, ParamValidators, StringParam
from ...table import Table, as_dense_matrix
from ...utils.datastream import event_time_groups_from_table

LINKAGE_WARD = "ward"
LINKAGE_COMPLETE = "complete"
LINKAGE_SINGLE = "single"
LINKAGE_AVERAGE = "average"


class AgglomerativeClusteringParams(
    HasDistanceMeasure, HasFeaturesCol, HasPredictionCol, HasWindows
):
    NUM_CLUSTERS = IntParam("numClusters", "The max number of clusters to create.", 2)
    DISTANCE_THRESHOLD = DoubleParam(
        "distanceThreshold",
        "Threshold to decide whether two clusters should be merged.",
        None,
    )
    LINKAGE = StringParam(
        "linkage",
        "Criterion for computing distance between two clusters.",
        LINKAGE_WARD,
        ParamValidators.in_array(
            [LINKAGE_WARD, LINKAGE_COMPLETE, LINKAGE_AVERAGE, LINKAGE_SINGLE]
        ),
    )
    COMPUTE_FULL_TREE = BooleanParam(
        "computeFullTree",
        "Whether computes the full tree after convergence.",
        False,
        ParamValidators.not_null(),
    )

    def get_num_clusters(self):
        return self.get(self.NUM_CLUSTERS)

    def set_num_clusters(self, value):
        return self.set(self.NUM_CLUSTERS, value)

    def get_distance_threshold(self):
        return self.get(self.DISTANCE_THRESHOLD)

    def set_distance_threshold(self, value):
        return self.set(self.DISTANCE_THRESHOLD, value)

    def get_linkage(self) -> str:
        return self.get(self.LINKAGE)

    def set_linkage(self, value: str):
        return self.set(self.LINKAGE, value)

    def get_compute_full_tree(self) -> bool:
        return self.get(self.COMPUTE_FULL_TREE)

    def set_compute_full_tree(self, value: bool):
        return self.set(self.COMPUTE_FULL_TREE, value)


_LINKAGE_CODES = {LINKAGE_SINGLE: 0, LINKAGE_COMPLETE: 1, LINKAGE_AVERAGE: 2, LINKAGE_WARD: 3}


def pairwise_host(X: np.ndarray, measure_name: str) -> np.ndarray:
    """float64 pairwise distances in numpy, the JAX package's formulas
    (its `_pairwise_host`) op for op."""
    X = np.asarray(X, dtype=np.float64)
    if measure_name == "euclidean":
        x2 = np.einsum("ij,ij->i", X, X)
        sq = x2[:, None] - 2.0 * (X @ X.T) + x2[None, :]
        return np.sqrt(np.maximum(sq, 0.0))
    if measure_name == "cosine":
        xn = np.sqrt(np.einsum("ij,ij->i", X, X))
        sim = (X @ X.T) / np.maximum(np.outer(xn, xn), 1e-12)
        return 1.0 - sim
    if measure_name == "manhattan":
        n = X.shape[0]
        out = np.empty((n, n), dtype=np.float64)
        step = max(1, (8 << 20) // max(X.size, 1))  # ~8M-element temporaries
        for s in range(0, n, step):
            out[s: s + step] = np.abs(X[s: s + step, None, :] - X[None, :, :]).sum(-1)
        return out
    raise ValueError(f"Unsupported distance measure {measure_name!r}")


def distance_matrix(X: np.ndarray, measure_name: str) -> np.ndarray:
    """The merge loops' input: the pairwise matrix with +inf on the diagonal."""
    dist = pairwise_host(X, measure_name)
    np.fill_diagonal(dist, np.inf)
    return dist


def cluster_block_native(dist, linkage, num_clusters, threshold, compute_full_tree):
    """The merge loop of native/src/agglomerative.cc over `dist` (consumed
    in place): window-local predictions (int32) and the merge log."""
    n = dist.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), []
    lib = load_agglomerative()
    dist = np.ascontiguousarray(dist, dtype=np.float64)
    merges_out = np.empty((max(n - 1, 1), 4), dtype=np.float64)
    pred = np.empty(n, dtype=np.int32)
    num = lib.agg_cluster(
        dist.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(n),
        ctypes.c_int(_LINKAGE_CODES[linkage]),
        ctypes.c_double(threshold if threshold is not None else 0.0),
        ctypes.c_int(1 if threshold is not None else 0),
        ctypes.c_long(num_clusters),
        ctypes.c_int(1 if compute_full_tree else 0),
        merges_out.ctypes.data_as(ctypes.c_void_p),
        pred.ctypes.data_as(ctypes.c_void_p),
    )
    merges = [(int(a), int(b), float(d), int(s)) for a, b, d, s in merges_out[:num]]
    _, pred = np.unique(pred, return_inverse=True)
    return pred.astype(np.int32), merges


def _lance_williams_update(d_ik, d_jk, d_ij, size_i, size_j, size_k, linkage):
    """Distance of the merged cluster (i + j) to every other cluster k."""
    if linkage == LINKAGE_SINGLE:
        return np.minimum(d_ik, d_jk)
    if linkage == LINKAGE_COMPLETE:
        return np.maximum(d_ik, d_jk)
    if linkage == LINKAGE_AVERAGE:
        return (size_i * d_ik + size_j * d_jk) / (size_i + size_j)
    # ward, on euclidean distances. Squares are products, as in the native
    # loop: the JAX package's `d_ij**2` of a numpy float64 scalar goes
    # through the C library's pow, which on some platforms is an ulp off
    # d_ij * d_ij (ROADMAP C.15)
    total = size_i + size_j + size_k
    return np.sqrt(
        ((size_i + size_k) * (d_ik * d_ik) + (size_j + size_k) * (d_jk * d_jk)
         - size_k * (d_ij * d_ij)) / total
    )


def cluster_block_plain(dist, linkage, num_clusters, threshold, compute_full_tree):
    """The plain version of the native loop: the JAX package's numpy loop
    (cached per-row nearest neighbours, Lance-Williams row updates, fresh
    ids n, n+1, ... for merged clusters), over `dist` (consumed in place).
    The stage never calls it."""
    n = dist.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), []
    num_active = n
    sizes = np.ones(n, dtype=np.int64)
    cluster_ids = list(range(n))
    members = {i: [i] for i in range(n)}
    merges = []  # (id1, id2, distance, merged size)
    merge_members = []  # the rows merged at each step, for the labels
    next_merge_stopped = None  # the merge count at which the stop hit
    row_min = dist.min(axis=1) if n > 1 else np.full(n, np.inf)
    row_arg = dist.argmin(axis=1) if n > 1 else np.zeros(n, np.int64)
    row_ids = np.arange(n)
    while num_active > 1:
        i = int(np.argmin(row_min))
        j = int(row_arg[i])
        d_ij = row_min[i]
        stop_hit = (threshold is not None and d_ij > threshold) or (
            threshold is None and num_active <= num_clusters)
        if stop_hit and next_merge_stopped is None:
            next_merge_stopped = len(merges)
            if not compute_full_tree:
                break
        id_i, id_j = cluster_ids[i], cluster_ids[j]
        lo, hi = (id_i, id_j) if id_i < id_j else (id_j, id_i)
        merges.append((lo, hi, float(d_ij), int(sizes[i] + sizes[j])))
        new_row = _lance_williams_update(dist[i], dist[j], d_ij, sizes[i], sizes[j], sizes,
                                         linkage)
        finite = np.isfinite(dist[i]) & np.isfinite(dist[j])
        dist[i, finite] = new_row[finite]
        dist[finite, i] = new_row[finite]
        dist[i, i] = np.inf
        dist[j, :] = np.inf
        dist[:, j] = np.inf
        # the nearest-neighbour cache: j dies, i rescans, a row nearer to
        # the merged cluster points at i, a row whose nearest was i or j
        # (and did not come nearer) rescans
        row_min[j], row_arg[j] = np.inf, j
        row_min[i], row_arg[i] = dist[i].min(), int(dist[i].argmin())
        nr = np.where(finite, new_row, np.inf)
        better = nr < row_min
        better[i] = False
        row_min[better] = nr[better]
        row_arg[better] = i
        stale = np.flatnonzero(
            ((row_arg == i) | (row_arg == j)) & ~better & (row_ids != i) & finite)
        for k in stale:
            row_min[k] = dist[k].min()
            row_arg[k] = int(dist[k].argmin())
        sizes[i] += sizes[j]
        cluster_ids[i] = n + len(merges) - 1
        members[i].extend(members.pop(j))
        merge_members.append(list(members[i]))
        num_active -= 1
    stop_at = next_merge_stopped if next_merge_stopped is not None else len(merges)
    pred = np.arange(n, dtype=np.int64)
    for rows in merge_members[:stop_at]:
        pred[rows] = min(pred[r] for r in rows)
    _, pred = np.unique(pred, return_inverse=True)
    return pred.astype(np.int32), merges


def window_row_groups(table: Table, n: int, windows) -> List[np.ndarray]:
    """The row groups each local clustering runs over. Count windows fire
    only when full (the ragged tail is dropped); event-time windows read
    the table's `timestamp` column (ms) and fire in window-start order; a
    bounded table arrives at one instant, so the processing-time windows
    are one global window."""
    if isinstance(windows, CountTumblingWindows):
        size = int(windows.size)
        n_whole = (n // size) * size
        return [np.arange(start, start + size) for start in range(0, n_whole, size)]
    if isinstance(windows, (GlobalWindows, ProcessingTimeTumblingWindows,
                            ProcessingTimeSessionWindows)):
        return [np.arange(n)] if n else []
    if isinstance(windows, (EventTimeTumblingWindows, EventTimeSessionWindows)):
        return event_time_groups_from_table(table, windows)
    raise ValueError(f"Unsupported windows descriptor {type(windows).__name__}")


class AgglomerativeClustering(AlgoOperator, AgglomerativeClusteringParams):
    fusable = False
    fusable_reason = "O(n^2) host linkage build (prefers_host_input); no record-wise device kernel exists"
    prefers_host_input = True

    def transform(self, *inputs: Table) -> List[Table]:
        config.device()  # an entry point: no silent CPU without a request
        (table,) = inputs
        linkage = self.get_linkage()
        measure_name = self.get_distance_measure()
        if linkage == LINKAGE_WARD and measure_name != "euclidean":
            raise ValueError(
                f"{measure_name} was provided as distance measure while linkage was "
                "ward. Ward only works with euclidean."
            )
        features = table.column(self.get_features_col())
        X = as_dense_matrix(features)  # a tensor column is read back
        num_clusters = self.get_num_clusters()
        threshold = self.get_distance_threshold()
        if threshold is not None:
            num_clusters = 1  # the threshold decides instead (reference semantics)
        compute_full_tree = self.get_compute_full_tree()

        groups = window_row_groups(table, X.shape[0], self.get_windows())
        kept_rows = np.concatenate(groups) if groups else np.zeros(0, np.int64)
        n_total = len(kept_rows)
        preds, all_merges = [], []
        offset = 0
        for group in groups:
            pred, merges = cluster_block_native(
                distance_matrix(X[group], measure_name), linkage, num_clusters, threshold,
                compute_full_tree)
            preds.append(pred)
            # window-local ids to global ones: local row i is output row
            # offset + i (rows come out in window order), the window's j-th
            # merge is n_total + (merges logged before it) + j
            local_n = len(pred)
            merge_base = n_total + len(all_merges)

            def remap(cid, offset=offset, local_n=local_n, merge_base=merge_base):
                if cid < local_n:
                    return cid + offset
                return merge_base + (cid - local_n)

            all_merges.extend((remap(a), remap(b), d, s) for a, b, d, s in merges)
            offset += local_n
        pred = np.concatenate(preds) if preds else np.zeros(0, np.int32)
        out = table
        # event-time groups may be a permutation of every row (unsorted
        # timestamps): reorder whenever the kept rows are not the identity
        if not np.array_equal(kept_rows, np.arange(table.num_rows)):
            out = out.take(kept_rows)
        if isinstance(features, torch.Tensor):
            pred = to_device(pred, features.device)
        out = out.with_columns({self.get_prediction_col(): pred})
        merge_table = Table({
            "clusterId1": [m[0] for m in all_merges],
            "clusterId2": [m[1] for m in all_merges],
            "distance": [m[2] for m in all_merges],
            "sizeOfMergedCluster": [m[3] for m in all_merges],
        })
        return [out, merge_table]
