"""Jobs the mesh tests run on every rank of a world (parallel/launcher.py).

A rank imports its job by module path, so the jobs live here, in a module
that imports torch, numpy and the port only (never JAX: a rank must not
load it, and tests/test_torch_imports.py scans this file). Each job takes
host values and returns host values (numpy, floats, dicts), computed on
this rank under `config.use_device("cpu")`, which the world's ranks enter
at start.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.analysis import sanitizer
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import collectives, mesh
from flink_ml_tpu_torch.utils import metrics


def rank_info():
    m = mesh.default_mesh()
    return {"rank": m.rank, "shape": dict(m.shape), "threads": torch.get_num_threads(),
            "device": str(m.device)}


def _mine(per_rank):
    """This rank's row of an (R, ...) host array, as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(per_rank[mesh.default_mesh().rank]))


def _host(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def reduce_tree(per_rank, chunk_bytes, ring):
    """(monolithic, chunked) all-reduce of this rank's mixed tree (a
    multi-dim leaf and a nested pair, as tests/test_collective_chunks.py's
    `_tree`)."""
    v = _mine(per_rank)
    tree = {"a": v[:1000].reshape(10, 100), "b": (v[1000:1003], v[1003:])}
    whole = collectives.all_reduce_sum(tree)
    chunked = collectives.all_reduce_sum_chunked(tree, chunk_bytes=chunk_bytes, ring=ring)
    pending = collectives.all_reduce_sum_chunked(tree, chunk_bytes=chunk_bytes, ring=ring,
                                                 async_op=True)
    return _host((whole, chunked, pending.result()))


def reduce_mixed_dtypes(per_rank_f, per_rank_i, chunk_bytes):
    return _host(collectives.all_reduce_sum_chunked((_mine(per_rank_f), _mine(per_rank_i)),
                                                    chunk_bytes=chunk_bytes))


def chunk_counters(per_rank, chunk_bytes):
    """The counters' delta over one chunked reduce of this rank's row."""
    before = metrics.snapshot()
    collectives.all_reduce_sum_chunked(_mine(per_rank), chunk_bytes=chunk_bytes)
    return metrics.snapshot_delta(before, metrics.snapshot())["counters"]


def sparse_vs_dense(idx_per_rank, val_per_rank, dim):
    """(sparse pair reduce, densified monolithic reduce, counters delta)."""
    idx, val = _mine(idx_per_rank), _mine(val_per_rank)
    before = metrics.snapshot()
    sparse = collectives.sparse_all_reduce_sum(idx, val, dim)
    delta = metrics.snapshot_delta(before, metrics.snapshot())
    keep = (idx >= 0) & (idx < dim)
    dense = torch.zeros(dim).index_add_(0, torch.where(keep, idx, 0).long(),
                                        torch.where(keep, val, 0.0))
    return sparse.numpy(), collectives.all_reduce_sum(dense).numpy(), delta["counters"], \
        metrics.snapshot()["gauges"].get("collective.sparse_ratio")


def primitives(per_rank):
    """Every wrapper once on this rank's (R * 2, 3) block."""
    x = _mine(per_rank)
    m = mesh.default_mesh()
    return _host({
        "sum": collectives.all_reduce_sum(x), "mean": collectives.all_reduce_mean(x),
        "max": collectives.all_reduce_max(x), "min": collectives.all_reduce_min(x),
        "gather0": collectives.all_gather(x), "gather1": collectives.all_gather(x, axis=1),
        "stacked": collectives.all_gather(x, tiled=False),
        "scatter": collectives.reduce_scatter(x), "ring": collectives.ppermute_ring(x),
        "ring2": collectives.ppermute_ring(x, shift=2),
        "size": collectives.axis_size(), "index": collectives.axis_index(), "rank": m.rank,
    })


def _loss(name, sparse):
    return losses.SPARSE_VARIANTS[name] if sparse else losses.by_name(name)


def sgd_fit(X, y, w, d, loss_name, kwargs, sparse_pairs_threshold=None):
    """The SGD fit of (X, y, w) on the default mesh, every rank passing the
    whole data: (coeff, loss, epochs, counters delta, this rank's recorded
    collective sequence)."""
    sparse = isinstance(X, tuple)
    before = metrics.snapshot()
    with sanitizer.collective_recording() as rec:
        if sparse_pairs_threshold is not None:
            prev = config.collective_sparse_threshold
            config.collective_sparse_threshold = sparse_pairs_threshold
        try:
            coeff, loss, epochs = optimizer.SGD(**kwargs).optimize(
                np.zeros(d), X, y, w, _loss(loss_name, sparse))
        finally:
            if sparse_pairs_threshold is not None:
                config.collective_sparse_threshold = prev
    delta = metrics.snapshot_delta(before, metrics.snapshot())
    seq = [list(e) for e in rec.collective_sequences.get("trace", {}).get("0", [])]
    return np.asarray(coeff), float(loss), int(epochs), delta["counters"], seq


def estimator_fit(kind, columns, params):
    """An estimator's fit on the default mesh: the model's arrays. A column
    given as ("sparse", dim, indices, values) becomes a SparseBatch;
    params["_overlap"] turns `config.collective_overlap` on for the fit."""
    from flink_ml_tpu_torch import SparseBatch, Table

    columns = {name: SparseBatch(col[1], col[2], col[3])
               if isinstance(col, tuple) and col[0] == "sparse" else col
               for name, col in columns.items()}
    if kind == "kmeans":
        from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

        est = KMeans()
    elif kind == "lr":
        from flink_ml_tpu_torch.models.classification.logisticregression import \
            LogisticRegression
        est = LogisticRegression()
    elif kind == "svc":
        from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC

        est = LinearSVC()
    else:
        from flink_ml_tpu_torch.models.regression.linearregression import LinearRegression

        est = LinearRegression()
    params = dict(params)
    overlap = params.pop("_overlap", False)
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
    with config.collective_overlap_mode(overlap):
        model = est.fit(Table(columns))
    if kind == "kmeans":
        return {"centroids": model.centroids, "weights": model.weights}
    return {"coefficient": np.asarray(model.coefficient)}


def skip_a_collective(skip_rank, timeout_s):
    """Both ranks reduce once; then every rank but `skip_rank` (none when it
    is -1) reduces again over a group whose collectives time out after
    `timeout_s`, and the ranks compare their recorded sequences over the
    world's group. Returns (divergence messages, whether this rank's second
    reduce raised)."""
    import datetime

    import torch.distributed as dist

    rank = dist.get_rank()
    short = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
    m = mesh.create_mesh(group=short)
    raised = False
    with sanitizer.collective_recording() as rec:
        with rec.shard_scope(rank):
            collectives.all_reduce_sum(torch.ones(4), mesh=m)
            if rank != skip_rank:
                try:
                    collectives.all_reduce_sum(torch.ones(4), mesh=m)
                except RuntimeError:
                    raised = True
        problems = sanitizer.compare_rank_sequences(rec=rec)
    return problems, raised


def raise_on(rank):
    """Raise on `rank`, return its rank elsewhere: a failing rank."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank()
