"""Jobs the 2D-mesh, fleet-on-a-mesh and mesh-recovery tests run on every
rank of a world (parallel/launcher.py).

A rank imports its job by module path, so the jobs live here, in a module
that imports torch, numpy and the port only (never JAX: a rank must not
load it, and tests/test_torch_imports.py scans this file). Each job takes
host values and returns host values, computed on this rank under
`config.use_device("cpu")`, which the world's ranks enter at start. A job
that needs a 2D mesh makes it with `mesh.create_mesh_2d` (every rank calls
it with the same arguments; the sub-groups are made once a layout) and
runs under `mesh.use_mesh`.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.analysis import sanitizer
from flink_ml_tpu_torch.ckpt import faults
from flink_ml_tpu_torch.obs import memledger
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import collectives, mesh
from flink_ml_tpu_torch.utils import metrics


def _mesh(shape):
    """The mesh of `shape` over the world: (R,) the data mesh, (nd, m) the
    2D mesh, None the default mesh."""
    if shape is None:
        return mesh.default_mesh()
    if len(shape) == 1:
        return mesh.create_mesh()
    return mesh.create_mesh_2d(int(shape[1]))


@contextmanager
def _scoped(shape):
    m = _mesh(shape)
    with mesh.use_mesh(m):
        yield m


def mesh_info(model_shards, num_hosts=None):
    """The 2D mesh's shape, this rank's coordinates and its axis groups'
    members (global ranks), or the ValueError's message."""
    import torch.distributed as dist

    try:
        m = mesh.create_mesh_2d(model_shards, num_hosts=num_hosts)
    except ValueError as e:
        return {"error": str(e)}
    groups = {a: sorted(dist.get_process_group_ranks(m.axis_group(a)))
              if m.axis_group(a) is not None else [m.rank] for a in m.axis_names}
    return {"shape": dict(m.shape), "rank": m.rank, "coords": m.coords(), "groups": groups,
            "hosts": mesh.host_groups(m, 2)}


def two_axis_accounting(dim):
    """One sparse pair exchange over `data` and one psum over `model` on a
    2 x 2 mesh (tests/test_sparse_2d_mesh.py's body): (counters delta,
    gauges delta, per-axis wire bytes, the result)."""
    with _scoped((2, 2)) as m:
        idx = torch.arange(4, dtype=torch.int32)
        val = torch.ones(4)
        before = metrics.snapshot()
        g = collectives.sparse_all_reduce_sum(idx, val, dim, mesh.DATA_AXIS, mesh=m)
        total = collectives.all_reduce_sum(torch.sum(g), mesh.MODEL_AXIS, mesh=m)
        delta = metrics.snapshot_delta(before, metrics.snapshot())
    return (delta["counters"], delta["gauges"], collectives.axis_wire_bytes(delta),
            (g + total).numpy())


def sparse_fit(shape, X, y, d, kwargs, mode="auto", plain=False, hbm_budget=None):
    """SGD(shard_features=True) of the sparse X on the mesh of `shape`, every
    rank passing the whole data: (coeff, loss, epochs, counters delta,
    per-axis wire bytes, this rank's recorded collectives, this rank's
    coefficient slice of the model axis, the optimizer category's live
    bytes); with `hbm_budget` the fit runs under that budget and a refusal
    comes back as ("HbmBudgetExceeded", requested bytes)."""
    name = "binary_logistic"
    loss = (losses.PLAIN_SPARSE_VARIANTS if plain else losses.SPARSE_VARIANTS)[name]
    with _scoped(shape) as m:
        memledger.reset()
        before = metrics.snapshot()
        try:
            with config.sparse_2d_mode(mode), config.hbm_budget_mode(hbm_budget), \
                    sanitizer.collective_recording() as rec:
                coeff, crit, epochs = optimizer.SGD(shard_features=True, **kwargs).optimize(
                    np.zeros(d), X, y, None, loss, mesh=m)
        except memledger.HbmBudgetExceeded as e:
            return ("HbmBudgetExceeded", e.requested_bytes)
        finally:
            live = memledger.live_bytes("optimizer")
        delta = metrics.snapshot_delta(before, metrics.snapshot())
        seq = [list(e) for e in rec.collective_sequences.get("trace", {}).get("0", [])]
        nm = mesh.num_model_shards(m)
        d_local = -(-d // nm)
        j = m.axis_index(mesh.MODEL_AXIS)
        padded = np.pad(np.asarray(coeff), (0, d_local * nm - d))
        return (np.asarray(coeff), float(crit), int(epochs), delta["counters"],
                collectives.axis_wire_bytes(delta), seq, padded[j * d_local:(j + 1) * d_local],
                live)


def sequences_2d(X, y, d, kwargs):
    """A 2D fit on the 2 x 2 mesh recorded under this rank's shard, then the
    ranks' sequences compared over the world (`compare_rank_sequences` with
    the mesh): the problems."""
    with _scoped((2, 2)) as m:
        with sanitizer.collective_recording() as rec:
            with rec.shard_scope(m.rank):
                optimizer.SGD(shard_features=True, **kwargs).optimize(
                    np.zeros(d), X, y, None, losses.SPARSE_BINARY_LOGISTIC_LOSS, mesh=m)
            return sanitizer.compare_rank_sequences(rec=rec, mesh=m)


def estimator_fit_2d(shape, columns, params):
    """A LogisticRegression fit of a sparse column on the default mesh of
    `shape`: the coefficient."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.models.classification.logisticregression import \
        LogisticRegression

    columns = {name: SparseBatch(col[1], col[2], col[3])
               if isinstance(col, tuple) and col[0] == "sparse" else col
               for name, col in columns.items()}
    est = LogisticRegression()
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
    with _scoped(shape):
        return np.asarray(est.fit(Table(columns)).coefficient)


def checkpointed_fit(shape, X, y, d, kwargs, ckpt_dir, key, kill_after=None):
    """A checkpointed (feature-sharded when X is sparse) SGD fit on the mesh
    of `shape`; with `kill_after` the `chunk` fault fires at that drained
    chunk on every rank. Returns (coeff, loss, epochs) or "killed"."""
    sparse = isinstance(X, tuple)
    loss = losses.SPARSE_BINARY_LOGISTIC_LOSS if sparse else losses.BINARY_LOGISTIC_LOSS
    sgd = optimizer.SGD(shard_features=sparse, checkpoint_dir=ckpt_dir, checkpoint_key=key,
                        **kwargs)
    with _scoped(shape) as m:
        if kill_after is not None:
            try:
                with faults.inject("chunk", after=kill_after):
                    sgd.optimize(np.zeros(d), X, y, None, loss, mesh=m)
            except faults.InjectedFault:
                return "killed"
        coeff, crit, epochs = sgd.optimize(np.zeros(d), X, y, None, loss, mesh=m)
    return np.asarray(coeff), float(crit), int(epochs)


def fleet_fit(shape, kind, columns, member_params, solo=True, shard=None, threshold=-1,
              overlap=False, stream_batches=None):
    """A FitFleet of `kind` ("lr", "svc", "linreg", "kmeans") on the default
    mesh of `shape`, and each member's solo fit on the same mesh: (fleet
    arrays, solo arrays, the gauges fleet.sharded / fleet.size, counters
    delta). `shard` is `shard_fleet_axis`; `threshold` (not -1) the
    `fleet_shard_threshold`; `stream_batches` fits a StreamTable of that
    many equal batches."""
    from flink_ml_tpu_torch import SparseBatch, StreamTable, Table, fleet

    columns = {name: SparseBatch(col[1], col[2], col[3])
               if isinstance(col, tuple) and col[0] == "sparse" else col
               for name, col in columns.items()}

    def estimator(params):
        if kind == "kmeans":
            from flink_ml_tpu_torch.models.clustering.kmeans import KMeans as cls
        elif kind == "lr":
            from flink_ml_tpu_torch.models.classification.logisticregression import \
                LogisticRegression as cls
        elif kind == "svc":
            from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC as cls
        else:
            from flink_ml_tpu_torch.models.regression.linearregression import \
                LinearRegression as cls
        est = cls()
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        return est

    def table():
        if stream_batches is None:
            return Table(columns)
        n = len(next(iter(columns.values())))
        step = n // stream_batches
        return StreamTable.from_batches([
            Table({k: v[i * step:(i + 1) * step] for k, v in columns.items()})
            for i in range(stream_batches)])

    def arrays(model):
        if kind == "kmeans":
            return {"centroids": np.asarray(model.centroids), "weights": np.asarray(model.weights)}
        return {"coefficient": np.asarray(model.coefficient)}

    with _scoped(shape):
        before = metrics.snapshot()
        scope = config.fleet_shard_threshold(threshold) if threshold != -1 else _nothing()
        with scope, config.collective_overlap_mode(overlap):
            models = fleet.FitFleet([estimator(p) for p in member_params],
                                    shard_fleet_axis=shard).fit(table())
        delta = metrics.snapshot_delta(before, metrics.snapshot())
        gauges = metrics.snapshot()["gauges"]
        solos = [arrays(estimator(p).fit(table())) for p in member_params] if solo else None
    return ([arrays(m) for m in models], solos,
            {"sharded": gauges.get("fleet.sharded"), "size": gauges.get("fleet.size")},
            delta["counters"])


@contextmanager
def _nothing():
    yield


def stream_fit(shape, kind, chunks, params, ckpt_dir=None, kill_after=None):
    """A StreamTable fit ("lr" or "kmeans") on the default mesh of `shape`
    over host chunks of columns; with `ckpt_dir` checkpointed (interval 2)
    and with `kill_after` killed at that epoch, then resumed. Returns the
    model's arrays."""
    from flink_ml_tpu_torch import StreamTable, Table

    def fit():
        stream = StreamTable.from_batches([Table(c) for c in chunks])
        if kind == "kmeans":
            from flink_ml_tpu_torch.models.clustering.kmeans import KMeans as cls
        else:
            from flink_ml_tpu_torch.models.classification.logisticregression import \
                LogisticRegression as cls
        est = cls()
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        model = est.fit(stream)
        if kind == "kmeans":
            return {"centroids": np.asarray(model.centroids), "weights": np.asarray(model.weights)}
        return {"coefficient": np.asarray(model.coefficient)}

    with _scoped(shape):
        if ckpt_dir is None:
            return fit()
        with config.iteration_checkpointing(ckpt_dir, interval=2):
            if kill_after is not None:
                try:
                    with faults.inject("epoch", after=kill_after):
                        fit()
                except faults.InjectedFault:
                    pass
            return fit()


def supervised_fit(X, y, d, kwargs, ckpt_dir, key):
    """The checkpointed LR fit a supervised world runs on every rank, on
    the world's default mesh (feature-sharded when X is sparse): the
    coefficient, the epochs, the mesh's shape and the epoch of the cut the
    fit restored (0: none; the fit restores its newest cut)."""
    sparse = isinstance(X, tuple)
    loss = losses.SPARSE_BINARY_LOGISTIC_LOSS if sparse else losses.BINARY_LOGISTIC_LOSS
    m = mesh.default_mesh()
    restores = metrics.get_counter("checkpoint.restore.count")
    coeff, _, epochs = optimizer.SGD(shard_features=sparse, checkpoint_dir=ckpt_dir,
                                     checkpoint_key=key, **kwargs).optimize(
        np.zeros(d), X, y, None, loss, mesh=m)
    restored = metrics.get_gauge("checkpoint.restore.epoch") \
        if metrics.get_counter("checkpoint.restore.count") > restores else 0
    return np.asarray(coeff), int(epochs), dict(m.shape), int(restored)


def killed_at_epoch(X, y, d, kwargs, ckpt_dir, key, epoch):
    """`supervised_fit`, whose rank 0 kills its own process with SIGKILL
    once the cut of `epoch` is written, when it started with no cut (no
    fault plan: a host that dies as a real one does)."""
    import os
    import signal

    from flink_ml_tpu_torch.ckpt import coordinator

    import torch.distributed as dist

    if dist.get_rank() != 0 or coordinator.committed_cuts(ckpt_dir, key):
        return supervised_fit(X, y, d, kwargs, ckpt_dir, key)
    try:
        with faults.inject("chunk", after=epoch):
            return supervised_fit(X, y, d, kwargs, ckpt_dir, key)
    except faults.InjectedFault:
        os.kill(os.getpid(), signal.SIGKILL)


def form_mesh_over(groups):
    """`mesh.form_mesh_over(groups)` in this world: the mesh's shape, or the
    ValueError's message."""
    try:
        return dict(mesh.form_mesh_over(groups).shape)
    except ValueError as e:
        return str(e)


def pulse_outside_supervision():
    """Boundary pulses of a rank that no supervisor runs: nothing fires."""
    from flink_ml_tpu_torch.parallel import supervisor

    with faults.inject("host.die", after=1):
        for phase in ("dispatch", "collective", "commit"):
            supervisor.pulse_boundary(phase)
    return True


def fleet_checkpointed(shape, columns, member_params, shard, ckpt_dir, kill_after=None):
    """A checkpointed LogisticRegression fleet (interval 2) on the default
    mesh of `shape`; with `kill_after` the `chunk` fault fires at that
    drained chunk on every rank and the fleet is fitted again, resuming.
    Returns the members' coefficients."""
    from flink_ml_tpu_torch import Table, fleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    def members():
        out = []
        for params in member_params:
            est = LogisticRegression()
            for name, value in params.items():
                getattr(est, f"set_{name}")(value)
            out.append(est)
        return out

    with _scoped(shape), config.iteration_checkpointing(ckpt_dir, interval=2):
        if kill_after is not None:
            try:
                with faults.inject("chunk", after=kill_after):
                    fleet.FitFleet(members(), shard_fleet_axis=shard).fit(Table(columns))
            except faults.InjectedFault:
                pass
        models = fleet.FitFleet(members(), shard_fleet_axis=shard).fit(Table(columns))
    return [np.asarray(m.coefficient) for m in models]


def fleet_refused(columns, member_params):
    """`shard_fleet_axis=True` for a fleet the data shards do not divide:
    the ValueError's message."""
    try:
        fleet_fit(None, "lr", columns, member_params, False, True)
    except ValueError as e:
        return str(e)
    return None
