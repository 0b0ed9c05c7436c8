"""KMeans: Lloyd's algorithm on one device or a mesh of ranks.

Port of flink_ml_tpu/models/clustering/kmeans.py
(the reference's KMeans.java:87-310, KMeansModel.java and
KMeansModelData.java:53-116):

- init: selectRandomCentroids (KMeans.java:310) as the JAX package draws
  it, `np.random.RandomState(seed % 2**32).choice(n, k, replace=False)`
  on the host, so both packages start from the same rows;
- the fit: maxIter epochs, each a pairwise distance, an argmin, a one-hot
  count and the per-centroid sums `one_hot.T @ X`; an empty cluster keeps
  its centroid. The epochs stay on the device with no host sync, and
  (centroids, counts) come back in one packed readback. `weights` is the
  last epoch's counts;
- the transform: the closest centroid of each row.

The sums are a matmul rather than the JAX package's reduce form
`sum(one_hot[:, :, None] * X[:, None, :], 0)`: XLA fuses that, but eager
PyTorch would materialise the (n, k, d) product (4 GB an epoch at the
1M x 10 x 100 config). A matmul is deterministic for a given shape, so a
refit gives the same bits; `index_add_` would not, its atomics reorder the
sums. The reduce form existed for the JAX package's fleet contract
(vmapped fits bit-identical to solo ones).

The fleet fit `_lloyd_fleet_train` (fleet.py) runs N Lloyd fits over one
shared X with each member's init rows and maxIter, and stacks the
members' centroids so that each epoch is two matmuls over X for all of
them: the distances to the N * k centroids and the N * k cells' sums.
Whether a stacked matmul adds in the solo one's order is the matmul
library's choice (on the CPU it does, bit for bit; PERF.md has the card).

The bounded fit and the fleet fit run through the program funnel
(utils/lazyjit.py): one captured CUDA graph per signature on the card
(X's and the init rows' shapes, maxIter, the measure), replayed by every
later fit of that signature; `config.whole_fit = "off"` runs them op by
op. X on the card is read in place (never copied into the graph), host X
is uploaded once, straight into the graph's buffer (`staged_points`).
Each runs in an `iteration.run` span (mode "device", as the JAX
package's whole Lloyd program).

A StreamTable fits out of core (`_fit_stream`): the batches are cached
once in the native data cache and replay every epoch through the device
epoch cache, one `iteration.epoch` span an epoch; that loop stays eager
(its per-epoch work is uploads).

On a mesh of more than one rank (parallel/mesh.py; the JAX package's
sharded fit, `:298-416`) every rank passes the whole table and fits on
its own rows: X padded to a multiple of the shards, this rank's block
(`mesh.shard_batch`, the rows its device holds under the JAX
`data_sharding`), with unit weights for real rows and 0 for padding, and
the init rows drawn from the whole X as on one device. Each epoch's cell
partials (`lloyd_partials`: the weighted `one_hot.T @ X` and counts) are
all-reduced before the update (`lloyd_update`), so every rank holds the
same centroids (`_lloyd_train_sharded`); under `config.collective_overlap`
the reduction is carry-delayed (`parallel.overlap.overlapped_lloyd_train`).
Those epochs run eagerly (`dispatch.whole_fit_fallback.mesh`, ROADMAP
C.28). A stream fit on a mesh of ranks stages only this rank's block of
each replayed batch (padded to a multiple of the shards, padding at weight
0) and reduces each epoch's summed partials over `data` once, before the
update. The fleet on a mesh (fleet.py) runs `_lloyd_fleet_sharded` in the
default regime: each member's partials reduced on their own, the solo
sharded fit's reduce, so no reduce adds across members.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ... import config
from ...api import Estimator, Model, as_kernel_matrix
from ...ckpt import faults
from ...ckpt import snapshot as _snapshot
from ...common.param import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
)
from ...data.devicecache import CachedEpochLoader
from ...linalg import DenseVector
from ...native.datacache import ReplayableStreamTable
from ...obs import tracing
from ...ops.distance import DistanceMeasure
from ...ops.optimizer import account_whole_fit
from ...param import IntParam, ParamValidators, StringParam
from ...parallel import mesh as mesh_lib
from ...parallel import dispatch, supervisor
from ...parallel.iteration import checkpoint_job_key
from ...parallel.prefetch import DeviceStager, to_device
from ...table import Table, as_dense_matrix
from ...utils import javacodec, lazyjit, read_write
from ...utils.param_utils import update_existing_params
from .. import _linear


class KMeansModelParams(HasDistanceMeasure, HasFeaturesCol, HasPredictionCol):
    K = IntParam("k", "The max number of clusters to create.", 2, ParamValidators.gt(1))

    def get_k(self) -> int:
        return self.get(self.K)

    def set_k(self, value: int):
        return self.set(self.K, value)


class KMeansParams(KMeansModelParams, HasSeed, HasMaxIter):
    INIT_MODE = StringParam(
        "initMode",
        "The initialization algorithm. Supported options: 'random'.",
        "random",
        ParamValidators.in_array(["random"]),
    )

    def get_init_mode(self) -> str:
        return self.get(self.INIT_MODE)

    def set_init_mode(self, value: str):
        return self.set(self.INIT_MODE, value)


def init_rows(n: int, k: int, seed: int) -> np.ndarray:
    """The rows that start the fit: selectRandomCentroids (KMeans.java:310),
    k of n without replacement, drawn on the host as the JAX package draws
    them."""
    return np.random.RandomState(seed % (2**32)).choice(n, size=k, replace=False)


def _sample_without_replacement(rng: np.random.RandomState, n: int, k: int) -> np.ndarray:
    """Seeded k-of-n sample, the JAX package's (kmeans.py:281): up to 1e7
    rows the bounded fit's `rng.choice` draw, above it rejection sampling,
    which skips RandomState.choice's permutation of all n rows."""
    if n <= 10_000_000:
        return rng.choice(n, size=k, replace=False)
    seen, out = set(), []
    while len(out) < k:
        v = int(rng.randint(0, n))
        if v not in seen:
            seen.add(v)
            out.append(v)
    return np.asarray(out, dtype=np.int64)


def staged_points(X):
    """A bounded fit's points for the funnel, and a function that gathers
    rows of them on their device: a host matrix becomes a float32
    `lazyjit.Feed` (uploaded once, straight into the graph's buffer, or
    made by an eager call), a tensor is cast to float32 on its own device
    (the graph reads it in place)."""
    if isinstance(X, torch.Tensor):
        X = X.to(torch.float32)
        return X, lambda idx: X[to_device(idx, X.device)]
    host = np.asarray(X, dtype=np.float32)
    device = config.device()
    return (lazyjit.Feed(host, host.shape, torch.float32, device),
            lambda idx: to_device(host[idx], device))


@lazyjit.lazy_jit(static_argnames=("max_iter", "measure_name"), borrow=("X",))
def _lloyd_train(X, init_centroids, max_iter: int, measure_name: str):
    """maxIter Lloyd epochs on X's device with no host sync; one program of
    the funnel. Returns (centroids, counts of the last epoch), on the
    device."""
    measure = DistanceMeasure.get_instance(measure_name)
    k = init_centroids.shape[0]
    labels = torch.arange(k, device=X.device)
    centroids = init_centroids
    counts = X.new_zeros((k,))
    for _ in range(max_iter):
        assign = measure.find_closest(X, centroids)
        one_hot = (assign[:, None] == labels).to(X.dtype)  # (n, k)
        counts = torch.sum(one_hot, dim=0)
        sums = one_hot.T @ X  # (k, d)
        centroids = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1e-30), centroids
        )
    return centroids, counts


def lloyd_partials(X, weights, centroids, measure_name: str):
    """One epoch's cell partials over this rank's rows: (sums (k, d), counts
    (k,)) of the weighted one-hot assignment, `one_hot.T @ X` as the flat
    fit sums (a padding row, weight 0, adds exact zeros)."""
    k = centroids.shape[0]
    assign = DistanceMeasure.get_instance(measure_name).find_closest(X, centroids)
    one_hot = (assign[:, None] == torch.arange(k, device=X.device)).to(X.dtype) * weights[:, None]
    return one_hot.T @ X, torch.sum(one_hot, dim=0)


def lloyd_update(centroids, sums, counts):
    """The centroids of reduced partials; an empty cell keeps its centroid."""
    return torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1e-30),
                       centroids)


def _lloyd_train_sharded(mesh, X, weights, init_centroids, max_iter: int, measure_name: str):
    """maxIter Lloyd epochs on this rank's rows, the partials of every epoch
    reduced by one all-reduce before the update. Returns (centroids, counts
    of the last epoch), equal on every rank."""
    from ...parallel import collectives

    k, d = init_centroids.shape
    centroids = init_centroids
    counts = X.new_zeros((k,))
    for _ in range(int(max_iter)):
        sums, counts = lloyd_partials(X, weights, centroids, measure_name)
        summed = collectives.all_reduce_sum(torch.cat([sums.reshape(-1), counts]), mesh=mesh)
        sums, counts = summed[:k * d].reshape(k, d), summed[k * d:]
        centroids = lloyd_update(centroids, sums, counts)
    return centroids, counts


def _lloyd_fleet_sharded(mesh, X, weights, init_centroids, max_iters, measure_name: str):
    """N Lloyd fits on this rank's rows (the fleet's default regime on a
    mesh of ranks): every epoch each member's cell partials (the weighted
    stacked `one_hot.T @ X` and counts) are all-reduced over `data` on
    their own, as the solo `_lloyd_train_sharded` reduces them; a member
    past its own maxIter keeps its centroids and counts. Returns the packed
    (N, k * d + k) tensor, equal on every rank."""
    from ...parallel import collectives

    measure = DistanceMeasure.get_instance(measure_name)
    members, k, d = init_centroids.shape
    n = X.shape[0]
    labels = torch.arange(k, device=X.device)
    limits = to_device(tuple(int(m) for m in max_iters), X.device, torch.int32)
    centroids = init_centroids
    counts = X.new_zeros((members, k))
    for e in range(max((int(m) for m in max_iters), default=0)):
        stacked = centroids.reshape(members * k, d)
        assign = torch.argmin(measure.pairwise(X, stacked).reshape(n, members, k), dim=2)
        one_hot = (assign[:, :, None] == labels).to(X.dtype) * weights[:, None, None]
        sums = (one_hot.reshape(n, members * k).T @ X).reshape(members, k, d)
        cell = torch.sum(one_hot, dim=0)
        reduced = [collectives.all_reduce_sum(torch.cat([sums[m].reshape(-1), cell[m]]),
                                              mesh=mesh) for m in range(members)]
        sums = torch.stack([r[:k * d] for r in reduced]).reshape(members, k, d)
        new_counts = torch.stack([r[k * d:] for r in reduced])
        new_centroids = torch.where(
            new_counts[..., None] > 0, sums / torch.clamp(new_counts[..., None], min=1e-30),
            centroids)
        live = e < limits
        centroids = torch.where(live[:, None, None], new_centroids, centroids)
        counts = torch.where(live[:, None], new_counts, counts)
    return torch.cat([centroids.reshape(members, k * d), counts], dim=1)


def _lloyd_fleet_train(X, init_centroids, max_iters, measure_name: str):
    """N Lloyd fits over one shared X (n, d), the member axis written out
    (the JAX package's `_lloyd_fleet_train_impl` vmaps `_lloyd_train_impl`):
    `init_centroids` (N, k, d) holds each member's init rows, `max_iters`
    its maxIter (host ints). The loop runs the largest; a member past its
    own maxIter keeps its centroids and counts, so each member ends where
    its solo fit ends. Returns ONE packed (N, k * d + k) tensor
    ([centroids.ravel | counts] per member), on the device, from one
    program of the funnel (`_lloyd_fleet_program`)."""
    max_iters = tuple(int(m) for m in max_iters)
    limits = to_device(max_iters, X.device, torch.int32)
    return _lloyd_fleet_program(X, init_centroids, limits, max_iters, measure_name)


@lazyjit.lazy_jit(static_argnames=("max_iters", "measure_name"), borrow=("X",))
def _lloyd_fleet_program(X, init_centroids, limits, max_iters, measure_name: str):
    """`_lloyd_fleet_train`'s epochs, with the members' maxIter on the
    device (`limits`, an operand: an upload cannot be captured)."""
    measure = DistanceMeasure.get_instance(measure_name)
    members, k, d = init_centroids.shape
    n = X.shape[0]
    labels = torch.arange(k, device=X.device)
    centroids = init_centroids
    counts = X.new_zeros((members, k))
    for e in range(max(max_iters, default=0)):
        stacked = centroids.reshape(members * k, d)
        assign = torch.argmin(measure.pairwise(X, stacked).reshape(n, members, k), dim=2)
        one_hot = (assign[:, :, None] == labels).to(X.dtype)  # (n, N, k)
        new_counts = torch.sum(one_hot, dim=0)  # (N, k)
        sums = (one_hot.reshape(n, members * k).T @ X).reshape(members, k, d)
        new_centroids = torch.where(
            new_counts[..., None] > 0, sums / torch.clamp(new_counts[..., None], min=1e-30),
            centroids)
        live = e < limits
        centroids = torch.where(live[:, None, None], new_centroids, centroids)
        counts = torch.where(live[:, None], new_counts, counts)
    return torch.cat([centroids.reshape(members, k * d), counts], dim=1)


def closest_centroids(measure: str, X: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Each row's closest centroid, int32: the rows of a tensor column as
    float32 against float32 centroids."""
    return DistanceMeasure.get_instance(measure).find_closest(
        as_kernel_matrix(X).to(torch.float32), centroids)


def staged_features(col) -> torch.Tensor:
    """A features column the kernel does not take as it is (a host column,
    or any SparseBatch) as dense float32 rows on the column's device
    (`config.device()` for a host column)."""
    return to_device(as_dense_matrix(col, allow_device=True), _linear.column_device(col),
                     torch.float32)


class KMeansModel(Model, KMeansModelParams):
    fusable = True
    graph_shareable = True

    def __init__(self):
        self.centroids: np.ndarray = None  # (k, d) host array
        self.weights: np.ndarray = None  # (k,) host array

    def _constant_sources(self):
        return (self.centroids,)

    def _kernel_constants(self):
        return {"centroids": np.asarray(self.centroids, np.float32)}

    def kernel_output_dtypes(self, cols):
        return dict.fromkeys(self.kernel_output_cols(), torch.int32)

    def transform_kernel(self, consts, cols, ctx):
        cols[self.get_prediction_col()] = closest_centroids(
            self.get_distance_measure(), cols[self.get_features_col()], consts["centroids"])
        return cols

    def set_model_data(self, *inputs: Table) -> "KMeansModel":
        (model_data,) = inputs
        row = model_data.collect()[0]
        self.centroids = np.stack([
            np.asarray(c.to_array() if hasattr(c, "to_array") else c, dtype=np.float64)
            for c in row["centroids"]
        ])
        w = row["weights"]
        self.weights = np.asarray(w.to_array() if hasattr(w, "to_array") else w, dtype=np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({
            "centroids": [[DenseVector(c) for c in self.centroids]],
            "weights": [DenseVector(self.weights)],
        })]

    def transform(self, *inputs: Table) -> List[Table]:
        """The closest centroid's index, int32: a tensor on the features'
        device, or host int32 numpy for host features."""
        (table,) = inputs
        return [self._transform_with_kernel(table, staged_features)]

    def _save_extra(self, path: str) -> None:
        read_write.save_model_arrays(path, centroids=self.centroids, weights=self.weights)

    def _load_extra(self, path: str) -> None:
        loaded = read_write.load_arrays_or_reference(path, javacodec.load_reference_kmeans)
        if isinstance(loaded, dict):
            self.centroids, self.weights = loaded["centroids"], loaded["weights"]
        else:  # the reference's binary KMeansModelData
            self.centroids, self.weights = loaded


class KMeans(Estimator, KMeansParams):
    """Estimator (KMeans.java:87)."""

    # out-of-core (StreamTable) fits snapshot (centroids, counts, rng) per epoch
    checkpointable = True

    def fit(self, *inputs) -> KMeansModel:
        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        X = as_dense_matrix(table.column(self.get_features_col()), allow_device=True)
        n, k = X.shape[0], self.get_k()
        if n < k:
            raise ValueError(f"Number of points ({n}) is less than k ({k})")
        mesh = mesh_lib.default_mesh()
        if mesh.size > 1:
            centroids, counts = self._fit_sharded(mesh, X, n, k)
            model = KMeansModel()
            model.centroids, model.weights = _linear.packed_to_host(centroids, counts)
            update_existing_params(model, self)
            return model
        X, rows_of = staged_points(X)
        init = rows_of(init_rows(n, k, self.get_seed()))
        if config.whole_fit != "off":
            account_whole_fit("lloyd")
        max_iter = int(self.get_max_iter())
        with tracing.span("iteration.run", mode="device", epochs=max_iter), \
                dispatch.timed_dispatch("_lloyd_train", start=0, end=max_iter):
            centroids, counts = _lloyd_train(X, init, max_iter, self.get_distance_measure())
        model = KMeansModel()
        model.centroids, model.weights = _linear.packed_to_host(centroids, counts)
        update_existing_params(model, self)
        return model

    def _fit_sharded(self, mesh, X, n: int, k: int):
        """The fit on this rank's block of X (the module docstring); returns
        (centroids, counts) on the rank's device."""
        from ...parallel import overlap

        device = X.device if isinstance(X, torch.Tensor) else config.device()
        X_local, _ = mesh_lib.shard_batch(mesh, X if isinstance(X, torch.Tensor)
                                          else np.asarray(X, np.float32))
        X_local = X_local.to(torch.float32)
        start, stop = mesh_lib.shard_bounds(n, mesh)
        weights = to_device(np.arange(start, stop) < n, device, torch.float32)
        idx = init_rows(n, k, self.get_seed())
        init = (X.index_select(0, to_device(idx, device)) if isinstance(X, torch.Tensor)
                else to_device(np.asarray(X)[idx], device)).to(torch.float32)
        max_iter = int(self.get_max_iter())
        dispatch.whole_fit_plan(start_epoch=0, max_iter=max_iter, ranks=mesh.size)
        mode = "overlap" if config.collective_overlap else "sharded"
        with tracing.span("iteration.run", mode=mode, epochs=max_iter,
                          ranks=mesh_lib.num_data_shards(mesh)):
            train = overlap.overlapped_lloyd_train if config.collective_overlap \
                else _lloyd_train_sharded
            with dispatch.timed_dispatch(train.__name__, start=0, end=max_iter):
                return train(mesh, X_local, weights, init, max_iter, self.get_distance_measure())

    def _fit_stream(self, stream) -> KMeansModel:
        """Out-of-core Lloyd over a StreamTable (or a ReplayableStreamTable).
        Pass 0 caches the batches in the native data cache and counts the
        rows; the init rows are the bounded fit's, drawn over the global row
        index and read back from the cache, from the batches that hold them. Each epoch sums per-batch
        partials of (cell sums, counts), `one_hot.T @ X` as the bounded
        Lloyd sums, and updates once at its end; the batches replay through
        the device epoch cache, staged by the prefetch worker.

        The JAX package pads each batch to a power-of-two row count by
        repeating its last row at weight 0 (`next_bucket`), which only
        bounds XLA recompiles. Eager PyTorch does not recompile for a new
        shape, so a batch goes to the device at its own row count, with no
        pad and no weight column.

        Checkpoints (JAX `:513-560`): under `config.iteration_checkpoint_dir`
        every `iteration_checkpoint_interval`-th epoch snapshots
        (centroids, counts) and the host generator's state after the init
        draw (section `rng`), keyed by `checkpoint_job_key(self)` with the
        batch count in meta, and a fit resumes from the newest snapshot;
        the `epoch` fault site ticks after each epoch.

        On a mesh of ranks (module docstring) a rank stages its block of
        each batch and reduces each epoch's partials over `data`; its cuts
        are rank cuts."""
        mesh = mesh_lib.default_mesh()
        device = mesh.device if mesh.size > 1 else config.device()
        replay = stream if isinstance(stream, ReplayableStreamTable) else ReplayableStreamTable(
            stream, config.datacache_memory_budget_bytes, config.datacache_spill_dir)
        try:
            return self._lloyd_stream(replay, device, mesh if mesh.size > 1 else None)
        finally:
            if replay is not stream:
                replay.close()

    def _lloyd_stream(self, replay, device, mesh=None) -> KMeansModel:
        from ...parallel import collectives

        col, k = self.get_features_col(), self.get_k()
        batch_rows = replay.batch_rows()  # pass 0: cache and count
        n = int(np.sum(batch_rows, dtype=np.int64))
        if n < k:
            raise ValueError(f"Number of points ({n}) is less than k ({k})")
        rng = np.random.RandomState(self.get_seed() % (2**32))
        centroid_idx = _sample_without_replacement(rng, n, k)
        bounds = np.cumsum([0] + batch_rows)
        batch_of = np.searchsorted(bounds, centroid_idx, side="right") - 1
        picked = {}
        for bi in np.unique(batch_of):  # only the batches that hold init rows
            X = np.asarray(as_dense_matrix(replay.batch(bi, [col]).column(col)), dtype=np.float32)
            for i in centroid_idx[batch_of == bi]:
                picked[int(i)] = X[i - bounds[bi]]
        init = np.stack([picked[int(i)] for i in centroid_idx])

        stager = DeviceStager(device, torch.float32)

        def stage(bi):
            X = as_dense_matrix(replay.batch(bi, [col]).column(col))
            if mesh is None:
                return stager(X)
            X = np.asarray(X, np.float32)  # this rank's block, its padding at weight 0
            start, stop = mesh_lib.shard_bounds(X.shape[0], mesh)
            return stager((mesh_lib.data_sharding(mesh, 2).take(X),
                           (np.arange(start, stop) < X.shape[0]).astype(np.float32)))

        measure = DistanceMeasure.get_instance(self.get_distance_measure())
        labels = torch.arange(k, device=device)
        centroids = to_device(init, device)
        counts = centroids.new_zeros((k,))
        nb, max_iter = len(batch_rows), int(self.get_max_iter())
        ckpt_dir = config.iteration_checkpoint_dir
        interval = max(1, int(config.iteration_checkpoint_interval))
        job_key = checkpoint_job_key(self) if ckpt_dir is not None else None
        start = 0
        if ckpt_dir is not None:
            snap = _snapshot.load_job_snapshot(
                ckpt_dir, job_key, templates={"model": (init, np.zeros(k, np.float32))},
                expect_meta={"numBatches": nb})
            if snap is not None:
                centroids, counts = _snapshot.stage_section(snap, "model", device=device,
                                                            mesh=mesh)
                start = snap.epoch
                if "rng" in snap.sections:
                    keys, pos = snap.sections["rng"]
                    rng.set_state(("MT19937", keys, int(pos[0]), int(pos[1]), float(pos[2])))

        def rng_section():
            _, keys, pos, has_gauss, cached = rng.get_state()
            return (np.asarray(keys), np.asarray([pos, has_gauss, cached], np.float64))

        loader = CachedEpochLoader(stage)
        batches = loader.epoch(bi for _ in range(start, max_iter) for bi in range(nb))
        try:
            for epoch in range(start, max_iter):
                with tracing.span("iteration.epoch", epoch=epoch, mode="stream"):
                    supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
                    # the eager loop's launch a stream epoch (ROADMAP C.44)
                    with dispatch.timed_dispatch("lloyd_stream_epoch", start=epoch,
                                                 end=epoch + 1):
                        sums = centroids.new_zeros(centroids.shape)
                        counts = centroids.new_zeros((k,))
                        for _ in range(nb):
                            X = next(batches)
                            if mesh is not None:
                                X, w = X
                            one_hot = (measure.find_closest(X, centroids)[:, None]
                                       == labels).to(X.dtype)
                            if mesh is not None:
                                one_hot = one_hot * w[:, None]
                            sums = sums + one_hot.T @ X
                            counts = counts + torch.sum(one_hot, dim=0)
                        if mesh is not None:
                            summed = collectives.all_reduce_sum(
                                torch.cat([sums.reshape(-1), counts]), mesh=mesh)
                            sums, counts = summed[:sums.numel()].reshape(sums.shape), \
                                summed[sums.numel():]
                        centroids = torch.where(
                            counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1e-30),
                            centroids
                        )
                    if ckpt_dir is not None and (epoch + 1) % interval == 0:
                        _snapshot.save_job_snapshot(
                            ckpt_dir, job_key, {"model": (centroids, counts), "rng": rng_section()},
                            epoch=epoch + 1, specs={"rng": "host"}, meta={"numBatches": nb},
                            mesh=mesh)
                    faults.tick("epoch")
        finally:
            batches.close()
        model = KMeansModel()
        model.centroids, model.weights = _linear.packed_to_host(centroids, counts)
        model.cache_stats = {**replay.stats, "deviceCache": loader.cache.stats}
        update_existing_params(model, self)
        return model
