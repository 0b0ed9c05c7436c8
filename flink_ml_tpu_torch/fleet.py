"""FitFleet: N estimator fits trained as one program over one shared input.

Port of flink_ml_tpu/fleet.py. A fleet trains N same-class estimators on
one table: hyperparameter sweeps, cross-validation folds, per-tenant
models. The JAX package vmaps its whole-fit SGD, stream SGD and Lloyd
loops over a leading member axis; the port writes that axis out
(`ops.optimizer._sgd_fleet_*`, `models.clustering.kmeans._lloyd_fleet_train`):

- the members' hyperparameters are one float32 [N, 5] tensor
  (maxIter, tol, learningRate, reg, elasticNet; seed and maxIter for
  KMeans), so every member carries its own;
- the loop runs the largest maxIter and a member that has stopped (its
  own maxIter, or criteria <= its tol) keeps its state, so each member
  stops at the epoch its solo fit stops at;
- the input is staged once and shared: its bytes are read once an epoch
  for all N models (a sparse batch through the member-batched kernels
  `fleet_row_dots` and `fleet_grad`, which read each slot once);
- the result comes back as ONE packed [N, flag? + d + 2] (KMeans
  [N, k * d + k]) readback.

Each member computes its solo fit's arithmetic. Where a contraction over
the shared input is one stacked operation for all members (the dense
reduce forms, KMeans' matmuls), the order of its additions is the
library's; the tests and PERF.md say where members equal their solo fits
bit for bit.

Regimes on the default mesh (`parallel.mesh.default_mesh()`; JAX
`:21-31`, `:239-316`), taken as one `data` axis over all its ranks
(`mesh.flatten`: a mesh with a model axis shards a fleet as it shards a
replicated solo fit, ROADMAP C.36):

- default (replicated members): every rank holds every member and only
  its rows of the data (`SGD._batchify`, `devicecache.data_axis_rows`), and
  each member's (gradient, loss, weight) sums reduce over `data` by the
  member's own all-reduce, the reduce of its solo sharded fit
  (`optimizer._fleet_sharded_masked_epoch`; KMeans `_lloyd_fleet_sharded`),
  so a member equals its solo fit on the same mesh bit for bit where the
  local sums do (on the CPU; on the card within the sparse gate, C.21);
- fleet-sharded: when the members' state outgrows
  `config.fleet_shard_state_bytes` (`config.fleet_shard_threshold`) and
  the data shards divide the fleet (`mesh.fleet_axis_shardable`), or with
  `shard_fleet_axis=True`, each rank owns N / R whole members
  (`mesh.fleet_sharding`) over replicated data and trains them as the
  one-rank fleet does, on the member-batched kernels, then the packed
  [N, pack] result is gathered over `data` with ONE `all_gather` at fit
  end: a member equals its solo fit on ONE data shard bit for bit. No
  reduce over `data` ever adds across members.

`fleet.sharded` and `fleet.size` give the regime of the last fit. An
overlap-tuned process (`config.collective_overlap`) counts the fleet's
downgrade as `dispatch.whole_fit_fallback.fleet_overlap`: a fleet never
rides the carry-delayed loops. `promote_fleet_winner` publishes the best
member into a `lifecycle.ModelLifecycle`.

Checkpoints (the JAX package's `_run_fleet_sgd`, `:326-430`): under
`config.iteration_checkpoint_dir` the in-memory linear fleet runs its
epochs in chunks that end at the checkpoint boundaries
(`optimizer._sgd_fleet_chunk`), reads every member's (epoch, criteria)
back once a chunk, snapshots the fleet carry as one `fleet` section
(coeff and grad as [N, d] host arrays, whatever their device layout)
under `_job_key()`, ticks the `chunk` fault site, and resumes from the
newest snapshot; the chunking changes no arithmetic.

The in-memory linear fleet (`optimizer._sgd_fleet_whole_fit`, fed only
the batches its epochs read) and the KMeans fleet
(`kmeans._lloyd_fleet_train`) run through the program funnel
(utils/lazyjit.py): one captured CUDA graph per signature on the card,
replayed by a later fleet of the same shapes and maxIters at any other
hyperparameters. Accounting, with the JAX package's names: the
`fleet.size` and `fleet.sharded` gauges, `fleet.fits`,
`fleet.modelsTrained`, `fleet.examplesTrained`, the
fleet's memory peak on `hbm.peak.fit` and every member's
`hbm.peak.fit.member.<i>`, and an `iteration.run` span a fit (mode
"fleet", "fleet_chunked" with `iteration.chunk` spans, or
"fleet_stream"). On a mesh of ranks the in-memory fleets run their
epochs eagerly in the default regime (`dispatch.whole_fit_fallback.mesh`,
C.28), and a checkpointed fleet writes rank cuts: the replicated carry
from rank 0, or each rank its members' block (`data`-tagged).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config

__all__ = ["FitFleet", "fleet_model_arrays"]

#: estimator class name -> (loss name, validate_binomial)
_LINEAR_KINDS = {
    "LogisticRegression": ("binary_logistic", True),
    "LinearSVC": ("hinge", False),
    "LinearRegression": ("least_square", False),
}


def _linear_model_for(est):
    """The estimator's fitted-model class, its params copied (each
    estimator's own `fit` tail)."""
    from .utils.param_utils import update_existing_params

    kind = type(est).__name__
    if kind == "LogisticRegression":
        from .models.classification.logisticregression import LogisticRegressionModel as cls
    elif kind == "LinearSVC":
        from .models.classification.linearsvc import LinearSVCModel as cls
    else:
        from .models.regression.linearregression import LinearRegressionModel as cls
    model = cls()
    update_existing_params(model, est)
    return model


def _member_hyper(est) -> List[float]:
    """One member's hyper row [maxIter, tol, lr, reg, elasticNet]."""
    return [
        float(est.get_max_iter()),
        float(est.get_tol()),
        float(est.get_learning_rate()),
        float(est.get_reg()),
        float(est.get_elastic_net()),
    ]


def _require_same(estimators, getter: str, what: str):
    values = [getattr(e, getter)() for e in estimators]
    if any(v != values[0] for v in values[1:]):
        raise ValueError(
            f"FitFleet members must share {what} (the fleet trains on ONE "
            f"staged dataset / batch schedule); got {sorted(set(map(str, values)))}"
        )
    return values[0]


def _stream_segments(chunks, b: int, d: int, device, slots=None):
    """A stream's equal (X, y, w) chunks as packed [X | y | w] segments
    (`optimizer.StreamLayout`), stacked on `device` once. With `slots`
    (this rank's rows of each batch) a segment holds those rows, padding
    rows at weight 0. Returns (layout, segments)."""
    from .ops import optimizer

    layout = optimizer.StreamLayout(b if slots is None else slots.size, d)
    segments = torch.empty((len(chunks), layout.size), dtype=optimizer.COMPUTE_DTYPE,
                           device=device)
    flat = np.zeros(layout.size, np.float32)
    Xv, yv, wv = layout.views(flat)
    for i, (X, y, w) in enumerate(chunks):
        w = np.ones(b, np.float32) if w is None else w
        if slots is not None:
            keep = slots[slots < b]
            flat[:] = 0.0
            Xv[:keep.size], yv[:keep.size], wv[:keep.size] = X[keep], y[keep], w[keep]
        else:
            Xv[:], yv[:], wv[:] = X, y, w
        segments[i].copy_(torch.from_numpy(flat))
    return layout, segments


class FitFleet:
    """Train N same-class estimators as one fleet: `FitFleet([e1..eN])
    .fit(table)` returns N fitted models, each the model `ei.fit(table)`
    would produce solo, in one program and one packed readback.

    Members must share the structural params that define the staged data
    and batch schedule (featuresCol / labelCol / weightCol /
    globalBatchSize; `k` and distanceMeasure for KMeans). Per-member
    hyperparameters (maxIter, tol, learningRate, reg, elasticNet;
    seed and maxIter for KMeans) may all differ.

    `shard_fleet_axis` forces (True) or forbids (False) the fleet-sharded
    regime; None decides from `config.fleet_shard_state_bytes` and
    `mesh.fleet_axis_shardable`. True on a mesh that cannot shard the
    fleet raises."""

    def __init__(self, estimators: Sequence, *, shard_fleet_axis: Optional[bool] = None):
        estimators = list(estimators)
        if not estimators:
            raise ValueError("FitFleet needs at least one estimator")
        kind = type(estimators[0]).__name__
        if any(type(e).__name__ != kind for e in estimators):
            raise ValueError(
                "FitFleet members must be the same estimator class; got "
                f"{sorted({type(e).__name__ for e in estimators})}"
            )
        if kind not in _LINEAR_KINDS and kind != "KMeans":
            raise ValueError(
                f"FitFleet does not support {kind}; supported: "
                f"{sorted(_LINEAR_KINDS) + ['KMeans']}"
            )
        self.estimators = estimators
        self.kind = kind
        self.shard_fleet_axis = shard_fleet_axis

    def _decide_sharded(self, mesh, state_bytes: int) -> bool:
        """The regime (JAX `:159-177`), with its `fleet.sharded` gauge."""
        from .parallel import mesh as mesh_lib
        from .utils import metrics

        n = len(self.estimators)
        if self.shard_fleet_axis is not None:
            if self.shard_fleet_axis and not mesh_lib.fleet_axis_shardable(mesh, n):
                raise ValueError(
                    f"shard_fleet_axis=True but a fleet of {n} cannot shard "
                    f"over {mesh_lib.num_data_shards(mesh)} data shard(s) "
                    "(needs >1 shards dividing the fleet evenly)"
                )
            sharded = bool(self.shard_fleet_axis)
        else:
            sharded = (
                config.fleet_shard_state_bytes is not None
                and state_bytes > config.fleet_shard_state_bytes
                and mesh_lib.fleet_axis_shardable(mesh, n)
            )
        metrics.set_gauge("fleet.sharded", 1.0 if sharded else 0.0)
        return sharded

    def _own(self, mesh, sharded: bool) -> Tuple[int, int]:
        """[lo, hi) of the members this rank trains: all of them, or its
        `fleet_sharding` block in the fleet-sharded regime."""
        from .parallel import mesh as mesh_lib

        n = len(self.estimators)
        if not sharded:
            return 0, n
        return mesh_lib.fleet_sharding(mesh, 1).bounds((n,))[0]

    def _stage_fleet_state(self, mesh, members: int, d: int, sharded: bool, device,
                           member_minor: bool = False):
        """The member carry (coeff, grad, wsum, epochs, criteria) of the
        members this rank trains. On a mesh of ranks it is staged from the
        host through the admitted funnel under the `fleet` ledger category,
        `fleet_sharding`'s block of the [N, ...] carry in the fleet-sharded
        regime (JAX `_stage_fleet_state`); on one rank it is made on the
        device (`optimizer.fleet_init_state`)."""
        from .ops import optimizer
        from .parallel import mesh as mesh_lib
        from .parallel.prefetch import stage_to_device

        if mesh.size <= 1:
            return optimizer.fleet_init_state(members, d, device, member_minor=member_minor)
        n = len(self.estimators)
        spec = mesh_lib.fleet_sharding(mesh, 2) if sharded else \
            mesh_lib.replicated_sharding(mesh)
        spec1 = mesh_lib.fleet_sharding(mesh, 1) if sharded else spec
        coeff, grad, wsum, epochs, crit = stage_to_device(
            (np.zeros((n, d), np.float32), np.zeros((n, d), np.float32),
             np.zeros(n, np.float32), np.zeros(n, np.int32), np.full(n, np.inf, np.float32)),
            device, category="fleet", sharding=[spec, spec, spec1, spec1, spec1]).wait()
        if member_minor:  # the kernels' layout: the transpose of a contiguous (d, N)
            coeff, grad = coeff.T.contiguous().T, grad.T.contiguous().T
        return coeff, grad, wsum, epochs, crit

    def fit(self, table) -> List:
        """Train every member on `table` (a Table, or a StreamTable for the
        linear estimators); returns the N fitted models in the estimators'
        order."""
        from .obs import memledger
        from .parallel import dispatch, overlap
        from .utils import metrics

        n = len(self.estimators)
        metrics.set_gauge("fleet.size", n)
        if config.collective_overlap and not overlap.fleet_overlap_supported():
            dispatch.account_whole_fit_fallback("fleet_overlap")
        tok = memledger.mark_peak()
        try:
            if self.kind == "KMeans":
                models = self._fit_kmeans(table)
            else:
                models = self._fit_linear(table)[0]
        finally:
            memledger.record_fleet_fit_peak(memledger.peak_since(tok), n)
        metrics.inc_counter("fleet.fits")
        metrics.inc_counter("fleet.modelsTrained", n)
        return models

    # -- linear (SGD) -----------------------------------------------------

    def _fit_linear(self, table, loss_func=None):
        """The linear fleet fit -> (models, criteria [N], epochs [N]), the
        last two as host arrays from the same readback. `loss_func`
        replaces the fleet loss (a check holds the kernels' fleet against
        `losses.fleet_loss(name, plain=True)`)."""
        from .models import _linear
        from .ops import losses, optimizer
        from .parallel import mesh as mesh_lib
        from .table import StreamTable
        from .utils import metrics

        ests = self.estimators
        loss_name, validate = _LINEAR_KINDS[self.kind]
        features_col = _require_same(ests, "get_features_col", "featuresCol")
        label_col = _require_same(ests, "get_label_col", "labelCol")
        weight_col = _require_same(ests, "get_weight_col", "weightCol")
        gbs = int(_require_same(ests, "get_global_batch_size", "globalBatchSize"))
        if validate:
            for est in ests:
                if est.get_multi_class() == "multinomial":
                    raise ValueError(
                        "Multinomial classification is not supported yet. "
                        "Supported options: [auto, binomial]."
                    )
        rows = [_member_hyper(e) for e in ests]
        loss_func = losses.fleet_loss(loss_name) if loss_func is None else loss_func
        mesh = mesh_lib.flatten(mesh_lib.default_mesh())

        if isinstance(table, StreamTable):
            return self._fit_linear_stream(mesh, table, loss_func, rows, features_col,
                                           label_col, weight_col, validate)

        X, y, w = _linear.extract_train_data(table, features_col, label_col, weight_col,
                                             keep_sparse=True)
        validate_on_device = False
        if validate:
            if isinstance(y, torch.Tensor):
                validate_on_device = True  # one flag in the packed readback
            else:
                _linear.validate_binomial_labels(y)
        sparse = isinstance(X, tuple)
        if sparse:  # padded CSR, never densified
            indices, values, d = X
            X = (indices, values)
        else:
            d = int(X.shape[1])
        # coeff + grad are the dim-proportional member state
        sharded = self._decide_sharded(mesh, state_bytes=2 * len(ests) * d * 4)
        if mesh.size > 1 and not sharded:
            host = self._fit_linear_replicated(mesh, X, y, w, loss_func, rows, gbs, d, sparse,
                                               validate_on_device)
        else:
            lo, hi = self._own(mesh, sharded)
            host = self._fit_linear_members(mesh, X, y, w, loss_func, rows[lo:hi], gbs, d,
                                            sparse, validate_on_device, sharded,
                                            int(max(r[0] for r in rows)))
        flags, coeffs, criteria, epochs = optimizer.unpack_fleet_train_result(
            host, d, validate_on_device)
        metrics.inc_counter("fleet.examplesTrained", int(np.sum(epochs)) * gbs)
        if flags is not None:
            _linear._raise_if_invalid(float(np.min(flags)))
        return self._linear_models(coeffs), criteria, epochs

    def _fit_linear_members(self, mesh, X, y, w, loss_func, rows, gbs: int, d: int,
                            sparse: bool, validate_on_device: bool, sharded: bool,
                            gmax_all: int):
        """The members `rows` over the whole data, as the one-rank fleet
        trains them (one program of the funnel, or the checkpointed
        chunks, which run to the fleet's largest maxIter `gmax_all` so
        every rank writes the same cuts); in the fleet-sharded regime the
        packed results of every rank are gathered over `data`. Returns the
        host [N, pack]."""
        from .models import _linear
        from .obs import tracing
        from .ops import optimizer
        from .parallel import collectives
        from .utils import lazyjit

        gmax = int(max(r[0] for r in rows))
        checkpointed = config.iteration_checkpoint_dir is not None
        X_f, y_f, w_f, n = optimizer.stage_flat(
            X, y, w, gbs,
            rows=None if checkpointed else lambda nb: optimizer._touched_rows(nb, gbs, gmax))
        if checkpointed:  # the chunk loop runs eagerly
            X_f, y_f, w_f = lazyjit.materialize((X_f, y_f, w_f))
        device = y_f.device
        state = self._stage_fleet_state(mesh, len(rows), d, sharded, device, member_minor=sparse)
        hyper = optimizer.fleet_hyper(rows, device)
        if checkpointed:
            state = self._run_checkpointed(
                mesh if sharded else None, state, rows, gmax_all, int(y_f.shape[0]) // gbs,
                gbs, d, sparse, sharded, lambda st, a, b: optimizer._sgd_fleet_chunk(
                    X_f, y_f, w_f, st, loss_func, hyper, gbs, n, a, b))
            packed = optimizer._sgd_fleet_final(state, hyper)
            if validate_on_device:
                flag = optimizer._binomial_labels_ok(y_f).reshape(1, 1)
                packed = torch.cat([flag.expand(packed.shape[0], 1), packed], dim=1)
        else:
            if config.whole_fit != "off":
                optimizer.account_whole_fit("fleet")
            with tracing.span("iteration.run", mode="fleet", epochs=gmax, fleet=len(rows)):
                packed = optimizer._sgd_fleet_whole_fit(
                    X_f, y_f, w_f, state, loss_func, hyper, gmax, gbs, n, validate_on_device)
        if sharded:
            packed = collectives.all_gather(packed, mesh=mesh)
        (host,) = _linear.packed_to_host(packed)
        return host

    def _fit_linear_replicated(self, mesh, X, y, w, loss_func, rows, gbs: int, d: int,
                               sparse: bool, validate_on_device: bool):
        """The default regime on a mesh of ranks: every member on this
        rank's rows, each member's sums reduced over `data` on its own
        (`optimizer._sgd_fleet_sharded_chunk`). Returns the host [N, pack]."""
        from .models import _linear
        from .obs import memledger, tracing
        from .ops import optimizer
        from .parallel import collectives, dispatch

        gmax = int(max(r[0] for r in rows))
        template = optimizer.SGD(global_batch_size=gbs, max_iter=gmax)
        X_b, y_b, w_b, y_all = template._batchify(mesh, X, y, w)
        memledger.track((X_b, y_b, w_b, y_all), "streamSegments")
        device = y_b.device
        state = self._stage_fleet_state(mesh, len(rows), d, False, device, member_minor=sparse)
        hyper = optimizer.fleet_hyper(rows, device)
        dispatch.whole_fit_plan(start_epoch=0, max_iter=gmax, ranks=mesh.size)

        def chunk(st, a, b):
            return optimizer._sgd_fleet_sharded_chunk(mesh, X_b, y_b, w_b, st, loss_func, hyper,
                                                      a, b)
        if config.iteration_checkpoint_dir is not None:
            state = self._run_checkpointed(mesh, state, rows, gmax, int(y_all.shape[0]), gbs, d,
                                           sparse, False, chunk)
        else:
            with tracing.span("iteration.run", mode="fleet_sharded", epochs=gmax,
                              fleet=len(rows), ranks=mesh.size):
                state = chunk(state, 0, gmax)
        packed = optimizer._sgd_fleet_final(state, hyper)
        if validate_on_device:
            flag = collectives.all_reduce_min(optimizer._binomial_labels_ok(y_all), mesh=mesh)
            packed = torch.cat([flag.reshape(1, 1).expand(packed.shape[0], 1), packed], dim=1)
        (host,) = _linear.packed_to_host(packed)
        return host

    def _run_checkpointed(self, mesh, state, rows, gmax, num_batches, gbs, d, member_minor,
                          sharded, chunk):
        """The fleet's epochs (`chunk(state, start, end)`) in chunks that
        end at the checkpoint boundaries, a snapshot of the fleet carry at
        each boundary, a resume from the newest one. On a mesh of ranks the
        cut is a rank cut: the replicated carry, or in the fleet-sharded
        regime each rank's member block (`data`). Returns the final state."""
        from .ckpt import faults
        from .ckpt import snapshot as _snapshot
        from .obs import tracing
        from .parallel import collectives, supervisor
        from .parallel.prefetch import to_device
        from .utils.packing import packed_device_get

        ckpt_dir, key = config.iteration_checkpoint_dir, self._job_key()
        interval = max(1, int(config.iteration_checkpoint_interval))
        N = len(self.estimators)
        meta = {"numBatches": int(num_batches), "globalBatchSize": gbs, "fleetSize": N, "dim": d}
        specs = {"fleet": ("data" if sharded else "replicated",) * 5}
        template = (np.zeros((N, d), np.float32), np.zeros((N, d), np.float32),
                    np.zeros(N, np.float32), np.zeros(N, np.int32), np.zeros(N, np.float32))
        planned = 0
        snap = _snapshot.load_job_snapshot(ckpt_dir, key, templates={"fleet": template},
                                           expect_meta=meta)
        device = state[0].device
        if snap is not None:
            coeff, grad, wsum, epochs, crit = _snapshot.stage_section(
                snap, "fleet", device=device, specs=specs["fleet"], category="fleet",
                mesh=mesh)
            if member_minor:  # the kernels' layout: the transpose of a contiguous (d, N)
                coeff, grad = coeff.T.contiguous().T, grad.T.contiguous().T
            state, planned = (coeff, grad, wsum, epochs, crit), snap.epoch
        max_iters = np.asarray([r[0] for r in rows])
        tols = np.asarray([r[1] for r in rows], np.float32)  # the device mask's tol
        shapes = {"fleet": [(N, d), (N, d), (N,), (N,), (N,)]}
        stopped = False
        with tracing.span("iteration.run", mode="fleet_chunked", chunk=interval, fleet=N):
            while planned < gmax and not stopped:
                end = min((planned // interval + 1) * interval, gmax)
                with tracing.span("iteration.chunk", epoch=planned, end=end):
                    supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
                    state = chunk(state, planned, end)
                supervisor.pulse_boundary(supervisor.PHASE_COLLECTIVE)
                e_m, c_m = packed_device_get(state[3], state[4], sync_kind="drain")
                if end % interval == 0:
                    _snapshot.save_job_snapshot(ckpt_dir, key, {"fleet": state}, epoch=end,
                                                criteria=float(np.max(c_m)), specs=specs,
                                                meta=meta, mesh=mesh, shapes=shapes)
                faults.tick("chunk")
                planned = end
                stopped = bool(np.all((e_m >= max_iters) | (c_m <= tols)))
                if sharded:  # every rank decides on every member: the cuts stay in step
                    stopped = bool(packed_device_get(collectives.all_reduce_min(
                        to_device(np.float32(stopped), device), mesh=mesh),
                        sync_kind="drain")[0])
        return state

    def _job_key(self) -> str:
        """The fleet's job identity: "fleet-" and a hash of every member's
        checkpoint job key (the JAX package's key)."""
        import hashlib

        from .parallel.iteration import checkpoint_job_key

        member_keys = "|".join(checkpoint_job_key(e) for e in self.estimators)
        return f"fleet-{hashlib.sha1(member_keys.encode()).hexdigest()[:10]}"

    def _linear_models(self, coeffs) -> List:
        models = []
        for i, est in enumerate(self.estimators):
            model = _linear_model_for(est)
            model.coefficient = np.asarray(coeffs[i], np.float64)
            models.append(model)
        return models

    def _fit_linear_stream(self, mesh, table, loss_func, rows, features_col, label_col,
                           weight_col, validate):
        """Out-of-core fleet fit: the stream's chunks, which must share one
        shape, are each a batch; they are packed as [X | y | w] segments
        (`optimizer.StreamLayout`) and stacked on the device once, shared
        by every member, and the whole fleet trains in
        `_sgd_fleet_stream_whole_fit`. On a mesh of ranks the default
        regime stacks this rank's rows of each batch (padded to a multiple
        of the shards at weight 0) and reduces each member over `data`;
        the fleet-sharded regime trains this rank's members on every row
        and gathers the results over `data`."""
        from .models import _linear
        from .obs import tracing
        from .ops import optimizer
        from .parallel import collectives
        from .parallel import mesh as mesh_lib
        from .utils import metrics

        chunks = list(
            _linear._stream_chunks(table, features_col, label_col, weight_col, validate)
        )
        if not chunks:
            raise ValueError("FitFleet stream fit: the stream yielded no batches")
        shapes = {np.shape(X) for X, _, _ in chunks}
        if len(shapes) != 1:
            raise ValueError(
                "FitFleet stream training needs uniform batch shapes "
                f"(got {sorted(shapes)}); ragged tails fall back to solo "
                "fits (dispatch.whole_fit_fallback.ragged_batches)"
            )
        (b, d) = next(iter(shapes))
        device = mesh.device if mesh.size > 1 else config.device()
        sharded = self._decide_sharded(mesh, state_bytes=2 * len(self.estimators) * d * 4)
        # each regime reads only its own members: every member in the default
        # regime on ranks, this rank's block (every member on one rank) else
        if mesh.size > 1 and not sharded:  # this rank's rows of each batch
            start, stop = mesh_lib.shard_bounds(int(b), mesh)
            layout, segments = _stream_segments(chunks, int(b), int(d), device,
                                                np.arange(start, stop))
            del chunks
            state = self._stage_fleet_state(mesh, len(rows), d, False, device)
            hyper = optimizer.fleet_hyper(rows, device)
            gmax = int(max(r[0] for r in rows))
            with tracing.span("iteration.run", mode="fleet_stream", epochs=gmax,
                              fleet=len(self.estimators)):
                X_b, y_b, w_b = layout.views(segments)
                state = optimizer._sgd_fleet_sharded_chunk(mesh, X_b, y_b, w_b, state,
                                                           loss_func, hyper, 0, gmax)
                (host,) = _linear.packed_to_host(optimizer._sgd_fleet_final(state, hyper))
        else:
            lo, hi = self._own(mesh, sharded)
            rows = rows[lo:hi]
            layout, segments = _stream_segments(chunks, int(b), int(d), device)
            del chunks
            state = self._stage_fleet_state(mesh, len(rows), d, sharded, device)
            hyper = optimizer.fleet_hyper(rows, device)
            gmax = int(max(r[0] for r in rows))
            with tracing.span("iteration.run", mode="fleet_stream", epochs=gmax,
                              fleet=len(self.estimators)):
                packed = optimizer._sgd_fleet_stream_whole_fit(
                    segments, layout, state, loss_func, hyper, gmax)
                if sharded:
                    packed = collectives.all_gather(packed, mesh=mesh)
                (host,) = _linear.packed_to_host(packed)
        _, coeffs, criteria, epochs = optimizer.unpack_fleet_train_result(host, d)
        metrics.inc_counter("fleet.examplesTrained", int(np.sum(epochs)) * int(b))
        return self._linear_models(coeffs), criteria, epochs

    # -- KMeans (Lloyd) -----------------------------------------------------

    def _fit_kmeans(self, table) -> List:
        """N Lloyd fits over one staged point set: each member starts from
        its own seed's init rows and runs its own maxIter. Readback is ONE
        [N, k * d + k] pack. On a mesh of ranks the default regime fits
        every member on this rank's rows, each member's cell partials
        reduced over `data` on its own (`kmeans._lloyd_fleet_sharded`); the
        fleet-sharded regime fits this rank's members on every row and
        gathers the packs over `data`."""
        from .models import _linear
        from .models.clustering import kmeans as km
        from .obs import tracing
        from .ops import optimizer
        from .parallel import collectives, dispatch
        from .parallel import mesh as mesh_lib
        from .parallel.prefetch import to_device
        from .table import StreamTable, as_dense_matrix
        from .utils import metrics
        from .utils.param_utils import update_existing_params

        if isinstance(table, StreamTable):
            raise ValueError(
                "FitFleet does not support out-of-core KMeans yet; fit "
                "StreamTable KMeans members solo"
            )
        ests = self.estimators
        features_col = _require_same(ests, "get_features_col", "featuresCol")
        k = int(_require_same(ests, "get_k", "k"))
        measure = _require_same(ests, "get_distance_measure", "distanceMeasure")
        X = as_dense_matrix(table.column(features_col), allow_device=True)
        n, d = X.shape
        if n < k:
            raise ValueError(f"Number of points ({n}) is less than k ({k})")
        mesh = mesh_lib.flatten(mesh_lib.default_mesh())
        sharded = self._decide_sharded(mesh, state_bytes=2 * len(ests) * k * d * 4)
        if mesh.size > 1 and not sharded:  # every member on this rank's rows
            max_iters = [int(e.get_max_iter()) for e in ests]
            init_idx = np.stack([km.init_rows(n, k, e.get_seed()) for e in ests])
            device = X.device if isinstance(X, torch.Tensor) else mesh.device
            X_local, _ = mesh_lib.shard_batch(mesh, X if isinstance(X, torch.Tensor)
                                              else np.asarray(X, np.float32))
            X_local = X_local.to(torch.float32)
            start, stop = mesh_lib.shard_bounds(n, mesh)
            weights = to_device(np.arange(start, stop) < n, device, torch.float32)
            inits = (X.index_select(0, to_device(init_idx.reshape(-1), device))
                     if isinstance(X, torch.Tensor) else
                     to_device(np.asarray(X, np.float32)[init_idx.reshape(-1)], device))
            inits = inits.to(torch.float32).reshape(len(ests), k, d)
            dispatch.whole_fit_plan(start_epoch=0, max_iter=max(max_iters), ranks=mesh.size)
            with tracing.span("iteration.run", mode="fleet_sharded", epochs=max(max_iters),
                              fleet=len(ests), ranks=mesh.size):
                packed = km._lloyd_fleet_sharded(mesh, X_local, weights, inits, max_iters,
                                                 measure)
        else:  # this rank's members (every member on one rank) on every row
            lo, hi = self._own(mesh, sharded)
            mine = ests[lo:hi]
            max_iters = [int(e.get_max_iter()) for e in mine]
            X, rows_of = km.staged_points(X)
            inits = torch.stack([rows_of(km.init_rows(n, k, e.get_seed())) for e in mine])
            if config.whole_fit != "off":
                optimizer.account_whole_fit("fleet")
            with tracing.span("iteration.run", mode="fleet", epochs=max(max_iters),
                              fleet=len(ests)):
                packed = km._lloyd_fleet_train(X, inits, max_iters, measure)
            if sharded:
                packed = collectives.all_gather(packed, mesh=mesh)
        (host,) = _linear.packed_to_host(packed)
        metrics.inc_counter("fleet.examplesTrained",
                            sum(int(e.get_max_iter()) for e in ests) * int(n))
        models = []
        for i, est in enumerate(ests):
            model = km.KMeansModel()
            model.centroids = host[i, : k * d].reshape(k, d)
            model.weights = host[i, k * d :]
            update_existing_params(model, est)
            models.append(model)
        return models


def fleet_model_arrays(model) -> Tuple:
    """The array tuple a fleet-trained model publishes: (centroids,
    weights) of a KMeansModel, (coefficient,) of a linear model, float32."""
    if hasattr(model, "centroids"):
        return (
            np.asarray(model.centroids, np.float32),
            np.asarray(model.weights, np.float32),
        )
    return (np.asarray(model.coefficient, np.float32),)


def promote_fleet_winner(lifecycle, models: Sequence, scores: Sequence[float], mode: str = "max"):
    """Promote the fleet's winner by a held-out metric into a
    `ModelLifecycle` version ring: the argmax (`mode="max"`) or argmin
    (`mode="min"`) of `scores`, published through `lifecycle.promote`
    (its gate, retention and rollback apply). Returns (winner_index,
    ModelVersion)."""
    from .utils import metrics

    if len(models) != len(scores):
        raise ValueError(
            f"{len(models)} models but {len(scores)} scores — every fleet "
            "member needs its held-out metric"
        )
    if mode not in ("max", "min"):
        raise ValueError(f"Unknown winner mode {mode!r} (use 'max' or 'min')")
    scores = np.asarray(list(scores), np.float64)
    if np.any(np.isnan(scores)):
        raise ValueError("fleet winner selection got NaN scores")
    winner = int(np.argmax(scores) if mode == "max" else np.argmin(scores))
    version = lifecycle.promote(fleet_model_arrays(models[winner]))
    metrics.inc_counter("fleet.winnerPromoted")
    metrics.set_gauge("fleet.winnerIndex", float(winner))
    metrics.set_gauge("fleet.winnerScore", float(scores[winner]))
    return winner, version
