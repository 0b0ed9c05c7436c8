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

Regime: the JAX package shards the member axis over the mesh's data
shards when the members' state outgrows `config.fleet_shard_state_bytes`.
The port trains on one device, one data shard, so its fleet is always
replicated, and `shard_fleet_axis=True` raises the JAX package's
ValueError. `promote_fleet_winner` publishes the best member into a
`lifecycle.ModelLifecycle`.

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
`fleet.size` and `fleet.sharded` gauges (always 0: one card is one data
shard), `fleet.fits`, `fleet.modelsTrained`, `fleet.examplesTrained`, the
fleet's memory peak on `hbm.peak.fit` and every member's
`hbm.peak.fit.member.<i>`, and an `iteration.run` span a fit (mode
"fleet", "fleet_chunked" with `iteration.chunk` spans, or
"fleet_stream"). Not yet: the fleet-sharded regime (ROADMAP A.10b).
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


def _data_shards() -> int:
    """A fleet trains replicated on one rank: one data shard (the
    fleet-sharded regime over more is ROADMAP A.10b)."""
    return 1


def _fleet_axis_shardable(fleet_size: int) -> bool:
    """Whether a fleet can shard its member axis over the data shards:
    more than one, dividing the fleet evenly (the JAX package's
    `mesh.fleet_axis_shardable`)."""
    shards = _data_shards()
    return shards > 1 and fleet_size % shards == 0


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
    regime; None decides from `config.fleet_shard_state_bytes`. One device
    cannot shard the member axis, so True raises."""

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

    def _decide_sharded(self, state_bytes: int) -> bool:
        n = len(self.estimators)
        if self.shard_fleet_axis is not None:
            if self.shard_fleet_axis and not _fleet_axis_shardable(n):
                raise ValueError(
                    f"shard_fleet_axis=True but a fleet of {n} cannot shard "
                    f"over {_data_shards()} data shard(s) "
                    "(needs >1 shards dividing the fleet evenly)"
                )
            return bool(self.shard_fleet_axis)
        return (
            config.fleet_shard_state_bytes is not None
            and state_bytes > config.fleet_shard_state_bytes
            and _fleet_axis_shardable(n)
        )

    def fit(self, table) -> List:
        """Train every member on `table` (a Table, or a StreamTable for the
        linear estimators); returns the N fitted models in the estimators'
        order."""
        from .obs import memledger
        from .utils import metrics

        n = len(self.estimators)
        metrics.set_gauge("fleet.size", n)
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
        from .obs import tracing
        from .ops import losses, optimizer
        from .table import StreamTable
        from .utils import lazyjit, metrics

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
        gmax = int(max(r[0] for r in rows))
        loss_func = losses.fleet_loss(loss_name) if loss_func is None else loss_func

        if isinstance(table, StreamTable):
            return self._fit_linear_stream(table, loss_func, rows, gmax, features_col,
                                           label_col, weight_col, validate)

        X, y, w = _linear.extract_train_data(table, features_col, label_col, weight_col)
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
        # coeff + grad are the dim-proportional member state; one data shard
        # never shards the member axis (shard_fleet_axis=True raises here)
        sharded = self._decide_sharded(state_bytes=2 * len(ests) * d * 4)
        metrics.set_gauge("fleet.sharded", 1.0 if sharded else 0.0)
        checkpointed = config.iteration_checkpoint_dir is not None
        X_f, y_f, w_f, n = optimizer.stage_flat(
            X, y, w, gbs,
            rows=None if checkpointed else lambda nb: optimizer._touched_rows(nb, gbs, gmax))
        if checkpointed:  # the chunk loop runs eagerly
            X_f, y_f, w_f = lazyjit.materialize((X_f, y_f, w_f))
        device = y_f.device
        state = optimizer.fleet_init_state(len(ests), d, device, member_minor=sparse)
        hyper = optimizer.fleet_hyper(rows, device)
        if checkpointed:
            state = self._run_checkpointed(X_f, y_f, w_f, n, state, loss_func, hyper, rows,
                                           gmax, gbs, d, sparse)
            packed = optimizer._sgd_fleet_final(state, hyper)
            if validate_on_device:
                flag = optimizer._binomial_labels_ok(y_f).reshape(1, 1)
                packed = torch.cat([flag.expand(packed.shape[0], 1), packed], dim=1)
            (host,) = _linear.packed_to_host(packed)
        else:
            if config.whole_fit != "off":
                optimizer.account_whole_fit("fleet")
            with tracing.span("iteration.run", mode="fleet", epochs=gmax, fleet=len(ests)):
                packed = optimizer._sgd_fleet_whole_fit(
                    X_f, y_f, w_f, state, loss_func, hyper, gmax, gbs, n, validate_on_device)
                (host,) = _linear.packed_to_host(packed)
        flags, coeffs, criteria, epochs = optimizer.unpack_fleet_train_result(
            host, d, validate_on_device)
        metrics.inc_counter("fleet.examplesTrained", int(np.sum(epochs)) * gbs)
        if flags is not None:
            _linear._raise_if_invalid(float(np.min(flags)))
        return self._linear_models(coeffs), criteria, epochs

    def _run_checkpointed(self, X, y, w, n, state, loss_func, hyper, rows, gmax, gbs, d,
                          member_minor):
        """The fleet's epochs in chunks that end at the checkpoint
        boundaries, a snapshot of the fleet carry at each boundary, a
        resume from the newest one. Returns the final fleet state."""
        from .ckpt import faults
        from .ckpt import snapshot as _snapshot
        from .obs import tracing
        from .ops import optimizer
        from .parallel import supervisor
        from .utils.packing import packed_device_get

        ckpt_dir, key = config.iteration_checkpoint_dir, self._job_key()
        interval = max(1, int(config.iteration_checkpoint_interval))
        N = len(self.estimators)
        meta = {"numBatches": int(y.shape[0]) // gbs, "globalBatchSize": gbs,
                "fleetSize": N, "dim": d}
        specs = {"fleet": ("replicated",) * 5}
        template = (np.zeros((N, d), np.float32), np.zeros((N, d), np.float32),
                    np.zeros(N, np.float32), np.zeros(N, np.int32), np.zeros(N, np.float32))
        planned = 0
        snap = _snapshot.load_job_snapshot(ckpt_dir, key, templates={"fleet": template},
                                           expect_meta=meta)
        if snap is not None:
            coeff, grad, wsum, epochs, crit = _snapshot.stage_section(
                snap, "fleet", device=y.device, specs=specs["fleet"], category="fleet")
            if member_minor:  # the kernels' layout: the transpose of a contiguous (d, N)
                coeff, grad = coeff.T.contiguous().T, grad.T.contiguous().T
            state, planned = (coeff, grad, wsum, epochs, crit), snap.epoch
        max_iters = np.asarray([r[0] for r in rows])
        tols = np.asarray([r[1] for r in rows], np.float32)  # the device mask's tol
        stopped = False
        with tracing.span("iteration.run", mode="fleet_chunked", chunk=interval, fleet=N):
            while planned < gmax and not stopped:
                end = min((planned // interval + 1) * interval, gmax)
                with tracing.span("iteration.chunk", epoch=planned, end=end):
                    supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
                    state = optimizer._sgd_fleet_chunk(X, y, w, state, loss_func, hyper, gbs, n,
                                                       planned, end)
                supervisor.pulse_boundary(supervisor.PHASE_COLLECTIVE)
                e_m, c_m = packed_device_get(state[3], state[4], sync_kind="drain")
                if end % interval == 0:
                    _snapshot.save_job_snapshot(ckpt_dir, key, {"fleet": state}, epoch=end,
                                                criteria=float(np.max(c_m)), specs=specs,
                                                meta=meta)
                faults.tick("chunk")
                planned = end
                stopped = bool(np.all((e_m >= max_iters) | (c_m <= tols)))
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

    def _fit_linear_stream(self, table, loss_func, rows, gmax, features_col, label_col,
                           weight_col, validate):
        """Out-of-core fleet fit: the stream's chunks, which must share one
        shape, are each a batch; they are packed as [X | y | w] segments
        (`optimizer.StreamLayout`) and stacked on the device once, shared
        by every member, and the whole fleet trains in
        `_sgd_fleet_stream_whole_fit`."""
        from .models import _linear
        from .obs import tracing
        from .ops import optimizer
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
        device = config.device()
        sharded = self._decide_sharded(state_bytes=2 * len(self.estimators) * d * 4)
        metrics.set_gauge("fleet.sharded", 1.0 if sharded else 0.0)
        layout = optimizer.StreamLayout(int(b), int(d))
        segments = torch.empty((len(chunks), layout.size), dtype=optimizer.COMPUTE_DTYPE,
                               device=device)
        flat = np.zeros(layout.size, np.float32)
        Xv, yv, wv = layout.views(flat)
        for i, (X, y, w) in enumerate(chunks):
            Xv[:], yv[:], wv[:] = X, y, 1.0 if w is None else w
            segments[i].copy_(torch.from_numpy(flat))
        del chunks
        state = optimizer.fleet_init_state(len(self.estimators), d, device)
        with tracing.span("iteration.run", mode="fleet_stream", epochs=gmax,
                          fleet=len(self.estimators)):
            packed = optimizer._sgd_fleet_stream_whole_fit(
                segments, layout, state, loss_func, optimizer.fleet_hyper(rows, device), gmax)
            (host,) = _linear.packed_to_host(packed)
        _, coeffs, criteria, epochs = optimizer.unpack_fleet_train_result(host, d)
        metrics.inc_counter("fleet.examplesTrained", int(np.sum(epochs)) * int(b))
        return self._linear_models(coeffs), criteria, epochs

    # -- KMeans (Lloyd) -----------------------------------------------------

    def _fit_kmeans(self, table) -> List:
        """N Lloyd fits over one staged point set: each member starts from
        its own seed's init rows and runs its own maxIter. Readback is ONE
        [N, k * d + k] pack."""
        from .models import _linear
        from .models.clustering import kmeans as km
        from .obs import tracing
        from .ops import optimizer
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
        X, rows_of = km.staged_points(X)
        inits = torch.stack([rows_of(km.init_rows(n, k, e.get_seed())) for e in ests])
        max_iters = [int(e.get_max_iter()) for e in ests]
        sharded = self._decide_sharded(state_bytes=2 * len(ests) * k * d * 4)
        metrics.set_gauge("fleet.sharded", 1.0 if sharded else 0.0)
        if config.whole_fit != "off":
            optimizer.account_whole_fit("fleet")
        with tracing.span("iteration.run", mode="fleet", epochs=max(max_iters),
                          fleet=len(ests)):
            packed = km._lloyd_fleet_train(X, inits, max_iters, measure)
            (host,) = _linear.packed_to_host(packed)
        metrics.inc_counter("fleet.examplesTrained", int(np.sum(max_iters)) * int(n))
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
