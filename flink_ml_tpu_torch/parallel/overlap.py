"""Comm/compute overlap for the SGD and Lloyd loops on a mesh of ranks.

Port of flink_ml_tpu/parallel/overlap.py. The JAX package builds these as
explicit-SPMD `shard_map` programs; here every rank runs the loop itself
(parallel/mesh.py) with the **carry-delayed apply**: the loop carries the
UNREDUCED local gradient, and its reduction, issued asynchronously as the
epoch ends (`collectives.all_reduce_sum_chunked(async_op=True)`: the
buckets' reduce-scatter in flight), is waited on at the top of the next
epoch, just before the apply that consumes it; the (loss, weight) scalars
reduce every epoch, as the tol check needs them.

Schedule per epoch, against the plain sharded loop (`ops.optimizer`):

    plain:    forward_b -> backward_b -> ALL-REDUCE(grad, loss, w) -> apply
    overlap:  wait(grad_{b-1}) -> apply -> forward_b -> backward_b
              -> all-reduce(loss, w) -> issue(grad_b)

The reduction still happens before the apply that consumes it and the
update order is unchanged, so at two ranks (where every reduce gives the
same bits) overlap equals the plain loop bit for bit; at more ranks the
bucketed reduce associates by other segments than the backend's
monolithic one, and they agree within a stated tolerance (ROADMAP C.26).

Sparse gradients ride the SparCML pair exchange
(`collectives.sparse_all_reduce_sum`) when `sgd_use_sparse_pairs` says
their pair bytes beat `config.collective_sparse_threshold` x the dense
payload: each rank's (indices, values * multiplier) pairs cross, and each
rank scatters every rank's pairs (`collectives.scatter_pairs`), so only the
row dot runs a hand kernel on that route.

Like the JAX loops, both run every epoch to maxIter under the device-side
tol mask (no host sync to stop), so every rank issues the same collectives
in the same order. `clear_program_cache` exists for the JAX API: nothing
is compiled here.

The 2D feature-sharded loop (`sgd2d_whole_fit`, `sgd2d_chunk`,
`sgd2d_unpack_host`; JAX `:262-363`): on a `(data, model)` mesh the
coefficient and gradient carries are this rank's model-axis slice
(d_local,), the batches its data-axis rows, and each epoch is the sharded
loop's masked epoch over the 2D loss (`ops.losses.feature_sharded_variant`:
active coefficients assembled over `model`, the gradient reduced over
`data` only). Every rank runs maxIter epochs, so all issue the same
collectives; the fit ends with the final update of the materialized carry
(the JAX body pins it with an optimization barrier), and its result is
this rank's block [flag?, coeff_slice, criteria, epochs], gathered over
`model` into the (m * block,) pack that `sgd2d_unpack_host` reads (one
readback; the JAX package reads its model-sharded pack the same way). A
2D fit over more than one rank is never captured (ROADMAP C.28,
`dispatch.whole_fit_fallback.mesh`); a one-rank mesh takes the flat fit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import collectives
from . import mesh as mesh_lib


def clear_program_cache() -> None:
    """The JAX package drops its compiled programs; the port has none."""


def _row_dots_of(loss_func):
    """The row dot a sparse loss runs: the kernel, or its plain version for
    the `plain_sparse_` losses."""
    from ..ops import sparsekernels

    if loss_func.name.startswith("plain_"):
        return sparsekernels.sparse_row_dots_plain
    return sparsekernels.sparse_row_dots


def _local_pieces(X, y, w, coeff, loss_func, sparse_pairs: bool):
    """This rank's loss pieces for one batch: (loss_sum, grad_local,
    weight_sum). `grad_local` is the dense local gradient or, with
    `sparse_pairs`, the (indices, values * multiplier) pairs of the batch."""
    if sparse_pairs:
        indices, values = X
        loss, mult = loss_func.pointwise(_row_dots_of(loss_func)(indices, values, coeff), y, w)
        return torch.sum(loss), (indices, values * mult[:, None]), torch.sum(w)
    return loss_func(X, y, w, coeff)


def _init_grad_local(coeff, rows: int, nnz: int, sparse_pairs: bool):
    """The zero gradient carry in `_local_pieces`' structure; its reduce is
    the zero gradient (padding pairs, index -1, are dropped)."""
    if sparse_pairs:
        return (torch.full((rows, nnz), -1, dtype=torch.int32, device=coeff.device),
                coeff.new_zeros((rows, nnz)))
    return torch.zeros_like(coeff)


def sgd_use_sparse_pairs(X_b, d: int, mesh: mesh_lib.Mesh) -> bool:
    """The sparse gradient's route: index-value pairs when the mesh reduces
    (> 1 data shard) and this rank's pair bytes beat the threshold. `X_b`
    is this rank's batch layout (indices (batches, b_local, nnz), values):
    a rank's pairs are b_local x nnz, the JAX package's b_pad / shards x
    nnz. The layout decides, where the JAX package's `_local_pieces` reads
    `loss_func.sparse` (`:78`): the function takes the batch alone, as the
    JAX one of the same name does, and a sparse loss is only ever given
    padded-CSR batches."""
    if not isinstance(X_b, tuple) or mesh_lib.num_data_shards(mesh) <= 1:
        return False
    _, b_local, nnz = X_b[0].shape
    values = X_b[1]
    itemsize = values.element_size() if isinstance(values, torch.Tensor) else \
        np.dtype(values.dtype).itemsize
    return collectives.sparse_reduce_wins(b_local * nnz, d, itemsize=itemsize)


def _reduce_grad(g_local, d: int, mesh, sparse_pairs: bool):
    """Issue the reduction of a gradient carry; a `collectives.Pending`."""
    if sparse_pairs:
        return collectives.sparse_all_reduce_sum(g_local[0], g_local[1], d, mesh=mesh,
                                                 async_op=True)
    return collectives.all_reduce_sum_chunked(g_local, mesh=mesh, async_op=True)


def overlapped_sgd_train(mesh, X_b, y_b, w_b, y_all, init_coeff, loss_func, hyper,
                         max_iter: int, check_labels: bool, sparse_pairs: Optional[bool] = None):
    """The bounded SGD fit on this rank's rows with the carry-delayed
    reduction; the contract of `ops.optimizer._sgd_train_sharded` (the
    packed [flag?, coeff, criteria, epochs] result, on the device, equal on
    every rank). `X_b`, `y_b`, `w_b` are this rank's (batches, b_local, ...)
    rows of the batches the epochs read, `y_all` its labels of every batch
    (the label check)."""
    from ..ops import optimizer as opt

    d = init_coeff.shape[0]
    num_batches = y_b.shape[0]
    if sparse_pairs is None:
        sparse_pairs = sgd_use_sparse_pairs(X_b, d, mesh)
    rows = y_b.shape[1]
    nnz = X_b[0].shape[-1] if isinstance(X_b, tuple) else 0
    coeff = init_coeff
    # the loss and weight sums reduce in the fit's dtype, float32 at least
    sum_dtype = torch.promote_types(coeff.dtype, torch.float32)
    wsum = coeff.new_zeros(())
    epochs = torch.zeros((), dtype=torch.int32, device=coeff.device)
    criteria = torch.full((), float("inf"), dtype=torch.float32, device=coeff.device)
    g_local = _init_grad_local(coeff, rows, nnz, sparse_pairs)
    pending = _reduce_grad(g_local, d, mesh, sparse_pairs)
    for e in range(int(max_iter)):
        k = e % num_batches
        Xk = tuple(leaf[k] for leaf in X_b) if isinstance(X_b, tuple) else X_b[k]
        live = criteria > hyper[opt.HYPER_TOL]
        # carry-delayed apply: the previous epoch's gradient, reduced while
        # this epoch's batch was selected
        new_coeff = opt._update_model(coeff, pending.result(), wsum, hyper)
        lsum, new_g, wsum_local = _local_pieces(Xk, y_b[k], w_b[k], new_coeff, loss_func,
                                                sparse_pairs)
        sums = collectives.all_reduce_sum(
            torch.stack([lsum.to(sum_dtype), wsum_local.to(sum_dtype)]), mesh=mesh)
        new_wsum = sums[1].to(coeff.dtype)
        new_criteria = (sums[0] / torch.clamp(sums[1], min=1e-30)).to(torch.float32)
        coeff = torch.where(live, new_coeff, coeff)
        wsum = torch.where(live, new_wsum, wsum)
        epochs = torch.where(live, epochs + 1, epochs)
        criteria = torch.where(live, new_criteria, criteria)
        if sparse_pairs:
            g_local = tuple(torch.where(live, n, o) for n, o in zip(new_g, g_local))
        else:
            g_local = torch.where(live, new_g, g_local)
        pending = _reduce_grad(g_local, d, mesh, sparse_pairs)
    # the one extra update after the loop (SGD.java onIterationTerminated)
    coeff = opt._update_model(coeff, pending.result(), wsum, hyper)
    flag = None
    if check_labels:
        flag = collectives.all_reduce_min(opt._binomial_labels_ok(y_all), mesh=mesh)
    return opt._pack_train_result(coeff, criteria, epochs, flag)


def overlapped_lloyd_train(mesh, X, weights, init_centroids, max_iter: int, measure_name: str):
    """Lloyd's loop on this rank's rows with the same schedule: epoch e's
    (k, d) + (k,) centroid partials reduce at the top of epoch e+1, issued
    asynchronously as epoch e ends. Epoch 0 reduces the zero init (counts
    0: the centroids keep their init rows). Returns (centroids, counts of
    the last epoch), equal on every rank."""
    from ..models.clustering.kmeans import lloyd_partials, lloyd_update

    k = init_centroids.shape[0]
    centroids = init_centroids
    partials = (torch.zeros_like(init_centroids), init_centroids.new_zeros((k,)))
    pending = collectives.all_reduce_sum_chunked(partials, mesh=mesh, async_op=True)
    for _ in range(int(max_iter)):
        sums, counts = pending.result()
        centroids = lloyd_update(centroids, sums, counts)
        partials = lloyd_partials(X, weights, centroids, measure_name)
        pending = collectives.all_reduce_sum_chunked(partials, mesh=mesh, async_op=True)
    sums, counts = pending.result()
    return lloyd_update(centroids, sums, counts), counts


def sgd2d_chunk(mesh, X_b, y_b, w_b, state, loss_func, hyper, start: int, end: int):
    """Epochs [start, end) of the 2D fit under the device-side tol mask:
    the contract of the sharded loop's epochs, on the carry
    (coeff_slice, grad_slice, wsum, epochs, criteria). `X_b` is this rank's
    (batches, b_local, nnz) rows of the batches the epochs read; the
    checkpointed loop runs it chunk by chunk, the whole fit once."""
    from ..ops import losses
    from ..ops import optimizer as opt

    loss2d = losses.feature_sharded_variant(loss_func)
    num_batches = y_b.shape[0]
    for e in range(int(start), int(end)):
        k = e % num_batches
        coeff, grad, wsum, epochs, criteria = state
        live = criteria > hyper[opt.HYPER_TOL]
        coeff = opt._update_model(coeff, grad, wsum, hyper)
        lsum, grad, wsum = loss2d.fn((X_b[0][k], X_b[1][k]), y_b[k], w_b[k], coeff, mesh)
        new = (coeff, grad, wsum, epochs + 1,
               (lsum / torch.clamp(wsum, min=1e-30)).to(torch.float32))
        state = tuple(torch.where(live, n, o) for n, o in zip(new, state))
    return state


def sgd2d_finish(mesh, state, hyper, flag=None):
    """The final update of the materialized carry and the result: this
    rank's block [flag?, coeff_slice, criteria, epochs], gathered over
    `model` into the (m * block,) pack, equal on every rank."""
    from ..ops import optimizer as opt

    coeff, grad, wsum, epochs, criteria = state
    block = opt._pack_train_result(opt._update_model(coeff, grad, wsum, hyper), criteria,
                                   epochs, flag)
    return collectives.all_gather(block, mesh_lib.MODEL_AXIS, mesh=mesh)


def sgd2d_whole_fit(mesh, X_b, y_b, w_b, state, loss_func, hyper, max_iter: int,
                    y_all=None, check_labels: bool = False, start: int = 0):
    """The whole 2D fit: epochs [start, maxIter) of `sgd2d_chunk`, then
    `sgd2d_finish`. Returns (state, pack); with `check_labels` the {0,1}
    label flag of every rank's labels (`y_all`, min-reduced over `data`)
    rides each block."""
    from ..ops import optimizer as opt

    state = sgd2d_chunk(mesh, X_b, y_b, w_b, state, loss_func, hyper, start, max_iter)
    flag = None
    if check_labels:
        flag = collectives.all_reduce_min(opt._binomial_labels_ok(y_all), mesh=mesh)
    return state, sgd2d_finish(mesh, state, hyper, flag)


def sgd2d_unpack_host(host, num_model_shards: int, d_local: int, has_flag: bool):
    """Host-side inverse of the 2D pack: (m * block,) with block = [flag?,
    coeff_slice, criteria, epochs]. The scalars are the same in every
    block; block 0's are read. Returns (coeff, criteria, epochs, flag?)."""
    block = d_local + 2 + (1 if has_flag else 0)
    blocks = np.asarray(host).reshape(num_model_shards, block)
    off = 1 if has_flag else 0
    coeff = np.concatenate([blocks[s, off:off + d_local] for s in range(num_model_shards)])
    criteria = float(blocks[0, off + d_local])
    epochs = int(blocks[0, off + d_local + 1])
    flag = float(blocks[0, 0]) if has_flag else None
    return coeff, criteria, epochs, flag


def fleet_overlap_supported() -> bool:
    """Whether a fleet fit rides these loops: no, as in the JAX package. A
    fleet trains on its member-batched loops, and `FitFleet.fit` counts the
    downgrade of an overlap-tuned process as
    `dispatch.whole_fit_fallback.fleet_overlap`."""
    return False
