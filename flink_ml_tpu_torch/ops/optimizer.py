"""Mini-batch SGD: the training engine for linear models.

Port of the single-device whole fit of flink_ml_tpu/ops/optimizer.py
(`_sgd_train_flat`, `_optimize_flat_async`; the reference's
common/optimizer/SGD.java:82-292 and RegularizationUtils.java). Semantics
kept exactly:

- rows are padded to a multiple of the batch size B (sparse padding rows
  get index -1); epoch e trains on batch e mod num_batches;
- without a weight column the weight is `row < n`, so padding is inert;
- each epoch first applies the previous gradient (no update while the
  weight sum is 0, i.e. in the first epoch), then computes the gradient
  of its batch; `criteria = loss_sum / max(weight_sum, 1e-30)` in float32;
- the loop runs while `epoch < maxIter and criteria > tol`; one extra
  update lands after it;
- the result is one packed float32 vector (flag?, coeff, criteria, epochs).

One host sync per fit: the tol stop is a device-side mask. The Python loop
always runs maxIter epochs, and once `criteria <= tol` every update and the
epoch count are `torch.where`'d away, so nothing is read back until the
packed result. The hyperparameters are one float32 device vector
(`sgd_hyper`: learningRate, reg, elasticNet, tol and the two proximal
factors, formed in float64 on the host), as the JAX package packs them
(`_unpack_hyper`), and every product they enter is the one the
host-scalar form computes, so the bits are the same.

The whole bounded fit (`_sgd_train_flat`) runs through the program funnel
(utils/lazyjit.py): on the card, one captured CUDA graph per signature
(the inputs' shapes, the loss, the batch, the row count, maxIter and the
label check), replayed by every later fit of the same signature, at any
learning rate, regularisation or tol (they are operands). Only the rows
the epochs read go in: the first min(num_batches, maxIter) batches of X
(and of the weights), with all of y for the label check. A staged input
that needs padding, a cast or an upload is written straight into the
graph's buffer (`stage_flat` returns it as a `lazyjit.Feed`), and the
graph reads training data already on the card in place (`borrow`), so
the data is never copied twice and the cache keeps no copy of data the
caller holds. `config.whole_fit = "off"` runs the fit op by op. The
stream fit and the checkpointed chunk loops stay eager: their per-epoch
host work (uploads, drains, snapshots) is the point of them (ROADMAP
A.14b, C.23).

`SGD.optimize_stream` trains on a stream of host chunks, out of core: it
caches the stream once in the native data cache and replays one batch an
epoch through the device epoch cache, with the same epoch arithmetic
(`_masked_epoch`), so it equals the bounded fit of the same rows.

The fleet programs (`_sgd_fleet_whole_fit`, `_sgd_fleet_chunk`,
`_sgd_fleet_stream_whole_fit`) train N members over one staged input for
`fleet.FitFleet`, each member with the solo fit's arithmetic, its own
hyperparameters and its own stop.

Checkpoints (`SGD.checkpoint_dir`; the JAX package's
`_optimize_with_checkpoints`, `optimize_stream`'s snapshots): the epochs
are the whole fit's masked epochs (`_sgd_epochs`) cut into chunks that end
at the checkpoint boundaries, one (epoch, criteria) readback a chunk, so a
checkpointed fit equals the unchecked one bit for bit. The carry
(coeff, grad, wsum, epoch) is snapshotted with the criteria at every
`checkpoint_interval`-th epoch under `checkpoint_key`, with the batch
schedule in meta (`numBatches` / `numSegments`, `globalBatchSize`), and a
fit resumes from the newest snapshot; the `chunk` (in memory) and `epoch`
(stream) fault sites tick at each drained chunk and epoch. A sharded
stream snapshot also carries the stream cache's contents, so a resumed
stream fit does not read its input again.

On a mesh of more than one rank (parallel/mesh.py; the JAX package's
`optimize_async` over the `data` axis, `:804-917`) every rank runs the
fit on its own rows: `_batchify` gives a rank exactly the slots its
device holds in the JAX package's (batches, b_pad, ...) layout (`b_pad`
the batch padded to a multiple of the shards; only the batches the epochs
read, as the flat fit stages them), and each epoch of `_sgd_train_sharded`
reduces the local (gradient, loss, weight) sums with one all-reduce before
the tol check, so every rank holds the same state. With
`collective_overlap` (or `config.collective_overlap`) the loop is
`parallel.overlap.overlapped_sgd_train`'s carry-delayed apply. Those
epochs run eagerly, not as a captured graph (a gloo collective cannot be
captured; counted as `dispatch.whole_fit_fallback.mesh`, ROADMAP C.28). A
one-rank mesh takes the flat route, as in the JAX package.

Feature sharding (`shard_features`, JAX `:718-770`): a sparse fit on a
mesh with a `model` axis under `config.sparse_2d == "auto"` (`_use_2d`)
runs the 2D loop of parallel/overlap.py: `d` zero-padded to a multiple of
the model shards, the coefficient and gradient carries staged as this
rank's model-axis slice straight from the host (`_stage_2d_carry`, through
the admitted funnel under `optimizer`), the batches over `data`, and one
`packed2d` readback of the slices gathered over `model`. Every other
feature-sharded fit (dense, a mesh without a model axis, or `sparse_2d`
"off") is the replicated-coefficient fit over `data`, its carries staged
through the same funnel, so a budget below one replicated carry refuses
it (`HbmBudgetExceeded`) where the 2D fit trains.

A checkpointed fit on a mesh of ranks (`_optimize_mesh_with_checkpoints`)
runs the sharded or 2D epochs in chunks that end at the boundaries, and
every rank writes its part of each cut (`snapshot.save_job_snapshot(mesh=)`:
the `model`-tagged slices of a 2D carry, the replicated leaves on rank 0);
a resume stages the newest cut onto this mesh by tag
(`snapshot.stage_section(mesh=)`), so a cut of one factorization or rank
count resumes on another. `optimize_stream` on a mesh of ranks caches
only this rank's rows of every batch (`ingest_stream(shards=, rank=)`) and
reduces each epoch's sums over `data`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..ckpt import faults
from ..obs import tracing
from ..parallel import mesh as mesh_lib
from ..parallel import supervisor
from ..parallel.prefetch import to_device
from ..utils import lazyjit
from ..utils.packing import packed_device_get
from . import losses, sgdkernels
from .losses import FEATURE_SHARDED_VARIANTS, LossFunc
#: the rows of `sgd_hyper` (the epoch kernels read them by the same rows)
from .sgdkernels import HYPER_EN, HYPER_L1, HYPER_L2, HYPER_LR, HYPER_REG, HYPER_TOL  # noqa: F401

#: the default compute dtype (`SGD.dtype`): host float64 columns are cast
#: to the fit's dtype once, at staging. The fleet programs, whose
#: estimators carry no dtype, train at it.
COMPUTE_DTYPE = torch.float32


def compute_dtype(dtype) -> torch.dtype:
    """`dtype` (a torch or numpy dtype, or its name) as a floating torch
    dtype."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    if not dtype.is_floating_point:
        raise TypeError(f"SGD.dtype must be a floating dtype, got {dtype}")
    return dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def check_sparse_dtype(X, dtype: torch.dtype) -> None:
    """A padded-CSR fit trains in float32 only: the sparse kernels, like
    the JAX package's Pallas kernels, take float32 values (ROADMAP C.40).
    Raised on every device; nothing falls back to the plain version."""
    if isinstance(X, tuple) and dtype != torch.float32:
        raise TypeError(
            f"SGD(dtype={dtype}) cannot train padded-CSR (sparse) features: the sparse "
            "kernels sparse_row_dots and sparse_grad take float32 values; use "
            "dtype=float32, or densify the features")


def _prox_step(coeff, reg, elastic_net, learning_rate):
    """The proximal regularization update of `regularize`, without its loss."""
    if reg <= 0.0:
        return coeff
    step = learning_rate * (
        elastic_net * reg * torch.sign(coeff) + (1.0 - elastic_net) * reg * coeff
    )
    return coeff - step


def regularize(coeff, reg, elastic_net, learning_rate):
    """Proximal regularization step; returns (new_coeff, reg_loss).

    Matches RegularizationUtils.regularize, including its use of the
    (unsquared) L2 norm in the reported L2 loss: en=0 gives
    coeff*(1 - lr*reg), en=1 coeff - lr*reg*sign, else the mix."""
    new_coeff = _prox_step(coeff, reg, elastic_net, learning_rate)
    if reg == 0.0:
        loss = coeff.new_zeros(())
    elif elastic_net == 0.0:
        loss = reg / 2.0 * torch.linalg.vector_norm(coeff)
    elif elastic_net == 1.0:
        loss = torch.sum(elastic_net * reg * torch.sign(coeff))
    else:
        loss = torch.sum(
            elastic_net * reg * torch.sign(coeff)
            + (1.0 - elastic_net) * (reg / 2.0) * coeff * coeff
        )
    return new_coeff, loss


def sgd_hyper(learning_rate, reg, elastic_net, tol, device,
              dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
    """The fit's hyperparameters as one device vector of the fit's dtype
    [lr, reg, elasticNet, tol, elasticNet * reg, (1 - elasticNet) * reg],
    the products formed in float64 as the host-scalar `_prox_step` forms
    them before they scale a tensor."""
    lr, reg, en, tol = float(learning_rate), float(reg), float(elastic_net), float(tol)
    rows = np.asarray([lr, reg, en, tol, en * reg, (1.0 - en) * reg], np.float64)
    return to_device(rows.astype(_numpy_dtype(dtype)), device)


def _update_model(coeff, grad, wsum, hyper, criteria=None):
    """coeff -= lr / wsum * grad, then the proximal step (`_prox_step` with
    the hyperparameters as device operands, coeff kept exactly where reg
    is 0), only where wsum > 0 and, given the state's criteria, only in a
    live epoch (criteria > tol): device-side selects, no host sync. One
    kernel on the card, the op sequence on the CPU (`sgdkernels.sgd_update`);
    every body's update goes through here."""
    return sgdkernels.sgd_update(coeff, grad, wsum, hyper, criteria)


def _binomial_labels_ok(y):
    """{0,1} label validity flag (LogisticRegression.java:78-87), carried in
    the fit's packed readback. Padding rows have label 0 and pass."""
    return torch.all((y == 0.0) | (y == 1.0)).to(torch.float32)


def _slice_rows(X, start, rows):
    if isinstance(X, tuple):
        return tuple(leaf[start : start + rows] for leaf in X)
    return X[start : start + rows]


def _pack_train_result(coeff, criteria, epochs, flag=None):
    """(flag?, coeff, criteria, epochs) as ONE flat vector of the
    coefficient's dtype, at least float32, so the host reads everything
    back in a single transfer. float32 holds the epoch count exactly."""
    dt = torch.promote_types(coeff.dtype, torch.float32)
    parts = [coeff.to(dt), criteria.reshape(1).to(dt), epochs.reshape(1).to(dt)]
    if flag is not None:
        parts.insert(0, flag.reshape(1).to(dt))
    return torch.cat(parts)


def _init_state(init_coeff, grad=None):
    """(coeff, grad, wsum, epochs, criteria) before the first epoch; `grad`
    is a staged zero gradient carry, else one is made."""
    device = init_coeff.device
    return (
        init_coeff,
        torch.zeros_like(init_coeff) if grad is None else grad,
        torch.zeros((), dtype=init_coeff.dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.full((), float("inf"), dtype=torch.float32, device=device),
    )


def _epoch_step(Xk, yk, wk, state, loss_func, hyper):
    """One epoch under the device-side tol mask: apply the previous
    gradient, compute the next on this epoch's batch, with
    `criteria = loss_sum / max(weight_sum, 1e-30)`; once the state's
    criteria are <= tol (the epoch is dead), the state is kept as it was.
    Returns ((coeff, grad, wsum, epoch), criteria).

    A loss of ops/losses.py's dense or sparse layout (`losses.epoch_fn`)
    hands the state to its pointwise pass, which writes the epoch's tail
    under the mask itself: on the card the epoch is the update kernel, the
    row dots, the pointwise kernel, the gradient and one select of the
    gradient. Any other loss's outputs are selected here."""
    coeff, grad, wsum, epoch, criteria = state
    new_coeff = _update_model(coeff, grad, wsum, hyper, criteria)
    epoch_fn = losses.epoch_fn(loss_func)
    if epoch_fn is not None:
        out, new_grad = epoch_fn(Xk, yk, wk, new_coeff,
                                 sgdkernels.EpochTail(hyper, wsum, epoch, criteria))
        tail = out.tail
        return (new_coeff, torch.where(tail.live, new_grad, grad), tail.wsum,
                tail.epoch), tail.criteria
    live = criteria > hyper[HYPER_TOL]
    lsum, new_grad, new_wsum = loss_func(Xk, yk, wk, new_coeff)
    new_criteria = (lsum / torch.clamp(new_wsum, min=1e-30)).to(torch.float32)
    new = (new_grad, new_wsum, epoch + 1, new_criteria)
    *carry, criteria = (torch.where(live, n, o) for n, o in zip(new, state[1:]))
    return (new_coeff, *carry), criteria


def _masked_epoch(Xk, yk, wk, state, loss_func, hyper):
    """`_epoch_step` on the state (coeff, grad, wsum, epochs, criteria):
    the next state. While the fit is live, the device epoch count equals
    the host's epoch index, so the host knows the batch."""
    carry, criteria = _epoch_step(Xk, yk, wk, state, loss_func, hyper)
    return (*carry[:4], criteria)


def _finish(state, hyper, flag=None):
    """The update after the loop, packed with the criteria and epochs."""
    coeff, grad, wsum, epochs, criteria = state
    coeff = _update_model(coeff, grad, wsum, hyper)
    return _pack_train_result(coeff, criteria, epochs, flag)


def _row_weights(rows: int, n: int, dtype, device):
    """The weights of the rows [0, rows) without a weight column: `row < n`,
    so padding is inert. Made once a run of epochs (a fill and the padding's
    zeros), each epoch's batch a view of it."""
    w = torch.ones(rows, dtype=dtype, device=device)
    w[n:] = 0.0
    return w


def _sgd_epochs(X, y, w, state, loss_func, batch, n, start, end, hyper):
    """Epochs [start, end) of the bounded fit on flat, batch-padded device
    tensors: epoch e trains the row slice of batch e mod num_batches (of
    y's rows: X and w may hold only the batches the epochs read); `w`
    None takes the weights `row < n` (`_row_weights`). The whole fit is
    this from 0 to maxIter; a checkpointed fit runs it chunk by chunk."""
    num_batches = y.shape[0] // batch
    if w is None:
        first = X[0] if isinstance(X, tuple) else X
        w = _row_weights(first.shape[0], n, state[0].dtype, y.device)
    for e in range(start, end):
        begin = (e % num_batches) * batch
        Xk = _slice_rows(X, begin, batch)
        yk = y[begin : begin + batch]
        state = _masked_epoch(Xk, yk, w[begin : begin + batch], state, loss_func, hyper)
    return state


def _touched_rows(num_batches: int, batch: int, max_iter: int) -> int:
    """The rows the epochs of a whole fit read: the first
    min(num_batches, maxIter) batches."""
    return min(num_batches, max(1, max_iter)) * batch


@lazyjit.lazy_jit(static_argnames=("loss_func", "batch", "n", "max_iter", "check_labels"),
                  ledger="streamSegments", borrow=("X", "y", "w"))
def _sgd_train_flat(X, y, w, init_coeff, hyper, loss_func, batch, n, max_iter, check_labels):
    """The whole bounded fit on flat, batch-padded device tensors (X and w
    may hold only the batches the epochs read, `_touched_rows`); one
    program of the funnel. Returns the packed result tensor, on the
    device."""
    state = _sgd_epochs(X, y, w, _init_state(init_coeff), loss_func, batch, n, 0, max_iter,
                        hyper)
    flag = _binomial_labels_ok(y) if check_labels else None
    return _finish(state, hyper, flag)


def _carry_template(d: int, dtype: torch.dtype = COMPUTE_DTYPE):
    """The snapshot template of the SGD carry (coeff, grad, wsum, epoch):
    the JAX package's leaves and dtypes."""
    dt = _numpy_dtype(dtype)
    return (np.zeros(d, dt), np.zeros(d, dt), dt.type(0.0), np.int32(0))


def _resumed_state(snap, device, mesh=None, specs=None):
    """The fit state (coeff, grad, wsum, epochs, criteria) of a restored
    snapshot, on `device` in one copy; with `mesh`, each leaf staged onto
    this rank by its tag (`specs` over the stored ones)."""
    from ..ckpt.snapshot import stage_section

    coeff, grad, wsum, _ = stage_section(snap, "model", device=device, mesh=mesh, specs=specs)
    return (coeff, grad, wsum,
            to_device(snap.epoch, device, torch.int32),
            to_device(snap.criteria, device, torch.float32))


class StreamLayout(NamedTuple):
    """Where one packed stream segment keeps its parts: a flat array of
    the fit's dtype (numpy) holding the blocks X (batch x d, row-major), y
    (batch) and w (batch), each starting at a multiple of BLOCK_ALIGN
    elements, so every part is a contiguous, aligned view of the segment
    on the device too."""

    batch: int
    d: int
    dtype: np.dtype = np.dtype(np.float32)

    @property
    def y_offset(self) -> int:
        return _round_up(self.batch * self.d)

    @property
    def w_offset(self) -> int:
        return self.y_offset + _round_up(self.batch)

    @property
    def size(self) -> int:
        return self.w_offset + self.batch

    def views(self, flat):
        """(X, y, w) views of a flat segment (numpy or torch), or of a stack
        of segments (..., size) as (..., B, d), (..., B), (..., B)."""
        B, d = self.batch, self.d
        return (flat[..., : B * d].reshape(*flat.shape[:-1], B, d),
                flat[..., self.y_offset : self.y_offset + B],
                flat[..., self.w_offset : self.w_offset + B])


BLOCK_ALIGN = 64


def _round_up(n: int) -> int:
    return -(-n // BLOCK_ALIGN) * BLOCK_ALIGN


def ingest_stream(chunks: Iterable, batch: int, cache, shards: int = 1,
                  rank: int = 0, dtype: torch.dtype = COMPUTE_DTYPE
                  ) -> Tuple[List[int], StreamLayout]:
    """One pass over host (X, y, w) chunks into `cache`: rows are re-cut
    into `batch`-row batches, the remainder carried from chunk to chunk, and
    each batch is appended as one packed segment of `dtype` (`StreamLayout`).
    A missing w is 1; the last partial batch is padded with weight-0 rows.
    With `shards` > 1 a segment holds only this rank's slots of its batch
    (the batch padded to a multiple of the shards, `rank`'s block of
    b_pad / shards rows, padding at weight 0): the rows its device holds
    in the JAX package's data-sharded stream cache. Returns (segment ids,
    layout)."""
    segs: List[int] = []
    layout = flat = local = None
    filled = 0
    b_local = -(-int(batch) // int(shards))
    slots = rank * b_local + np.arange(b_local)
    kept = slots[slots < batch]

    def emit():
        if local is None:
            segs.append(cache.append_array(flat))
            return
        Xl, yl, wl = local_layout.views(local)
        local[:] = 0.0
        Xl[:kept.size], yl[:kept.size], wl[:kept.size] = Xb[kept], yb[kept], wb[kept]
        segs.append(cache.append_array(local))

    dt = _numpy_dtype(dtype)
    for X, y, w in chunks:
        X = np.asarray(X)
        if layout is None:
            layout = StreamLayout(int(batch), int(X.shape[1]), dt)
            flat = np.zeros(layout.size, dt)
            Xb, yb, wb = layout.views(flat)
            if shards > 1:
                local_layout = StreamLayout(b_local, int(X.shape[1]), dt)
                local = np.zeros(local_layout.size, dt)
        elif X.shape[1] != layout.d:
            raise ValueError(f"stream chunk has {X.shape[1]} features, expected {layout.d}")
        n, off = X.shape[0], 0
        while off < n:
            take = min(batch - filled, n - off)
            Xb[filled : filled + take] = X[off : off + take]
            yb[filled : filled + take] = y[off : off + take]
            wb[filled : filled + take] = 1.0 if w is None else w[off : off + take]
            filled += take
            off += take
            if filled == batch:
                emit()
                filled = 0
    if filled:
        Xb[filled:], yb[filled:], wb[filled:] = 0.0, 0.0, 0.0
        emit()
    if not segs:
        raise ValueError("optimize_stream received an empty stream")
    return segs, (layout if local is None else local_layout)


def unpack_train_result(host: np.ndarray, d: int, has_flag: bool = False):
    """Host-side inverse of `_pack_train_result`: returns
    (flag_or_None, coeff[:d], criteria, epochs)."""
    flag = float(host[0]) if has_flag else None
    off = 1 if has_flag else 0
    return flag, host[off : off + d], float(host[-2]), int(host[-1])


def read_train_result(async_result):
    """Bring an `optimize_async` result to the host in one transfer.
    Returns (flag_or_None, coeff[:d], criteria, epochs). A 2D fit's
    ("packed2d", pack, d, has_flag, model_shards, d_local) reads its
    gathered slices (`overlap.sgd2d_unpack_host`)."""
    if async_result[0] == "packed2d":
        from ..parallel.overlap import sgd2d_unpack_host

        _, packed, d, has_flag, nm, d_local = async_result
        (host,) = packed_device_get(packed, sync_kind="fit")
        coeff, criteria, epochs, flag = sgd2d_unpack_host(host, nm, d_local, has_flag)
        return flag, coeff[:d], criteria, epochs
    _, packed, d, has_flag = async_result
    (host,) = packed_device_get(packed, sync_kind="fit")
    return unpack_train_result(host, d, has_flag=has_flag)


def _stage(arr, dtype, device):
    """A host array becomes a tensor on `device`; a tensor keeps its device
    and is cast only if its dtype differs."""
    if isinstance(arr, torch.Tensor):
        if arr.device != device:
            raise ValueError(
                f"training inputs must share one device, got {arr.device} and {device}"
            )
        return arr.to(dtype) if arr.dtype != dtype else arr
    return to_device(np.asarray(arr), device, dtype)


@dataclass
class SGD:
    """Mini-batch SGD (common/optimizer/SGD.java) on one device or a mesh
    of ranks."""

    max_iter: int = 20
    learning_rate: float = 0.1
    global_batch_size: int = 32
    tol: float = 1e-6
    reg: float = 0.0
    elastic_net: float = 0.0
    #: the fit's compute dtype (torch, numpy or a name; `compute_dtype`):
    #: float32 by default; float64 trains a dense fit in double precision,
    #: as the JAX package does under x64 (ROADMAP C.11). A padded-CSR fit
    #: is float32 only (`check_sparse_dtype`, C.40)
    dtype: Any = torch.float32
    #: snapshot the fit here every `checkpoint_interval` epochs and resume
    #: from the newest snapshot; None is no checkpointing
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 1
    #: the job identity that names the snapshot files
    #: (`parallel.iteration.checkpoint_job_key`); None is the un-keyed file
    checkpoint_key: Optional[str] = None
    #: also shard the feature dimension over the mesh's `model` axis: the
    #: 2D layout of a wide sparse model (`_use_2d`)
    shard_features: bool = False
    #: the carry-delayed reduction of parallel/overlap.py on a mesh of more
    #: than one rank; None follows `config.collective_overlap`
    collective_overlap: Optional[bool] = None

    @property
    def _dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    def _overlap_enabled(self) -> bool:
        on = (self.collective_overlap if self.collective_overlap is not None
              else config.collective_overlap)
        return bool(on) and not self.shard_features and self.checkpoint_dir is None

    def optimize(self, init_coeff, X, y, weights, loss_func: LossFunc,
                 mesh=None) -> Tuple[np.ndarray, float, int]:
        """Returns (final_coefficient, final_loss, num_epochs)."""
        result = self.optimize_async(init_coeff, X, y, weights, loss_func, mesh)
        _, coeff, criteria, epochs = read_train_result(result)
        return coeff, criteria, epochs

    def optimize_async(self, init_coeff, X, y, weights, loss_func: LossFunc,
                       mesh=None, validate_labels: bool = False):
        """Run the whole fit WITHOUT reading results back. Returns a
        ("packed", device_vector, true_dim, has_flag) handle for
        `read_train_result`; with `validate_labels` the {0,1} label check
        rides the same transfer.

        X is a dense (n, d) matrix or the sparse (indices, values) pair.
        Host arrays are staged to `config.device()`; tensors stay on their
        device, and all tensor inputs must share one. `mesh` (default
        `mesh.default_mesh()`) of more than one rank trains data-parallel:
        every rank passes the same whole inputs and trains on its rows. On a
        mesh with a model axis a feature-sharded sparse fit trains 2D
        (`_use_2d`); any other fit splits its rows over every rank
        (`mesh.flatten`)."""
        mesh = mesh if mesh is not None else mesh_lib.default_mesh()
        d = int(np.shape(init_coeff)[0])
        check_sparse_dtype(X, self._dtype)
        if mesh.size <= 1:
            packed = self._optimize_flat_async(init_coeff, X, y, weights, loss_func,
                                               validate_labels)
        elif self._use_2d(mesh, loss_func) and isinstance(X, tuple):
            return self._optimize_2d_async(mesh, init_coeff, X, y, weights, loss_func,
                                           validate_labels)
        else:  # the coefficient whole on every rank: rows over the whole world
            packed = self._optimize_sharded_async(mesh_lib.flatten(mesh), init_coeff, X, y,
                                                  weights, loss_func, validate_labels)
        return ("packed", packed, d, validate_labels)

    def _use_2d(self, mesh, loss_func: LossFunc) -> bool:
        """Route this fit through the 2D loop (parallel/overlap.py
        `sgd2d_*`)? A feature-sharded SPARSE fit on a mesh with a model
        axis, under `config.sparse_2d == "auto"`; "off" keeps the
        replicated-coefficient fit, the reference the 2D fit is held to. A
        one-shard model axis still routes 2D (its model collectives are
        identities), which makes the one-shard parity testable. A sparse
        loss is one that `LossFunc.sparse` marks, as in the JAX package; one
        with no 2D form (a user's own, or a 2D loss itself) raises
        ValueError rather than train replicated."""
        use = (self.shard_features and loss_func.sparse
               and config.sparse_2d == "auto" and mesh_lib.MODEL_AXIS in mesh.axis_names)
        if use and loss_func.name not in FEATURE_SHARDED_VARIANTS:
            raise ValueError(
                f"shard_features: the sparse loss {loss_func.name!r} has no feature-sharded "
                f"(2D) form; the 2D fit runs {sorted(FEATURE_SHARDED_VARIANTS)}")
        return use

    def _stage_2d_carry(self, mesh, init_coeff, d_pad: int, device):
        """The coefficient and the zero gradient carry staged DIRECTLY as
        this rank's model-axis slices (d_pad / m each), through the
        admitted funnel under `optimizer`: a (d,) carry never exists
        replicated on the device (JAX `_stage_2d_grad`)."""
        from ..parallel.prefetch import stage_to_device

        init = _host_coeff(init_coeff)
        init = np.pad(init, (0, d_pad - init.shape[0]))
        return stage_to_device((init, np.zeros(d_pad, np.float32)), device,
                               category="optimizer", sharding=mesh_lib.model_sharding(mesh)).wait()

    def _optimize_2d_async(self, mesh, init_coeff, X, y, weights, loss_func, validate_labels):
        """The 2D fit on this rank's rows and model slice; returns the
        ("packed2d", pack, d, has_flag, model_shards, d_local) handle.
        Padded coefficients start 0, get zero gradients and stay 0."""
        from ..obs import memledger
        from ..parallel import dispatch, overlap

        nm = mesh_lib.num_model_shards(mesh)
        d = int(np.shape(init_coeff)[0])
        d_pad = -(-d // nm) * nm
        X_b, y_b, w_b, y_all = self._batchify(mesh, X, y, weights)
        memledger.track((X_b, y_b, w_b, y_all), "streamSegments")
        device = y_b.device
        state = _init_state(*self._stage_2d_carry(mesh, init_coeff, d_pad, device))
        hyper = self._hyper(device)
        max_iter = int(self.max_iter)
        dispatch.whole_fit_plan(start_epoch=0, max_iter=max_iter, ranks=mesh.size)
        with tracing.span("iteration.run", mode="2d", epochs=max_iter, ranks=mesh.size,
                          modelShards=nm):
            if self.checkpoint_dir is not None:
                packed = self._optimize_mesh_with_checkpoints(
                    mesh, y_all, state, validate_labels, d,
                    epochs=lambda st, a, b: overlap.sgd2d_chunk(mesh, X_b, y_b, w_b, st,
                                                                 loss_func, hyper, a, b),
                    finish=lambda st, flag: overlap.sgd2d_finish(mesh, st, hyper, flag),
                    specs=("model", "model", "replicated", "replicated"))
            else:
                with dispatch.timed_dispatch("sgd2d_whole_fit", start=0, end=max_iter):
                    _, packed = overlap.sgd2d_whole_fit(mesh, X_b, y_b, w_b, state, loss_func,
                                                        hyper, max_iter, y_all, validate_labels)
        return ("packed2d", packed, d, validate_labels, nm, d_pad // nm)

    def optimize_stream(self, init_coeff, chunks, loss_func: LossFunc, mesh=None,
                        memory_budget_bytes: Optional[int] = None,
                        spill_dir: Optional[str] = None):
        """Out-of-core SGD over a one-shot stream of host (X, y, w) chunks
        (the reference's ReplayOperator.java:125-246 over its spillable
        DataCache). `ingest_stream` caches the stream once, as packed
        globalBatchSize segments in the native `DataCache`; epoch p then
        replays segment p mod nb through the device epoch cache
        (`CachedEpochLoader`, whose worker stages epoch p+1's segment while
        epoch p trains) and runs the bounded fit's `_masked_epoch`, and the
        result comes back in one packed readback. Batch schedule and
        padding are the bounded fit's, so a stream fit equals the bounded
        fit of the concatenated rows.

        Only the min(nb, maxIter) segments that the epochs replay are
        staged to the device, one at a time as the epochs reach them (the
        JAX package's whole-fit arm stacks all nb first; the arithmetic is
        the same).

        With `checkpoint_dir`, the carry is snapshotted every
        `checkpoint_interval` epochs (meta `numSegments`,
        `globalBatchSize`, `dim`, `cacheCursor`) and a fit resumes from
        the newest snapshot; a sharded snapshot (`config.snapshot_hosts`)
        also holds the cache's segments as a stable `cache` section (with
        `config.snapshot_cache_contents`), from which a resumed fit
        rebuilds its cache without reading `chunks`. Returns
        (coefficient, final_loss, num_epochs, stats)."""
        from ..ckpt import snapshot as _snapshot
        from ..data.devicecache import (CachedEpochLoader, cache_contents_section,
                                        restore_cache_contents)
        from ..native.datacache import DataCache
        from ..parallel import dispatch
        from ..parallel.prefetch import DeviceStager

        if self.shard_features:
            raise NotImplementedError(
                "feature-sharded (tensor-parallel) training requires the in-memory path; "
                "stream mode is data-parallel only")
        mesh = mesh_lib.flatten(mesh if mesh is not None else mesh_lib.default_mesh())
        shards = mesh_lib.num_data_shards(mesh)
        ranked = mesh.size > 1
        device = mesh.device if ranked else config.device()
        dtype = self._dtype
        ckpt, key = self.checkpoint_dir, self.checkpoint_key
        B = int(self.global_batch_size)
        cache = DataCache(
            config.datacache_memory_budget_bytes if memory_budget_bytes is None
            else memory_budget_bytes,
            config.datacache_spill_dir if spill_dir is None else spill_dir,
        )
        try:
            t0 = time.perf_counter()
            restored = peek = None
            # a rank's cache holds only its rows: a resume on ranks ingests again
            if ckpt is not None and config.snapshot_cache_contents and not ranked:
                peek = _snapshot.load_job_snapshot(ckpt, key, expect_meta={"globalBatchSize": B})
                if peek is not None and "dim" in peek.meta:
                    restored = restore_cache_contents(
                        peek, cache, StreamLayout(B, int(peek.meta["dim"]), _numpy_dtype(dtype)))
            if restored is not None:
                segs, layout = restored
            else:
                segs, layout = ingest_stream(chunks, B, cache, shards,
                                             mesh.axis_index(mesh_lib.DATA_AXIS), dtype)
            ingest_s = time.perf_counter() - t0
            d, nb = layout.d, len(segs)
            meta = {"numSegments": nb, "globalBatchSize": B, "dim": int(d)}
            stable, stable_specs = None, {}
            if ckpt is not None and config.snapshot_hosts is not None \
                    and config.snapshot_cache_contents and not ranked:
                # read before the loader's worker starts: the cache is serial
                contents = cache_contents_section(cache, segs, layout)
                stable, stable_specs = {"cache": lambda: contents}, {"cache": "data"}
            stager = DeviceStager(device)
            seg_bytes = layout.size * layout.dtype.itemsize

            def fetch(k):
                staged = stager.stage(seg_bytes, lambda host: cache.read_into(segs[k], host.numpy()))
                staged.value = layout.views(staged.value.view(dtype))
                return staged

            init = np.zeros(d) if init_coeff is None else init_coeff
            state = _init_state(_stage(init, dtype, device))
            start, interval = 0, max(1, int(self.checkpoint_interval))
            if ckpt is not None:
                templates = {"model": _carry_template(d, dtype)}
                # the cache came from `peek`: its model is the same cut's
                snap = _snapshot.conform(peek, templates, meta) if restored is not None else \
                    _snapshot.load_job_snapshot(ckpt, key, templates=templates, expect_meta=meta)
                if snap is not None:
                    state = _resumed_state(snap, device, mesh if ranked else None)
                    start = snap.epoch
            # tpulint: disable=host-sync-leak -- a resumed fit reads its cut once (eager loop)
            stopped = ckpt is not None and start > 0 and float(state[4]) <= self.tol
            hyper = self._hyper(device)
            loader = CachedEpochLoader(fetch)
            batches = loader.epoch(p % nb for p in range(start, int(self.max_iter)))
            try:
                for p in range(start, int(self.max_iter)):
                    if stopped:
                        break
                    with tracing.span("iteration.epoch", epoch=p, mode="stream"):
                        supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
                        Xk, yk, wk = next(batches)
                        # the eager loop's launch a stream epoch (ROADMAP C.44)
                        with dispatch.timed_dispatch("stream_epoch", start=p, end=p + 1):
                            if ranked:
                                state = _sharded_masked_epoch(mesh, Xk, yk, wk, state,
                                                              loss_func, hyper)
                            else:
                                state = _masked_epoch(Xk, yk, wk, state, loss_func, hyper)
                        if ckpt is not None and (p + 1) % interval == 0:
                            stopped = self._drain_and_snapshot(
                                state, p + 1, meta={**meta, "cacheCursor": (p + 1) % nb},
                                specs=stable_specs or None, stable_sections=stable,
                                mesh=mesh if ranked else None)
                        faults.tick("epoch")
            finally:
                batches.close()
            (host,) = packed_device_get(_finish(state, hyper), sync_kind="fit")
            stats = {**cache.stats, "ingestSeconds": ingest_s,
                     "deviceCache": loader.cache.stats, "restoredCache": restored is not None}
        finally:
            cache.close()
        _, coeff, criteria, epochs = unpack_train_result(host, d)
        # tpulint: disable=spec-consistency -- stats: this rank's own cache, per rank by design
        return coeff, criteria, epochs, stats

    def _drain_and_snapshot(self, state, end: int, meta, specs=None,
                            stable_sections=None, mesh=None, shapes=None) -> bool:
        """A checkpointed chunk's drain: read (epoch, criteria) back, and
        when the fit reached `end` (a boundary) snapshot its carry (on a
        mesh of ranks every rank writes its part of the cut; `shapes` the
        carry leaves' whole shapes). Returns whether the tol stop fired."""
        from ..ckpt import snapshot as _snapshot

        supervisor.pulse_boundary(supervisor.PHASE_COLLECTIVE)
        e_act, crit = packed_device_get(state[3], state[4], sync_kind="drain")
        e_act, crit = int(e_act), float(crit)
        if e_act == end and end % max(1, int(self.checkpoint_interval)) == 0:
            _snapshot.save_job_snapshot(
                self.checkpoint_dir, self.checkpoint_key, {"model": state[:4]},
                epoch=e_act, criteria=crit, specs=specs, meta=meta,
                stable_sections=stable_sections, mesh=mesh,
                shapes=None if shapes is None else {"model": shapes})
        return crit <= self.tol

    def _hyper(self, device) -> torch.Tensor:
        return sgd_hyper(self.learning_rate, self.reg, self.elastic_net, self.tol, device,
                         self._dtype)

    def _batchify(self, mesh, X, y, weights):
        """This rank's rows of the JAX package's batch layout
        (`_batchify`, `:1570`): rows padded to whole batches of B, each
        batch padded to `b_pad` (a multiple of the shards) and split over
        the data axis (`devicecache.data_axis_rows`). Returns (X_b, y_b,
        w_b, y_all): X_b (sparse: both leaves) and w_b hold the
        min(num_batches, maxIter) batches the epochs read, (batches,
        b_local, ...); y_b the same batches' labels; y_all the rank's labels
        of every batch, for the label check. Padding slots have weight 0,
        label 0 and (sparse) index -1. Tensors are gathered on their own
        device, host arrays on the host and then uploaded once."""
        from ..data.devicecache import data_axis_rows, stage_rank_rows

        first = X[0] if isinstance(X, tuple) else X
        device = first.device if isinstance(first, torch.Tensor) else config.device()
        n, B = int(first.shape[0]), int(self.global_batch_size)
        num_batches = max(1, -(-n // B))
        shards = mesh_lib.num_data_shards(mesh)
        rows = data_axis_rows(n, B, shards, mesh.axis_index(mesh_lib.DATA_AXIS), num_batches)
        touched = rows[:min(num_batches, max(1, int(self.max_iter)))]

        def stage(arr, fill, dtype, which):
            if isinstance(arr, torch.Tensor) and arr.device != device:
                raise ValueError(
                    f"training inputs must share one device, got {arr.device} and {device}")
            return stage_rank_rows(arr, which, n, fill, device, dtype)

        dt = self._dtype
        if isinstance(X, tuple):
            X_b = (stage(X[0], -1, torch.int32, touched), stage(X[1], 0, dt, touched))
        else:
            X_b = stage(X, 0, dt, touched)
        if y is None:
            y_all = torch.zeros(rows.shape, dtype=dt, device=device)
        else:
            y_all = stage(y, 0, dt, rows)
        y_b = y_all[:touched.shape[0]]
        if weights is None:
            w_b = to_device(touched >= 0, device, dt)
        else:
            w_b = stage(weights, 0, dt, touched)
        return X_b, y_b, w_b, y_all

    def _optimize_sharded_async(self, mesh, init_coeff, X, y, weights, loss_func,
                                validate_labels):
        """The fit on this rank's rows (`_batchify`): the plain sharded
        loop `_sgd_train_sharded`, with overlap the carry-delayed one, with
        `checkpoint_dir` the sharded epochs in chunks. A feature-sharded
        fit stages its replicated carries through the admitted funnel.
        Returns the packed result, on the device, equal on every rank."""
        from ..obs import memledger
        from ..parallel import dispatch, overlap
        from ..parallel.prefetch import stage_to_device

        X_b, y_b, w_b, y_all = self._batchify(mesh, X, y, weights)
        memledger.track((X_b, y_b, w_b, y_all), "streamSegments")
        device = y_b.device
        grad = None
        if self.shard_features:  # the replicated layout: a whole (d,) carry on every rank
            d = int(np.shape(init_coeff)[0])
            dt = _numpy_dtype(self._dtype)
            init, grad = stage_to_device(
                (_host_coeff(init_coeff, dt), np.zeros(d, dt)), device,
                category="optimizer").wait()
        else:
            init = _stage(init_coeff, self._dtype, device)
        hyper = self._hyper(device)
        max_iter = int(self.max_iter)
        dispatch.whole_fit_plan(start_epoch=0, max_iter=max_iter, ranks=mesh.size)
        overlapped = self._overlap_enabled()
        mode = "overlap" if overlapped else "sharded"
        with tracing.span("iteration.run", mode=mode, epochs=max_iter,
                          ranks=mesh_lib.num_data_shards(mesh)):
            if self.checkpoint_dir is not None:
                return self._optimize_mesh_with_checkpoints(
                    mesh, y_all, _init_state(init, grad), validate_labels, init.shape[0],
                    epochs=lambda st, a, b: _sharded_epochs(mesh, X_b, y_b, w_b, st, loss_func,
                                                            hyper, a, b),
                    finish=lambda st, flag: _finish(st, hyper, flag), specs="replicated")
            if overlapped:
                with dispatch.timed_dispatch("overlapped_sgd_train", start=0, end=max_iter):
                    return overlap.overlapped_sgd_train(mesh, X_b, y_b, w_b, y_all, init,
                                                        loss_func, hyper, max_iter,
                                                        validate_labels)
            with dispatch.timed_dispatch("_sgd_train_sharded", start=0, end=max_iter):
                return _sgd_train_sharded(mesh, X_b, y_b, w_b, y_all, init, loss_func, hyper,
                                          max_iter, validate_labels, grad=grad)

    def _optimize_mesh_with_checkpoints(self, mesh, y_all, state, validate_labels, d: int,
                                        epochs, finish, specs):
        """The checkpointed fit on a mesh of ranks: `epochs(state, start,
        end)` (the sharded or 2D epochs) in chunks that end at the
        checkpoint boundaries, one (epoch, criteria) readback a chunk, a cut
        at each boundary that every rank writes its part of (`specs` the
        carry's tags; leaves of `d` coefficients whole, however sharded),
        and a resume from the newest cut staged onto this mesh by tag, so a
        cut of any rank count or factorization resumes here (meta
        `numBatches`, `globalBatchSize`: another batch layout is refused).
        Returns `finish(state, flag)`: the packed result, on the device."""
        from ..ckpt import snapshot as _snapshot
        from ..parallel import collectives, dispatch

        B = int(self.global_batch_size)
        meta = {"numBatches": int(y_all.shape[0]), "globalBatchSize": B}
        shapes = [(d,), (d,), (), ()]
        planned = 0
        snap = _snapshot.load_job_snapshot(
            self.checkpoint_dir, self.checkpoint_key,
            templates={"model": _carry_template(d, self._dtype)}, expect_meta=meta)
        if snap is not None:
            state, planned = _resumed_state(snap, y_all.device, mesh, specs), snap.epoch
        stopped = planned > 0 and snap.criteria <= self.tol
        interval, max_iter = max(1, int(self.checkpoint_interval)), int(self.max_iter)
        with tracing.span("iteration.run", mode="chunked", chunk=interval, depth=1,
                          ranks=mesh.size):
            while planned < max_iter and not stopped:
                end = min((planned // interval + 1) * interval, max_iter)
                with tracing.span("iteration.chunk", epoch=planned, end=end):
                    supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
                    with dispatch.timed_dispatch("mesh_epochs", start=planned, end=end):
                        state = epochs(state, planned, end)
                stopped = self._drain_and_snapshot(state, end, meta, specs={"model": specs},
                                                   mesh=mesh, shapes=shapes)
                faults.tick("chunk")
                planned = end
        flag = None
        if validate_labels:
            flag = collectives.all_reduce_min(_binomial_labels_ok(y_all), mesh=mesh)
        return finish(state, flag)

    def _optimize_flat_async(self, init_coeff, X, y, weights, loss_func, validate_labels):
        """Stage the inputs (`stage_flat`, the initial coefficient's cast and
        upload: the `sgd.stage` phase) and run `_sgd_train_flat`, or the
        checkpointed chunks."""
        from ..obs import memledger
        from ..parallel import dispatch

        B, dtype = int(self.global_batch_size), self._dtype
        if self.checkpoint_dir is not None:
            with tracing.timed("sgd.stage"):
                X_f, y_f, w_f, n = lazyjit.materialize(stage_flat(X, y, weights, B, dtype=dtype))
                memledger.track((X_f, y_f, w_f), "streamSegments")
                init = _stage(init_coeff, dtype, y_f.device)
            return self._optimize_with_checkpoints(X_f, y_f, w_f, n, init, loss_func,
                                                   validate_labels, self._hyper(y_f.device))
        max_iter = int(self.max_iter)
        with tracing.timed("sgd.stage"):
            X_f, y_f, w_f, n = stage_flat(X, y, weights, B,
                                          rows=lambda nb: _touched_rows(nb, B, max_iter),
                                          dtype=dtype)
            init = _stage(init_coeff, dtype, y_f.device)
        launch = dispatch.timed_dispatch("_sgd_train_flat", start=0, end=max_iter)
        if config.whole_fit == "off":
            with launch:
                return _sgd_train_flat(X_f, y_f, w_f, init, self._hyper(y_f.device), loss_func,
                                       B, n, max_iter, validate_labels)
        account_whole_fit("sgd")
        with tracing.span("iteration.run", mode="whole_fit", epochs=max_iter), launch:
            return _sgd_train_flat(X_f, y_f, w_f, init, self._hyper(y_f.device), loss_func, B, n,
                                   max_iter, validate_labels)

    def _optimize_with_checkpoints(self, X, y, w, n, init, loss_func, validate_labels, hyper):
        """The whole fit's epochs in chunks that end at the checkpoint
        boundaries (every `checkpoint_interval` epochs, and maxIter): one
        (epoch, criteria) readback a chunk, a snapshot of the carry at each
        boundary (meta `numBatches`, `globalBatchSize`: a snapshot of
        another batch layout is refused), the `chunk` fault site ticked at
        each drained chunk, and a resume from the newest snapshot. A fit
        whose tol fires inside a chunk stops there, as the masked whole fit
        does. Returns the whole fit's packed result, on the device."""
        from ..ckpt import snapshot as _snapshot
        from ..parallel import dispatch

        B, d = int(self.global_batch_size), int(init.shape[0])
        meta = {"numBatches": int(y.shape[0]) // B, "globalBatchSize": B}
        state = _init_state(init)
        planned = 0
        snap = _snapshot.load_job_snapshot(
            self.checkpoint_dir, self.checkpoint_key,
            templates={"model": _carry_template(d, init.dtype)}, expect_meta=meta)
        if snap is not None:
            state, planned = _resumed_state(snap, y.device), snap.epoch
        stopped = planned > 0 and snap.criteria <= self.tol
        interval, max_iter = max(1, int(self.checkpoint_interval)), int(self.max_iter)
        with tracing.span("iteration.run", mode="chunked", chunk=interval, depth=1):
            while planned < max_iter and not stopped:
                end = min((planned // interval + 1) * interval, max_iter)
                with tracing.span("iteration.chunk", epoch=planned, end=end):
                    supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
                    with dispatch.timed_dispatch("_sgd_epochs", start=planned, end=end):
                        state = _sgd_epochs(X, y, w, state, loss_func, B, n, planned, end, hyper)
                stopped = self._drain_and_snapshot(state, end, meta)
                faults.tick("chunk")
                planned = end
        flag = _binomial_labels_ok(y) if validate_labels else None
        return _finish(state, hyper, flag)


def _sharded_masked_epoch(mesh, Xk, yk, wk, state, loss_func, hyper):
    """One epoch on this rank's rows of its batch: apply the previous
    reduced gradient, compute the batch's local (gradient, loss, weight)
    sums and reduce them over `data` with ONE all-reduce of [grad | loss |
    weight], so the tol mask (`_masked_epoch`'s) and the next update are
    the same on every rank."""
    from ..parallel import collectives

    coeff, grad, wsum, epochs, criteria = state
    d = coeff.shape[0]
    live = criteria > hyper[HYPER_TOL]
    coeff = _update_model(coeff, grad, wsum, hyper)
    lsum, grad, wsum = loss_func(Xk, yk, wk, coeff)
    summed = collectives.all_reduce_sum(
        torch.cat([grad, lsum.reshape(1).to(grad.dtype), wsum.reshape(1).to(grad.dtype)]),
        mesh=mesh)
    grad, lsum, wsum = summed[:d], summed[d], summed[d + 1]
    criteria_new = (lsum / torch.clamp(wsum, min=1e-30)).to(torch.float32)
    new = (coeff, grad, wsum, epochs + 1, criteria_new)
    return tuple(torch.where(live, n, o) for n, o in zip(new, state))


def _sharded_epochs(mesh, X_b, y_b, w_b, state, loss_func, hyper, start: int, end: int):
    """Epochs [start, end) of the sharded fit on this rank's
    (batches, b_local, ...) rows: epoch e trains batch e mod num_batches."""
    num_batches = y_b.shape[0]
    for e in range(int(start), int(end)):
        k = e % num_batches
        Xk = tuple(leaf[k] for leaf in X_b) if isinstance(X_b, tuple) else X_b[k]
        state = _sharded_masked_epoch(mesh, Xk, y_b[k], w_b[k], state, loss_func, hyper)
    return state


def _sgd_train_sharded(mesh, X_b, y_b, w_b, y_all, init_coeff, loss_func, hyper,
                       max_iter: int, check_labels: bool, grad=None):
    """The bounded fit on this rank's rows (`SGD._batchify`): maxIter
    `_sharded_masked_epoch`s, then the final update. Returns the packed
    result, on the device, equal on every rank."""
    from ..parallel import collectives

    state = _sharded_epochs(mesh, X_b, y_b, w_b, _init_state(init_coeff, grad), loss_func,
                            hyper, 0, max_iter)
    flag = None
    if check_labels:
        flag = collectives.all_reduce_min(_binomial_labels_ok(y_all), mesh=mesh)
    return _finish(state, hyper, flag)


def _host_coeff(init_coeff, dtype=np.float32) -> np.ndarray:
    """An initial coefficient as a host array of `dtype`."""
    if isinstance(init_coeff, torch.Tensor):
        return init_coeff.detach().cpu().numpy().astype(dtype)
    return np.asarray(init_coeff, dtype)


def stage_flat(X, y, weights, batch: int, rows=None, dtype: torch.dtype = COMPUTE_DTYPE):
    """The flat fit's inputs on one device, X's values, y and w in
    `dtype`: host arrays staged to
    `config.device()`, tensors kept on theirs; rows padded to a multiple
    of `batch` (the only case that copies a device input), sparse padding
    rows with index -1. Returns (X, y, w or None, true row count).

    Each host array is budget-admitted (`memledger.admit`, category None)
    before its Feed exists, as the JAX package admits each upload of its
    flat fit: a fit past `config.hbm_budget_bytes` raises
    HbmBudgetExceeded before anything is copied.

    An input that needs a copy (an upload, a cast, padding) comes back as
    a `lazyjit.Feed`, which the program funnel writes straight into its
    graph's buffer; `lazyjit.materialize` makes the tensors for an eager
    caller. `rows(num_batches)`, if given, cuts X and w to the rows the
    fit reads (y stays whole: the label check reads it all)."""
    from ..obs import memledger

    first = X[0] if isinstance(X, tuple) else X
    device = first.device if isinstance(first, torch.Tensor) else config.device()
    n = int(first.shape[0])
    num_batches = max(1, -(-n // batch))
    n_pad = num_batches * batch
    keep = n_pad if rows is None else min(n_pad, int(rows(num_batches)))

    def staged(arr, dtype, fill, cut):
        if isinstance(arr, torch.Tensor) and arr.device != device:
            raise ValueError(
                f"training inputs must share one device, got {arr.device} and {device}")
        total = keep if cut else n_pad
        src = arr[:total]
        shape = (total,) + tuple(np.shape(arr)[1:])
        if isinstance(src, torch.Tensor) and src.dtype == dtype and src.shape[0] == total \
                and src.is_contiguous():
            return src
        if not isinstance(src, torch.Tensor):
            src = np.asarray(src)
            memledger.admit(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize)
        return lazyjit.Feed(src, shape, dtype, device, fill)

    if isinstance(X, tuple):
        X_f = (staged(X[0], torch.int32, -1, True), staged(X[1], dtype, 0, True))
    else:
        X_f = staged(X, dtype, 0, True)
    if y is not None:
        y_f = staged(y, dtype, 0, False)
    else:
        y_f = torch.zeros((n_pad,), dtype=dtype, device=device)
    w_f = None if weights is None else staged(weights, dtype, 0, True)
    return X_f, y_f, w_f, n


def account_whole_fit(kind: str) -> None:
    """One fit run as a whole-fit program (`dispatch.whole_fit`,
    `dispatch.whole_fit.<kind>`: sgd, fleet, lloyd)."""
    from ..utils import metrics

    metrics.inc_counter("dispatch.whole_fit")
    metrics.inc_counter(f"dispatch.whole_fit.{kind}")


# ---------------------------------------------------------------------------
# fleet programs: N fits over one shared batch (fleet.py)
# ---------------------------------------------------------------------------
#
# Port of the fleet programs of flink_ml_tpu/ops/optimizer.py:457-650. The
# JAX package vmaps the member fit over a leading axis; here the axis is
# written out. The batch is shared and never copied N times: the carry
# (coeff, grad, wsum, epochs, criteria), the [N, 5] hyperparameters and
# the outputs carry the member axis, the data does not. The Python loop
# runs the fleet's largest maxIter; a member is live while its criteria
# are above its tol and its epoch count below its own maxIter, and a
# member that is not live keeps its state (the vmapped while_loop's
# select-freeze). While live, a member's epoch count equals the loop
# index, so every member sees its solo batch sequence. Each member's
# arithmetic is the solo fit's, op for op (the proximal factors are
# formed in float64 as the solo `_prox_step` forms them), and a member
# with reg 0 keeps its coefficients exactly (`where(reg > 0, ...)`, as the
# JAX package's `regularize` selects).


class FleetHyper(NamedTuple):
    """A fleet's per-member hyperparameters on the device: `packed` the
    float32 [N, 5] (maxIter, tol, learningRate, reg, elasticNet) rows of
    fleet.py, `prox` the float32 [N, 2] (elasticNet * reg,
    (1 - elasticNet) * reg), formed in float64 as the solo `_prox_step`
    forms them before they scale a tensor."""

    packed: torch.Tensor
    prox: torch.Tensor

    @property
    def max_iter(self) -> torch.Tensor:
        return self.packed[:, 0].to(torch.int32)


def _register_bank_types() -> None:
    from .. import compilebank

    compilebank.register_named_tuple(FleetHyper)


_register_bank_types()


def fleet_hyper(rows, device) -> FleetHyper:
    """FleetHyper from host rows [maxIter, tol, lr, reg, elasticNet]."""
    rows = np.asarray(rows, np.float64).reshape(-1, 5)
    reg, en = rows[:, 3], rows[:, 4]
    prox = np.stack([en * reg, (1.0 - en) * reg], axis=1)
    return FleetHyper(to_device(rows.astype(np.float32), device),
                      to_device(prox.astype(np.float32), device))


def fleet_init_state(members: int, d: int, device, member_minor: bool = False):
    """The fleet carry before the first epoch: (coeff [N, d], grad [N, d],
    wsum [N], epochs [N] int32, criteria [N] = inf). `member_minor` lays
    coeff and grad out as the transpose of a contiguous (d, N), the layout
    in which the fleet kernels read a slot's N coefficients together."""
    def matrix():
        if member_minor:
            return torch.zeros((d, members), dtype=COMPUTE_DTYPE, device=device).T
        return torch.zeros((members, d), dtype=COMPUTE_DTYPE, device=device)

    return (
        matrix(),
        matrix(),
        torch.zeros((members,), dtype=COMPUTE_DTYPE, device=device),
        torch.zeros((members,), dtype=torch.int32, device=device),
        torch.full((members,), float("inf"), dtype=torch.float32, device=device),
    )


def _fleet_update(coeff, grad, wsum, hyper: FleetHyper):
    """`_update_model` for every member at once: coeff -= lr / wsum * grad,
    then the proximal step where reg > 0, only where wsum > 0."""
    lr, reg = hyper.packed[:, 2:3], hyper.packed[:, 3:4]
    # lr / t is t.reciprocal() * lr for a Python lr: the solo form's bits
    updated = coeff - (torch.reciprocal(torch.clamp(wsum, min=1e-30))[:, None] * lr) * grad
    step = lr * (hyper.prox[:, 0:1] * torch.sign(updated) + hyper.prox[:, 1:2] * updated)
    updated = torch.where(reg > 0.0, updated - step, updated)
    return torch.where((wsum > 0)[:, None], updated, coeff)


def _fleet_masked_epoch(Xk, yk, wk, state, loss_func, hyper: FleetHyper, max_iter):
    """`_masked_epoch` for every member: the epoch runs for all, and a
    member that is not live (criteria <= tol, or its own maxIter reached)
    keeps its state."""
    coeff, grad, wsum, epochs, criteria = state
    live = (criteria > hyper.packed[:, 1]) & (epochs < max_iter)
    new_coeff = _fleet_update(coeff, grad, wsum, hyper)
    lsum, new_grad, new_wsum = loss_func(Xk, yk, wk, new_coeff)
    new_criteria = (lsum / torch.clamp(new_wsum, min=1e-30)).to(torch.float32)
    rows = live[:, None]
    return (
        torch.where(rows, new_coeff, coeff),
        torch.where(rows, new_grad, grad),
        torch.where(live, new_wsum, wsum),
        torch.where(live, epochs + 1, epochs),
        torch.where(live, new_criteria, criteria),
    )


def _fleet_member_finish(state, hyper: FleetHyper, flag=None):
    """Every member's post-loop tail: the one extra update and its result
    row [flag?, coeff, criteria, epochs] -> [N, flag? + d + 2] float32,
    one packed tensor for one readback. `flag` (the label check, computed
    once for the shared labels) goes into every row."""
    coeff, grad, wsum, epochs, criteria = state
    coeff = _fleet_update(coeff, grad, wsum, hyper)
    parts = [coeff, criteria[:, None], epochs[:, None].to(coeff.dtype)]
    if flag is not None:
        parts.insert(0, flag.reshape(1, 1).expand(coeff.shape[0], 1))
    return torch.cat(parts, dim=1)


def _fleet_sharded_masked_epoch(mesh, Xk, yk, wk, state, loss_func, hyper: FleetHyper,
                                max_iter):
    """`_fleet_masked_epoch` on this rank's rows of its batch (the default
    regime on a mesh of ranks): every member's local (gradient, loss,
    weight) sums reduce over `data` by the member's own all-reduce of
    [grad | loss | weight], the solo sharded epoch's reduce
    (`_sharded_masked_epoch`), so a member equals its solo fit on the same
    mesh bit for bit where the local sums do. No reduce adds across
    members. The gradient keeps coeff's layout (member-minor for the
    kernels)."""
    from ..parallel import collectives

    coeff, grad, wsum, epochs, criteria = state
    members, d = coeff.shape
    live = (criteria > hyper.packed[:, 1]) & (epochs < max_iter)
    new_coeff = _fleet_update(coeff, grad, wsum, hyper)
    lsum, g, w_sum = loss_func(Xk, yk, wk, new_coeff)
    grads, sums = [], []
    for m in range(members):
        summed = collectives.all_reduce_sum(
            torch.cat([g[m], lsum[m].reshape(1).to(g.dtype), w_sum.reshape(1).to(g.dtype)]),
            mesh=mesh)
        grads.append(summed[:d])
        sums.append(summed[d:])
    member_minor = members > 1 and coeff.stride(0) == 1
    new_grad = torch.stack(grads, dim=1).T if member_minor else torch.stack(grads)
    sums = torch.stack(sums)
    new_wsum = sums[:, 1]
    new_criteria = (sums[:, 0] / torch.clamp(new_wsum, min=1e-30)).to(torch.float32)
    rows = live[:, None]
    return (
        torch.where(rows, new_coeff, coeff),
        torch.where(rows, new_grad, grad),
        torch.where(live, new_wsum, wsum),
        torch.where(live, epochs + 1, epochs),
        torch.where(live, new_criteria, criteria),
    )


def _sgd_fleet_sharded_chunk(mesh, X_b, y_b, w_b, state, loss_func, hyper: FleetHyper,
                             start: int, end: int):
    """Epochs [start, end) of the default-regime fleet on a mesh of ranks,
    over this rank's (batches, b_local, ...) rows (`SGD._batchify`)."""
    num_batches = y_b.shape[0]
    max_iter = hyper.max_iter
    for e in range(int(start), int(end)):
        k = e % num_batches
        Xk = tuple(leaf[k] for leaf in X_b) if isinstance(X_b, tuple) else X_b[k]
        state = _fleet_sharded_masked_epoch(mesh, Xk, y_b[k], w_b[k], state, loss_func, hyper,
                                            max_iter)
    return state


def _sgd_fleet_chunk(X, y, w, state, loss_func, hyper: FleetHyper, batch: int, n: int,
                     start: int, end: int):
    """Epochs [start, end) of the fleet fit over the flat, batch-padded data
    of one fit (`stage_flat`): every member to its own maxIter or tol (a
    member whose budget ends inside the chunk freezes there). The whole
    fit is this from 0 to the largest maxIter; the checkpointed fleet runs
    it chunk by chunk."""
    num_batches = y.shape[0] // batch
    max_iter = hyper.max_iter
    for e in range(start, end):
        begin = (e % num_batches) * batch
        Xk = _slice_rows(X, begin, batch)
        yk = y[begin : begin + batch]
        if w is not None:
            wk = w[begin : begin + batch]
        else:
            wk = (torch.arange(begin, begin + batch, device=y.device) < n).to(state[0].dtype)
        state = _fleet_masked_epoch(Xk, yk, wk, state, loss_func, hyper, max_iter)
    return state


@lazyjit.lazy_jit(static_argnames=("loss_func", "gmax", "batch", "n", "check_labels"),
                  ledger="streamSegments", borrow=("X", "y", "w"))
def _sgd_fleet_whole_fit(X, y, w, state, loss_func, hyper: FleetHyper, gmax: int, batch: int,
                         n: int, check_labels: bool):
    """N whole bounded fits: `gmax` (the largest maxIter, a host int)
    epochs of `_sgd_fleet_chunk`, then the packed [N, flag? + d + 2]
    result, on the device; one program of the funnel (X and w may hold
    only the batches the epochs read). The {0,1} label flag is computed
    once, for the shared labels."""
    state = _sgd_fleet_chunk(X, y, w, state, loss_func, hyper, batch, n, 0, gmax)
    flag = _binomial_labels_ok(y) if check_labels else None
    return _fleet_member_finish(state, hyper, flag)


@lazyjit.lazy_jit
def _sgd_fleet_final(state, hyper: FleetHyper):
    """The fleet's finish without a label flag -> [N, d + 2]."""
    return _fleet_member_finish(state, hyper)


def _sgd_fleet_stream_whole_fit(segments, layout: StreamLayout, state, loss_func,
                                hyper: FleetHyper, gmax: int):
    """N out-of-core fits over the stream's segments stacked once on the
    device (`segments` [nb, layout.size], each a packed [X | y | w] batch):
    epoch e trains on segment e mod nb for `gmax` epochs, every member to
    its own maxIter or tol. Returns the packed [N, d + 2] result."""
    nb = segments.shape[0]
    max_iter = hyper.max_iter
    for e in range(gmax):
        Xk, yk, wk = layout.views(segments[e % nb])
        state = _fleet_masked_epoch(Xk, yk, wk, state, loss_func, hyper, max_iter)
    return _sgd_fleet_final(state, hyper)


def unpack_fleet_train_result(host: np.ndarray, d: int, has_flag: bool = False):
    """Host-side inverse of the fleet result pack ([N, flag? + d + 2],
    `_fleet_member_finish` rows): returns (flags_or_None, coeff [N, d],
    criteria [N], epochs [N])."""
    host = np.asarray(host)
    off = 1 if has_flag else 0
    flags = host[:, 0] if has_flag else None
    return flags, host[:, off : off + d], host[:, -2], host[:, -1].astype(np.int64)
