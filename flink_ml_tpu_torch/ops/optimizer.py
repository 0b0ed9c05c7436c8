"""Mini-batch SGD: the training engine for linear models, on one device.

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
packed result. Hyperparameters are host floats; they enter float32 device
arithmetic as scalars, as the JAX package's packed f32 hyper vector does.

`SGD.optimize_stream` trains on a stream of host chunks, out of core: it
caches the stream once in the native data cache and replays one batch an
epoch through the device epoch cache, with the same epoch arithmetic
(`_masked_epoch`), so it equals the bounded fit of the same rows.

Checkpointing, feature sharding, overlapped collectives and more than one
device are later ROADMAP items and raise NotImplementedError.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import config
from .losses import LossFunc

#: the fit's compute dtype: host float64 columns are cast to it once, at staging
COMPUTE_DTYPE = torch.float32


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


def _update_model(coeff, grad, wsum, lr, reg, elastic_net):
    """coeff -= lr / wsum * grad, then the proximal step, only where
    wsum > 0 (a device-side select: no host sync)."""
    updated = coeff - (lr / torch.clamp(wsum, min=1e-30)) * grad
    updated = _prox_step(updated, reg, elastic_net, lr)
    return torch.where(wsum > 0, updated, coeff)


def _binomial_labels_ok(y):
    """{0,1} label validity flag (LogisticRegression.java:78-87), carried in
    the fit's packed readback. Padding rows have label 0 and pass."""
    return torch.all((y == 0.0) | (y == 1.0)).to(torch.float32)


def _epoch_step(Xk, yk, wk, carry, loss_func, lr, reg, elastic_net):
    """One epoch: apply the previous gradient, compute the next on this
    epoch's batch. Returns (carry, criteria)."""
    coeff, grad, wsum, epoch = carry
    coeff = _update_model(coeff, grad, wsum, lr, reg, elastic_net)
    lsum, grad, wsum = loss_func(Xk, yk, wk, coeff)
    criteria = (lsum / torch.clamp(wsum, min=1e-30)).to(torch.float32)
    return (coeff, grad, wsum, epoch + 1), criteria


def _slice_rows(X, start, rows):
    if isinstance(X, tuple):
        return tuple(leaf[start : start + rows] for leaf in X)
    return X[start : start + rows]


def _pack_train_result(coeff, criteria, epochs, flag=None):
    """(flag?, coeff, criteria, epochs) as ONE flat vector, so the host
    reads everything back in a single transfer. float32 holds the epoch
    count exactly."""
    parts = [coeff, criteria.reshape(1), epochs.reshape(1).to(COMPUTE_DTYPE)]
    if flag is not None:
        parts.insert(0, flag.reshape(1))
    return torch.cat(parts)


def _init_state(init_coeff):
    """(coeff, grad, wsum, epochs, criteria) before the first epoch."""
    device = init_coeff.device
    return (
        init_coeff,
        torch.zeros_like(init_coeff),
        torch.zeros((), dtype=init_coeff.dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.full((), float("inf"), dtype=torch.float32, device=device),
    )


def _masked_epoch(Xk, yk, wk, state, tol, loss_func, lr, reg, elastic_net):
    """`_epoch_step` under the device-side tol mask: once the criteria are
    <= tol, the state is kept as it was. While the fit is live, the device
    epoch count equals the host's epoch index, so the host knows the batch."""
    live = state[4] > tol
    carry, criteria = _epoch_step(Xk, yk, wk, state[:4], loss_func, lr, reg, elastic_net)
    return tuple(torch.where(live, new, old) for new, old in zip((*carry, criteria), state))


def _finish(state, lr, reg, elastic_net, flag=None):
    """The update after the loop, packed with the criteria and epochs."""
    coeff, grad, wsum, epochs, criteria = state
    coeff = _update_model(coeff, grad, wsum, lr, reg, elastic_net)
    return _pack_train_result(coeff, criteria, epochs, flag)


def _sgd_train_flat(X, y, w, init_coeff, loss_func, batch, n, max_iter, tol,
                    lr, reg, elastic_net, check_labels):
    """The whole bounded fit on flat, batch-padded device tensors; each
    epoch's batch is a row slice. `w` None synthesizes `row < n` weights.
    Returns the packed result tensor, on the device."""
    num_batches = y.shape[0] // batch
    device = y.device
    state = _init_state(init_coeff)
    for e in range(max_iter):
        start = (e % num_batches) * batch
        Xk = _slice_rows(X, start, batch)
        yk = y[start : start + batch]
        if w is not None:
            wk = w[start : start + batch]
        else:
            wk = (torch.arange(start, start + batch, device=device) < n).to(init_coeff.dtype)
        state = _masked_epoch(Xk, yk, wk, state, tol, loss_func, lr, reg, elastic_net)
    flag = _binomial_labels_ok(y) if check_labels else None
    return _finish(state, lr, reg, elastic_net, flag)


class StreamLayout(NamedTuple):
    """Where one packed stream segment keeps its parts: a flat float32
    array of the blocks X (batch x d, row-major), y (batch) and w (batch),
    each starting at a multiple of BLOCK_ALIGN elements, so every part is a
    contiguous, aligned view of the segment on the device too."""

    batch: int
    d: int

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
        """(X, y, w) views of a flat segment (numpy or torch)."""
        B, d = self.batch, self.d
        return (flat[: B * d].reshape(B, d), flat[self.y_offset : self.y_offset + B],
                flat[self.w_offset : self.w_offset + B])


BLOCK_ALIGN = 64


def _round_up(n: int) -> int:
    return -(-n // BLOCK_ALIGN) * BLOCK_ALIGN


def ingest_stream(chunks: Iterable, batch: int, cache) -> Tuple[List[int], StreamLayout]:
    """One pass over host (X, y, w) chunks into `cache`: rows are re-cut
    into `batch`-row batches, the remainder carried from chunk to chunk, and
    each batch is appended as one packed float32 segment (`StreamLayout`).
    A missing w is 1; the last partial batch is padded with weight-0 rows.
    Returns (segment ids, layout)."""
    segs: List[int] = []
    layout = flat = None
    filled = 0
    for X, y, w in chunks:
        X = np.asarray(X)
        if layout is None:
            layout = StreamLayout(int(batch), int(X.shape[1]))
            flat = np.zeros(layout.size, np.float32)
            Xb, yb, wb = layout.views(flat)
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
                segs.append(cache.append_array(flat))
                filled = 0
    if filled:
        Xb[filled:], yb[filled:], wb[filled:] = 0.0, 0.0, 0.0
        segs.append(cache.append_array(flat))
    if not segs:
        raise ValueError("optimize_stream received an empty stream")
    return segs, layout


def unpack_train_result(host: np.ndarray, d: int, has_flag: bool = False):
    """Host-side inverse of `_pack_train_result`: returns
    (flag_or_None, coeff[:d], criteria, epochs)."""
    flag = float(host[0]) if has_flag else None
    off = 1 if has_flag else 0
    return flag, host[off : off + d], float(host[-2]), int(host[-1])


def read_train_result(async_result):
    """Bring an `optimize_async` result to the host in one transfer.
    Returns (flag_or_None, coeff[:d], criteria, epochs)."""
    _, packed, d, has_flag = async_result
    host = packed.cpu().numpy()
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
    return torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)


@dataclass
class SGD:
    """Mini-batch SGD (common/optimizer/SGD.java) on one device."""

    max_iter: int = 20
    learning_rate: float = 0.1
    global_batch_size: int = 32
    tol: float = 1e-6
    reg: float = 0.0
    elastic_net: float = 0.0
    checkpoint_dir: Optional[str] = None
    shard_features: bool = False
    collective_overlap: Optional[bool] = None

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
        device, and all tensor inputs must share one."""
        self._check_single_device(mesh)
        d = int(np.shape(init_coeff)[0])
        packed = self._optimize_flat_async(init_coeff, X, y, weights, loss_func, validate_labels)
        return ("packed", packed, d, validate_labels)

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
        the same). Returns (coefficient, final_loss, num_epochs, stats)."""
        from ..data.devicecache import CachedEpochLoader
        from ..native.datacache import DataCache
        from ..parallel.prefetch import DeviceStager

        self._check_single_device(mesh)
        device = config.device()
        cache = DataCache(
            config.datacache_memory_budget_bytes if memory_budget_bytes is None
            else memory_budget_bytes,
            config.datacache_spill_dir if spill_dir is None else spill_dir,
        )
        try:
            t0 = time.perf_counter()
            segs, layout = ingest_stream(chunks, int(self.global_batch_size), cache)
            ingest_s = time.perf_counter() - t0
            d, nb = layout.d, len(segs)
            stager = DeviceStager(device)
            seg_bytes = layout.size * 4

            def fetch(k):
                staged = stager.stage(seg_bytes, lambda host: cache.read_into(segs[k], host.numpy()))
                staged.value = layout.views(staged.value.view(torch.float32))
                return staged

            init = np.zeros(d) if init_coeff is None else init_coeff
            state = _init_state(_stage(init, COMPUTE_DTYPE, device))
            lr, reg, en = float(self.learning_rate), float(self.reg), float(self.elastic_net)
            loader = CachedEpochLoader(fetch)
            batches = loader.epoch(p % nb for p in range(int(self.max_iter)))
            try:
                for Xk, yk, wk in batches:
                    state = _masked_epoch(Xk, yk, wk, state, float(self.tol), loss_func, lr, reg, en)
            finally:
                batches.close()
            host = _finish(state, lr, reg, en).cpu().numpy()
            stats = {**cache.stats, "ingestSeconds": ingest_s,
                     "deviceCache": loader.cache.stats}
        finally:
            cache.close()
        _, coeff, criteria, epochs = unpack_train_result(host, d)
        return coeff, criteria, epochs, stats

    def _check_single_device(self, mesh) -> None:
        if mesh is not None:
            raise NotImplementedError("multi-GPU training is not ported yet (ROADMAP A.10)")
        config.check_no_checkpoint(self.checkpoint_dir)
        if self.shard_features or self.collective_overlap:
            raise NotImplementedError(
                "feature sharding and overlapped collectives are not ported yet (ROADMAP A.10)"
            )

    def _optimize_flat_async(self, init_coeff, X, y, weights, loss_func, validate_labels):
        """Stage the inputs, pad rows to a batch multiple (the only case
        that copies a device input) and run `_sgd_train_flat`."""
        first = X[0] if isinstance(X, tuple) else X
        device = first.device if isinstance(first, torch.Tensor) else config.device()
        n = int(first.shape[0])
        B = int(self.global_batch_size)
        num_batches = max(1, -(-n // B))
        n_pad = num_batches * B
        if isinstance(X, tuple):
            X_f = (_stage(X[0], torch.int32, device), _stage(X[1], COMPUTE_DTYPE, device))
        else:
            X_f = _stage(X, COMPUTE_DTYPE, device)
        y_f = (
            _stage(y, COMPUTE_DTYPE, device)
            if y is not None
            else torch.zeros((n,), dtype=COMPUTE_DTYPE, device=device)
        )
        w_f = None if weights is None else _stage(weights, COMPUTE_DTYPE, device)
        if n_pad != n:
            pad = n_pad - n
            if isinstance(X_f, tuple):
                X_f = (
                    torch.nn.functional.pad(X_f[0], (0, 0, 0, pad), value=-1),
                    torch.nn.functional.pad(X_f[1], (0, 0, 0, pad)),
                )
            else:
                X_f = torch.nn.functional.pad(X_f, (0, 0, 0, pad))
            y_f = torch.nn.functional.pad(y_f, (0, pad))
            if w_f is not None:
                w_f = torch.nn.functional.pad(w_f, (0, pad))
        if isinstance(X_f, tuple):
            X_f = tuple(leaf.contiguous() for leaf in X_f)
        init = _stage(init_coeff, COMPUTE_DTYPE, device)
        return _sgd_train_flat(
            X_f, y_f, w_f, init, loss_func, B, n, int(self.max_iter), float(self.tol),
            float(self.learning_rate), float(self.reg), float(self.elastic_net),
            validate_labels,
        )
