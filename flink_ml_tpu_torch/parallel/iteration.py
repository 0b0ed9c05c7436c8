"""Bounded and unbounded iteration.

Port of flink_ml_tpu/parallel/iteration.py (`:38-58`, `:144-380`,
`:384-471`; the reference's Iterations.java, TerminateOnMaxIterOrTol.java:72,
IterationListener.java:75):

- `iterate_bounded(body, init_carry, max_iter, tol)` runs
  `body(carry, epoch) -> (carry, criteria)` until `epoch >= max_iter` or
  `criteria <= tol`. Without a listener it runs max_iter epochs with the tol
  stop as a device-side mask: once the criteria reach tol every later
  update is `torch.where`'d away, and the epoch count and criteria are read
  back once at the end (as the SGD engine's `_sgd_train_flat` does). A
  listener forces the host-driven loop, one epoch and one readback at a
  time, with a callback after each epoch.
- `iterate_unbounded(batches, step, init_state)` advances the state by one
  step per incoming batch and yields `(version, state)` after each, from
  version 1 on (the online estimators' model versions). It is lazy: no
  batch is read before the first `next`.

A carry is a tensor or a tuple of carries.

Checkpoints (`:61-141`, `:223-360`, `:384-470`): with a checkpoint
directory, `iterate_bounded` runs the same masked epochs cut into chunks
that end at the checkpoint boundaries (every `checkpoint_interval` epochs),
reads (epoch, criteria) back once a chunk, snapshots the carry
(ckpt/snapshot.py, section `model`) at each boundary, ticks the `chunk`
fault site and resumes from the newest snapshot; the chunk cut changes no
arithmetic, so a checkpointed run equals the unchecked one bit for bit.
`iterate_unbounded` snapshots (state, version) at global-batch boundaries
(the explicit arguments, else `config.iteration_checkpoint_dir`), resumes
by skipping the replayed prefix after republishing the restored version,
and removes the job's snapshot when the stream completes.
`checkpoint_job_key` names a job's files as the JAX package does, so
either package resumes the other's snapshot.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..ckpt import faults
from . import supervisor

BodyFn = Callable[[Any, int], Tuple[Any, torch.Tensor]]


class IterationListener:
    """Per-epoch callbacks (IterationListener.java:75). A listener forces
    the host-driven loop of `iterate_bounded`."""

    def on_epoch_watermark_incremented(self, epoch: int, carry) -> None:
        ...

    def on_iteration_terminated(self, carry) -> None:
        ...


@dataclass
class IterationResult:
    carry: Any
    num_epochs: int
    final_criteria: float


# ---------------------------------------------------------------------------
# checkpointing: epoch-boundary snapshots of the carry
# ---------------------------------------------------------------------------

def checkpoint_job_key(stage, exclude=("maxIter", "tol")) -> str:
    """The job identity that namespaces checkpoint files: the class name
    and a hash of the stage's params, each as its `json_encode` gives it
    (the JAX package's key for the same params). `maxIter` and `tol` are
    left out: resuming with a larger maxIter is the same job."""
    params = {}
    for p, v in stage.get_param_map().items():
        if p.name in exclude:
            continue
        try:
            params[p.name] = p.json_encode(v)
        except Exception:
            params[p.name] = repr(v)
    blob = json.dumps(params, sort_keys=True, default=repr)
    digest = hashlib.sha1(blob.encode()).hexdigest()[:10]
    return f"{type(stage).__name__}-{digest}"


def _checkpoint_file(path: str, job_key: Optional[str]) -> str:
    if job_key is None:
        return os.path.join(path, "ckpt.npz")
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", job_key)
    return os.path.join(path, f"ckpt-{safe}.npz")


def save_iteration_checkpoint(path: str, carry, epoch: int, criteria: float,
                              job_key: Optional[str] = None) -> None:
    """The legacy carry-only writer (`ckpt-*.npz`), kept for direct users
    and as the migration source: the loops write JobSnapshots, whose
    loader also reads this format. The carry's tensors come back in one
    packed copy."""
    from ..ckpt.snapshot import tree_flatten
    from ..utils.packing import packed_bytes_get

    leaves = packed_bytes_get(*tree_flatten(carry)[0], sync_kind="checkpoint")
    os.makedirs(path, exist_ok=True)
    target = _checkpoint_file(path, job_key)
    tmp = target[: -len(".npz")] + ".tmp.npz"  # keep .npz so savez won't rename
    np.savez(tmp, epoch=np.int64(epoch), criteria=np.float64(criteria),
             **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    os.replace(tmp, target)


def load_iteration_checkpoint(path: str, carry_like, job_key: Optional[str] = None):
    """(carry, epoch, criteria) from `path` as host arrays, or None when
    absent or structurally incompatible; reads the JobSnapshot first, then
    the legacy file."""
    from ..ckpt import snapshot as _snapshot

    snap = _snapshot.load_job_snapshot(path, job_key, templates={"model": carry_like})
    if snap is None:
        return None
    return snap.sections["model"], snap.epoch, snap.criteria


def next_boundary(epoch: int, interval: Optional[int]) -> Optional[int]:
    """The first checkpoint boundary strictly after `epoch` (None without
    checkpointing)."""
    if not interval or interval <= 0:
        return None
    return (epoch // interval + 1) * interval


def _carry_device(carry) -> torch.device:
    from ..ckpt.snapshot import tree_flatten

    for leaf in tree_flatten(carry)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return config.device()


def _restored_carry(snap, init_carry):
    """The snapshot's `model` section shaped as `init_carry`: the leaves
    that are tensors there go to the carry's device in one copy, the
    others stay host values of their template's type."""
    from ..ckpt.snapshot import stage_leaves, tree_flatten, tree_unflatten

    host, treedef = tree_flatten(snap.sections["model"])
    init_leaves = tree_flatten(init_carry)[0]
    on_device = [i for i, leaf in enumerate(init_leaves) if isinstance(leaf, torch.Tensor)]
    leaves = [type(want)(np.asarray(got).item()) if isinstance(want, (int, float)) else got
              for want, got in zip(init_leaves, host)]
    staged = stage_leaves([host[i] for i in on_device], _carry_device(init_carry))
    for i, t in zip(on_device, staged):
        leaves[i] = t
    return tree_unflatten(treedef, leaves)


def _select(live, new, old):
    if isinstance(new, tuple):
        return tuple(_select(live, n, o) for n, o in zip(new, old))
    return torch.where(live, new, old)


def iterate_bounded(
    body: BodyFn,
    init_carry,
    max_iter: int,
    tol: Optional[float] = None,
    listener: Optional[IterationListener] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_interval: int = 1,
    chunk_size: Optional[int] = None,
    job_key: Optional[str] = None,
) -> IterationResult:
    """Run `body` until max_iter epochs or `criteria <= tol`; with
    `checkpoint_dir`, in chunks that snapshot the carry at every
    `checkpoint_interval`-th epoch and resume from the newest snapshot. A
    chunk ends at the next boundary, or after `chunk_size` epochs when
    that comes first (one readback a chunk)."""
    if listener is None and checkpoint_dir is None:
        return _iterate_on_device(body, init_carry, max_iter, tol)
    if listener is None:
        return _iterate_checkpointed(body, init_carry, max_iter, tol, checkpoint_dir,
                                     max(1, int(checkpoint_interval)), job_key, chunk_size)
    return _iterate_host_driven(body, init_carry, max_iter, tol, listener, checkpoint_dir,
                                max(1, int(checkpoint_interval)), job_key)


def _masked_epochs(body: BodyFn, carry, epochs, criteria, start: int, end: int, tol_value):
    """Epochs [start, end) of the masked loop: once the criteria reach tol
    every update is `torch.where`'d away. `epochs` None is a fresh loop,
    whose first epoch always runs."""
    for e in range(start, end):
        new_carry, crit = body(carry, e)
        crit = torch.as_tensor(crit).to(torch.float32)
        if epochs is None:
            epochs = torch.ones((), dtype=torch.int32, device=crit.device)
            carry, criteria = new_carry, crit
            continue
        live = criteria > tol_value
        carry = _select(live, new_carry, carry)
        epochs = torch.where(live, epochs + 1, epochs)
        criteria = torch.where(live, crit, criteria)
    return carry, epochs, criteria


def _iterate_on_device(body: BodyFn, init_carry, max_iter: int, tol: Optional[float]):
    """max_iter epochs, each masked once the criteria reach tol; while the
    loop is live the device's epoch count equals the host's `e`, which the
    body receives. One readback of (epochs, criteria)."""
    tol_value = float("-inf") if tol is None else float(tol)
    carry, epochs, criteria = _masked_epochs(body, init_carry, None, None, 0, max_iter, tol_value)
    if epochs is None:
        return IterationResult(carry, 0, float("inf"))
    host = torch.stack([epochs.to(torch.float64), criteria.to(torch.float64)]).cpu()
    return IterationResult(carry, int(host[0]), float(host[1]))


def _iterate_checkpointed(body, init_carry, max_iter, tol, checkpoint_dir, interval, job_key,
                          chunk_size=None):
    """The masked loop cut into chunks that end at checkpoint boundaries,
    one (epoch, criteria) readback a chunk: the same calls as
    `_iterate_on_device`, so the same bits."""
    from ..ckpt import snapshot as _snapshot
    from ..utils.packing import packed_device_get

    tol_value = float("-inf") if tol is None else float(tol)
    carry, epochs, criteria = init_carry, None, None
    final_epoch, final_crit = 0, float("inf")
    snap = _snapshot.load_job_snapshot(checkpoint_dir, job_key, templates={"model": init_carry})
    if snap is not None:
        carry = _restored_carry(snap, init_carry)
        device = _carry_device(carry)
        final_epoch, final_crit = snap.epoch, snap.criteria
        epochs = torch.tensor(final_epoch, dtype=torch.int32, device=device)
        criteria = torch.tensor(final_crit, dtype=torch.float32, device=device)
    stopped = tol is not None and final_crit <= tol
    planned = final_epoch
    while planned < max_iter and not stopped:
        end = min(next_boundary(planned, interval), max_iter,
                  planned + max(1, int(chunk_size or max_iter)))
        supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
        carry, epochs, criteria = _masked_epochs(body, carry, epochs, criteria, planned, end,
                                                 tol_value)
        supervisor.pulse_boundary(supervisor.PHASE_COLLECTIVE)
        e_act, crit = packed_device_get(epochs, criteria, sync_kind="drain")
        e_act, crit = int(e_act), float(crit)
        advanced = e_act > final_epoch
        final_epoch, final_crit = e_act, crit
        if advanced and e_act == end and e_act % interval == 0:
            _snapshot.save_job_snapshot(checkpoint_dir, job_key, {"model": carry},
                                        epoch=e_act, criteria=crit)
        if tol is not None and crit <= tol:
            stopped = True
        faults.tick("chunk")
        planned = end
    return IterationResult(carry, final_epoch, final_crit)


def _iterate_host_driven(body, init_carry, max_iter, tol, listener, checkpoint_dir=None,
                         interval=1, job_key=None):
    from ..ckpt import snapshot as _snapshot

    carry, epoch, criteria = init_carry, 0, float("inf")
    if checkpoint_dir is not None:
        snap = _snapshot.load_job_snapshot(checkpoint_dir, job_key,
                                           templates={"model": init_carry})
        if snap is not None:
            carry, epoch, criteria = _restored_carry(snap, init_carry), snap.epoch, snap.criteria
    while epoch < max_iter and (tol is None or criteria > tol):
        supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
        carry, crit = body(carry, epoch)
        epoch += 1
        supervisor.pulse_boundary(supervisor.PHASE_COLLECTIVE)
        criteria = float(crit)
        listener.on_epoch_watermark_incremented(epoch, carry)
        if checkpoint_dir is not None:
            if epoch % interval == 0:
                _snapshot.save_job_snapshot(checkpoint_dir, job_key, {"model": carry},
                                            epoch=epoch, criteria=criteria)
            faults.tick("chunk")
    listener.on_iteration_terminated(carry)
    return IterationResult(carry, epoch, criteria)


def iterate_unbounded(
    batches: Iterable,
    step: Callable[[Any, Any], Any],
    init_state,
    listener: Optional[IterationListener] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_interval: Optional[int] = None,
    job_key: Optional[str] = None,
) -> Iterator[Tuple[int, Any]]:
    """The online loop (Iterations.iterateUnboundedStreams:118-131): one
    step per global batch, a new model version after each.

    With a checkpoint directory (the argument, else
    `config.iteration_checkpoint_dir`), (state, version) is snapshotted
    every `checkpoint_interval` versions (an explicit interval wins over
    the config's), the version doubling as the stream offset in global
    batches (`streamOffset` in meta). A resume republishes the restored
    version first, then skips that many batches of the replayed source. A
    completed stream removes the job's snapshot files."""

    def run(checkpoint_dir=checkpoint_dir):
        from ..ckpt import snapshot as _snapshot

        # resolved at the first batch, as the JAX package's generator does
        if checkpoint_dir is None:
            checkpoint_dir = config.iteration_checkpoint_dir
            interval = checkpoint_interval or config.iteration_checkpoint_interval
        else:
            interval = checkpoint_interval or 1
        state, version = init_state, 0
        if checkpoint_dir is not None:
            snap = _snapshot.load_job_snapshot(checkpoint_dir, job_key,
                                               templates={"model": init_state})
            if snap is not None:
                state, version = _restored_carry(snap, init_state), snap.epoch
                # the restored model is published before the next live batch
                yield version, state
        skip = version
        for batch in batches:
            if skip > 0:  # the replayed prefix is already in the snapshot
                skip -= 1
                continue
            state = step(state, batch)
            version += 1
            if listener is not None:
                listener.on_epoch_watermark_incremented(version, state)
            if checkpoint_dir is not None and version % interval == 0:
                _snapshot.save_job_snapshot(checkpoint_dir, job_key, {"model": state},
                                            epoch=version, meta={"streamOffset": version})
            faults.tick("batch")
            yield version, state
        if checkpoint_dir is not None:
            from ..ckpt import coordinator

            for file in (_snapshot.snapshot_file(checkpoint_dir, job_key),
                         _checkpoint_file(checkpoint_dir, job_key)):
                if os.path.exists(file):
                    os.remove(file)
            coordinator.purge(checkpoint_dir, job_key)
        if listener is not None:
            listener.on_iteration_terminated(state)

    return run()
