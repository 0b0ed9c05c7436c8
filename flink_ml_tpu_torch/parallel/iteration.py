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

A carry is a tensor or a tuple of carries. Checkpoints are not ported
(ROADMAP A.13): a checkpoint argument, or `config.iteration_checkpoint_dir`,
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import torch

from .. import config

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
) -> IterationResult:
    """Run `body` until max_iter epochs or `criteria <= tol`."""
    config.check_no_checkpoint(checkpoint_dir)
    if listener is None:
        return _iterate_on_device(body, init_carry, max_iter, tol)
    return _iterate_host_driven(body, init_carry, max_iter, tol, listener)


def _iterate_on_device(body: BodyFn, init_carry, max_iter: int, tol: Optional[float]):
    """max_iter epochs, each masked once the criteria reach tol; while the
    loop is live the device's epoch count equals the host's `e`, which the
    body receives. One readback of (epochs, criteria)."""
    tol_value = float("-inf") if tol is None else float(tol)
    carry = init_carry
    epochs = criteria = None
    for e in range(max_iter):
        new_carry, crit = body(carry, e)
        crit = torch.as_tensor(crit).to(torch.float32)
        if epochs is None:  # the first epoch always runs
            epochs = torch.ones((), dtype=torch.int32, device=crit.device)
            carry, criteria = new_carry, crit
            continue
        live = criteria > tol_value
        carry = _select(live, new_carry, carry)
        epochs = torch.where(live, epochs + 1, epochs)
        criteria = torch.where(live, crit, criteria)
    if epochs is None:
        return IterationResult(carry, 0, float("inf"))
    host = torch.stack([epochs.to(torch.float64), criteria.to(torch.float64)]).cpu()
    return IterationResult(carry, int(host[0]), float(host[1]))


def _iterate_host_driven(body, init_carry, max_iter, tol, listener):
    carry, epoch, criteria = init_carry, 0, float("inf")
    while epoch < max_iter and (tol is None or criteria > tol):
        carry, crit = body(carry, epoch)
        epoch += 1
        criteria = float(crit)
        listener.on_epoch_watermark_incremented(epoch, carry)
    listener.on_iteration_terminated(carry)
    return IterationResult(carry, epoch, criteria)


def iterate_unbounded(
    batches: Iterable,
    step: Callable[[Any, Any], Any],
    init_state,
    listener: Optional[IterationListener] = None,
    checkpoint_dir: Optional[str] = None,
) -> Iterator[Tuple[int, Any]]:
    """The online loop (Iterations.iterateUnboundedStreams:118-131): one
    step per global batch, a new model version after each."""
    config.check_no_checkpoint(checkpoint_dir)

    def run():
        state, version = init_state, 0
        for batch in batches:
            state = step(state, batch)
            version += 1
            if listener is not None:
                listener.on_epoch_watermark_incremented(version, state)
            yield version, state
        if listener is not None:
            listener.on_iteration_terminated(state)

    return run()
