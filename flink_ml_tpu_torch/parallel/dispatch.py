"""Whole-fit eligibility, its fallback accounting and the timed launch.

Port of the part of flink_ml_tpu/parallel/dispatch.py that the fits
call. Where each function of the JAX module lives in the port:

- `whole_fit_enabled` (JAX `:73`), `account_whole_fit_fallback` (`:114`),
  `whole_fit_plan` (`:127`), `timed_dispatch` (`:231`): here;
- `account_whole_fit` (`:99`): `ops.optimizer.account_whole_fit`;
- `next_boundary`: `parallel.iteration.next_boundary`;
- `supports_donation` (`:52`): no counterpart; a captured CUDA graph reads
  its inputs in place (`lazyjit.lazy_jit(borrow=...)`, ROADMAP C.23);
- `chunk_runner`/`ChunkRunner`, `DrainQueue`: no counterpart; the port
  has no drain queue (C.23): a whole fit is one captured graph, and the
  chunked loops read back once a chunk.

A fit on a mesh of more than one rank is not captured: a gloo collective
cannot be captured in a CUDA graph, so its epochs run eagerly with the
reduction between the local steps, counted under the fallback reason
`mesh` (ROADMAP C.28).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

from ..obs import timeline, tracing
from ..utils import metrics

#: why a whole-fit-eligible loop did not run as one program
#: (`dispatch.whole_fit_fallback.<reason>`): the JAX package's four, `mesh`
#: (a fit over more than one rank runs its epochs eagerly) and
#: `fleet_overlap` (a fleet fit in a process tuned for the overlap loops,
#: which cannot host the member axis; JAX fleet.py:264-267)
WHOLE_FIT_FALLBACK_REASONS = (
    "checkpoint_interval",
    "device_cache_budget",
    "ragged_batches",
    "listener",
    "mesh",
    "fleet_overlap",
)


def whole_fit_enabled() -> bool:
    """Is the whole-fit mode on (`config.whole_fit`)?"""
    from .. import config

    return config.whole_fit == "auto"


def account_whole_fit_fallback(reason: str) -> None:
    """Count a whole-fit-eligible loop falling back, labelled with why
    (`dispatch.whole_fit_fallback.<reason>`), with a mark on the timeline's
    dispatch lane."""
    metrics.inc_counter("dispatch.whole_fit_fallback")
    metrics.inc_counter(f"dispatch.whole_fit_fallback.{reason}")
    if timeline.enabled():
        timeline.record_instant(timeline.LANE_DISPATCH, "whole_fit.fallback", reason=reason)


def whole_fit_plan(*, start_epoch: int, max_iter: int, checkpoint_interval: Optional[int] = None,
                   data_bytes: Optional[int] = None, uniform_batches: bool = True,
                   listener: bool = False, ranks: int = 1) -> Tuple[bool, Optional[str]]:
    """The whole-fit eligibility decision: (take, fallback_reason), with the
    fallback counted. The JAX package's reasons in its order, then `mesh`
    for a fit over `ranks` > 1. (False, None), uncounted, when the mode is
    off."""
    from .iteration import next_boundary

    if not whole_fit_enabled():
        return False, None
    reason = None
    if listener:
        reason = "listener"
    if reason is None and checkpoint_interval is not None:
        boundary = next_boundary(start_epoch, checkpoint_interval)
        if boundary is not None and boundary < max_iter:
            reason = "checkpoint_interval"
    if reason is None and not uniform_batches:
        reason = "ragged_batches"
    if reason is None and data_bytes is not None:
        from ..data.devicecache import within_device_budget

        if not within_device_budget(data_bytes):
            reason = "device_cache_budget"
    if reason is None and ranks > 1:
        reason = "mesh"
    if reason is not None:
        account_whole_fit_fallback(reason)
        return False, reason
    return True, None



@contextmanager
def timed_dispatch(kernel: str, start: Optional[int] = None, end: Optional[int] = None):
    """Time the block as one launch: the host's part of it goes into the
    `iteration.dispatch` timer (the benchmark's `hostDispatchMs`; its count
    is `gapCount`) as an always-timed phase (`tracing.timed`: a span and
    a profiler range when those are on) and, with the timeline on, onto
    the dispatch lane as a `dispatch.chunk` event naming `kernel` and the
    planned epoch range [start, end), which `timeline.dispatch_attribution`
    splits by. Each site of the JAX package's `timed_dispatch` (a wrapper
    there; a block here, so the call stays in sight of the SPMD
    interpreter) has its counterpart: a whole fit through the program
    funnel is one launch, as there; a loop that stays eager in the port (a
    checkpointed chunk, a stream epoch) is one launch a chunk or epoch
    (ROADMAP C.44). On the card this times the enqueue and whatever the
    block waits for; on the CPU the whole computation."""
    with tracing.timed("iteration.dispatch") as phase:
        yield
    if timeline.enabled():
        attrs = {"kernel": kernel}
        if start is not None:
            attrs["start"] = int(start)
        if end is not None:
            attrs["end"] = int(end)
        timeline.record_complete(timeline.LANE_DISPATCH, "dispatch.chunk", phase.start_ns,
                                 phase.dur_ns, **attrs)
