"""Flow control and transient-fault resilience: the shared runtime contract.

Port of flink_ml_tpu/flow.py, whole and call for call: it is host code
(threads, condition variables, counters) and imports no device library.
Four pieces, one contract:

1. **`BoundedChannel`**: a credit-based bounded queue between one producer
   role and one consumer role. The producer spends one credit per `put`;
   the consumer returns one per `get`. At zero credits the channel's
   overload policy decides:

   | policy        | at zero credits                | guarantees                  |
   |---------------|--------------------------------|-----------------------------|
   | `block`       | producer waits for a credit    | lossless, in order          |
   | `shed_oldest` | evict the oldest queued item,  | bounded memory and bounded  |
   |               | accept the new one             | staleness (lag < capacity)  |
   | `sample`      | drop the new item (the queue   | bounded memory; the queue   |
   |               | stays a prefix of the stream)  | is a prefix sample          |
   | `reject`      | raise `ChannelRejected` with   | bounded memory and bounded  |
   |               | the live queue depth           | producer latency            |

   Sheds and rejects count in `flow.shed` / `flow.reject` (and
   `.<name>`), the high-water depth in the `flow.peakQueueDepth` gauge, and
   the consumed staleness (items produced after the one consumed) in
   `stats.max_lag` and the `flow.lag.<name>` gauge.

2. **`pump`**: feed an iterable through an optional transform into a
   channel from one daemon worker. A worker error closes the channel with
   the error, which the consumer re-raises in order, after the items
   staged before it. `spawn` starts a named daemon worker for loops of
   another shape (the serving dispatch loop).

3. **`with_retries`**: exponential backoff with jitter, a bounded retry
   budget (`config.transient_retries`) and a strict taxonomy: only
   `TRANSIENT_ERRORS` (OSError-family and `TransientError`, which
   `ckpt.faults.flaky` raises) are retried; `ckpt.faults.InjectedFault`
   models a crash and propagates at once. An exhausted budget re-raises
   the original error with `retry_attempts` set.

4. **`StragglerWatchdog`**: a per-stage trailing-mean (EMA) latency; a
   sample beyond `config.straggler_factor` times the mean counts in
   `flow.straggler` / `flow.straggler.<stage>`; with escalation armed, a
   streak raises `PersistentStraggler`.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

from .obs import timeline
from .utils import metrics

__all__ = [
    "BLOCK",
    "SHED_OLDEST",
    "SAMPLE",
    "REJECT",
    "POLICIES",
    "ChannelClosed",
    "ChannelRejected",
    "ChannelStats",
    "BoundedChannel",
    "pump",
    "spawn",
    "TransientError",
    "TRANSIENT_ERRORS",
    "with_retries",
    "StragglerWatchdog",
    "PersistentStraggler",
]


# ---------------------------------------------------------------------------
# overload policies
# ---------------------------------------------------------------------------

BLOCK = "block"
SHED_OLDEST = "shed_oldest"
SAMPLE = "sample"
REJECT = "reject"
POLICIES = (BLOCK, SHED_OLDEST, SAMPLE, REJECT)


class ChannelClosed(Exception):
    """Raised by `put` on a closed channel, and by `get` once a closed
    channel has drained (iteration turns this into StopIteration)."""


class ChannelRejected(RuntimeError):
    """The `reject` policy's typed fast-fail: the channel was full at
    `put` time. Carries the live queue depth so callers (and their
    clients) can make a load-shedding decision instead of parsing a
    message string."""

    def __init__(self, name: str, depth: int, capacity: int):
        super().__init__(
            f"channel {name!r} rejected put: {depth}/{capacity} credits in use"
        )
        self.channel = name
        self.depth = depth
        self.capacity = capacity


@dataclass
class ChannelStats:
    """Cumulative credit accounting for one channel (all fields are
    monotone except `max_lag`, a high-water mark)."""

    puts: int = 0  # items accepted into the queue
    gets: int = 0  # items handed to the consumer
    shed: int = 0  # items dropped by shed_oldest/sample
    rejected: int = 0  # puts refused by the reject policy
    peak_depth: int = 0  # high-water queue depth
    max_lag: int = 0  # worst consumed staleness (items produced after)


class BoundedChannel:
    """Credit-based bounded queue with a per-consumer overload policy.

    One producer role, one consumer role (each may be a single thread; the
    serving pull loop uses both roles from the same thread via the
    non-blocking `offer`/`get` pair, which never waits). `close(error)`
    ends the stream: the consumer drains the remaining items, then sees
    `error` (re-raised) or clean exhaustion. `cancel()` is the consumer's
    early exit: close AND return whatever was still queued so the caller
    can release resources (staged device buffers, pending guards).
    """

    def __init__(self, capacity: int, policy: str = BLOCK, name: str = "channel"):
        if policy not in POLICIES:
            raise ValueError(f"unknown overload policy {policy!r} (one of {POLICIES})")
        self.capacity = max(1, int(capacity))
        self.policy = policy
        self.name = name
        self.stats = ChannelStats()
        self._cv = threading.Condition()
        self._items: deque = deque()  # (seq, item); bounded by put-side credits
        self._seq = 0  # next acceptance sequence number
        self._closed = False
        self._error: Optional[BaseException] = None

    # -- credit accounting ---------------------------------------------------
    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def credits(self) -> int:
        """Live put allowance: capacity minus queued items."""
        with self._cv:
            return self.capacity - len(self._items)

    def full(self) -> bool:
        with self._cv:
            return len(self._items) >= self.capacity

    # -- producer side -------------------------------------------------------
    def put(self, item, timeout: Optional[float] = None) -> bool:
        """Submit one item under the channel's overload policy. Returns
        True when the item entered the queue, False when the policy
        dropped it (`sample`), raises `ChannelRejected` (`reject`) or
        `ChannelClosed` (consumer gone). `block` waits for a credit, up
        to `timeout` seconds when given (TimeoutError past it)."""
        with self._cv:
            if self.policy == BLOCK:
                deadline = None if timeout is None else time.monotonic() + timeout
                while not self._closed and len(self._items) >= self.capacity:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"channel {self.name!r}: no credit within {timeout}s"
                            )
                    self._cv.wait(remaining)
            if self._closed:
                raise ChannelClosed(self.name)
            if len(self._items) >= self.capacity:
                if self.policy == REJECT:
                    self.stats.rejected += 1
                    metrics.inc_counter("flow.reject")
                    metrics.inc_counter(f"flow.reject.{self.name}")
                    if timeline.enabled():
                        timeline.record_instant(
                            timeline.LANE_FLOW,
                            f"{self.name}.reject",
                            depth=len(self._items),
                        )
                    raise ChannelRejected(self.name, len(self._items), self.capacity)
                self.stats.shed += 1
                metrics.inc_counter("flow.shed")
                metrics.inc_counter(f"flow.shed.{self.name}")
                if timeline.enabled():
                    timeline.record_instant(
                        timeline.LANE_FLOW, f"{self.name}.shed", depth=len(self._items)
                    )
                if self.policy == SAMPLE:  # keep the queue: a prefix sample
                    self._seq += 1  # the dropped item still "happened"
                    return False
                self._items.popleft()  # shed_oldest: evict the stalest
            self._items.append((self._seq, item))
            self._seq += 1
            self.stats.puts += 1
            self._note_depth(len(self._items))
            if timeline.enabled():
                timeline.record_instant(
                    timeline.LANE_FLOW, f"{self.name}.put", depth=len(self._items)
                )
            self._cv.notify_all()
            return True

    def offer(self, item) -> bool:
        """Non-blocking, policy-free put: accept the item iff a credit is
        free right now. The single-threaded pull loops (serving) pair this
        with `get` to keep their window bounded without ever waiting."""
        with self._cv:
            if self._closed:
                raise ChannelClosed(self.name)
            if len(self._items) >= self.capacity:
                return False
            self._items.append((self._seq, item))
            self._seq += 1
            self.stats.puts += 1
            self._note_depth(len(self._items))
            if timeline.enabled():
                timeline.record_instant(
                    timeline.LANE_FLOW, f"{self.name}.put", depth=len(self._items)
                )
            self._cv.notify_all()
            return True

    def _note_depth(self, depth: int) -> None:
        if depth > self.stats.peak_depth:
            self.stats.peak_depth = depth
            if depth > metrics.get_gauge("flow.peakQueueDepth", 0):
                metrics.set_gauge("flow.peakQueueDepth", depth)

    # -- consumer side -------------------------------------------------------
    def get(self, timeout: Optional[float] = None):
        """Take the oldest queued item, waiting up to `timeout` seconds
        (None = indefinitely). Once the channel is closed and drained,
        re-raises the producer's error (in order — queued items always
        deliver first) or `ChannelClosed` on a clean end."""
        with self._cv:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._items and not self._closed:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"channel {self.name!r}: no item within {timeout}s"
                        )
                self._cv.wait(remaining)
            if not self._items:
                if self._error is not None:
                    raise self._error
                raise ChannelClosed(self.name)
            seq, item = self._items.popleft()
            self.stats.gets += 1
            lag = (self._seq - 1) - seq  # items produced after this one
            if lag > self.stats.max_lag:
                self.stats.max_lag = lag
            metrics.set_gauge(f"flow.lag.{self.name}", lag)
            if timeline.enabled():
                timeline.record_instant(
                    timeline.LANE_FLOW,
                    f"{self.name}.get",
                    depth=len(self._items),
                    lag=lag,
                )
            self._cv.notify_all()
            return item

    def __iter__(self) -> Iterator:
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return

    # -- lifecycle -----------------------------------------------------------
    def close(self, error: Optional[BaseException] = None) -> None:
        """End the stream. Queued items stay consumable; after they drain
        the consumer sees `error` (re-raised) or clean exhaustion. Idempotent
        — the first error wins."""
        with self._cv:
            if error is not None and self._error is None:
                self._error = error
            self._closed = True
            self._cv.notify_all()

    def cancel(self) -> list:
        """Consumer-side early exit: close the channel and return the
        still-queued items so the caller can release what they hold. A
        producer blocked in `put` wakes and sees `ChannelClosed`."""
        with self._cv:
            self._closed = True
            remaining = [item for _, item in self._items]
            self._items.clear()
            self._cv.notify_all()
            return remaining

    @property
    def closed(self) -> bool:
        return self._closed


# ---------------------------------------------------------------------------
# the sanctioned worker spawn: iterable -> channel
# ---------------------------------------------------------------------------

def pump(
    items: Iterable,
    channel: BoundedChannel,
    transform: Optional[Callable[[Any], Any]] = None,
    watchdog: Optional["StragglerWatchdog"] = None,
) -> threading.Thread:
    """Feed `items` (each optionally mapped through `transform`) into
    `channel` from ONE daemon worker thread, then close it. Iteration,
    transform and put all run on the worker, so a single-worker pump keeps
    serial-access constraints (native cache reads, device cache state)
    intact by construction. Error contract: any failure — in the iterable
    or the transform — closes the channel with that error, so the consumer
    re-raises it in order instead of stalling on a silently-dead worker;
    `ChannelClosed` from a consumer's `cancel()` just ends the speculative
    work."""

    def run() -> None:
        try:
            for item in items:
                if transform is not None:
                    if watchdog is not None:
                        with watchdog.observe():
                            item = transform(item)
                    else:
                        item = transform(item)
                channel.put(item)
        except ChannelClosed:
            pass  # consumer cancelled: abandon speculative staging
        except BaseException as e:  # noqa: BLE001 — the channel IS the error path
            channel.close(error=e)
            return
        channel.close()

    worker = threading.Thread(target=run, name=f"flow-pump-{channel.name}", daemon=True)
    worker.start()
    return worker


def spawn(fn: Callable[[], None], name: str = "worker") -> threading.Thread:
    """Start a named daemon worker running `fn` — the escape hatch for
    loops that don't fit `pump`'s iterable→channel shape (the serving
    dispatch loop). Callers own their error handling: a worker that can
    fail must route the failure into a channel via `close(error)`, never
    swallow it."""
    worker = threading.Thread(target=fn, name=f"flow-{name}", daemon=True)
    worker.start()
    return worker


# ---------------------------------------------------------------------------
# retry-with-backoff for transient faults
# ---------------------------------------------------------------------------

class TransientError(RuntimeError):
    """Base class for failures that are retryable BY CONTRACT: the caller
    may re-execute the failed operation verbatim and expect success
    (flaky I/O, a preempted RPC). `ckpt.faults.TransientFault` — the
    injectable flavor — subclasses this; `ckpt.faults.InjectedFault`
    deliberately does NOT (it models a crash, and retrying a crash would
    un-test the checkpoint path)."""


#: The retryable taxonomy: OS-level I/O flakes plus contract-transient
#: errors. ValueError/TypeError/KeyError-class data errors, InjectedFault
#: kills, and everything else propagate on the first failure.
TRANSIENT_ERRORS: Tuple[type, ...] = (OSError, TimeoutError, ConnectionError, TransientError)


def with_retries(
    fn: Callable,
    *args,
    site: str = "",
    retries: Optional[int] = None,
    base_delay_s: Optional[float] = None,
    max_delay_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    retryable: Optional[Tuple[type, ...]] = None,
    on_retry: Optional[Callable[[BaseException, int], None]] = None,
    **kwargs,
):
    """Call `fn(*args, **kwargs)`, retrying transient failures with
    exponential backoff + jitter.

    - `retries` is the retry BUDGET (extra attempts after the first);
      default `config.transient_retries`, 0 = fail on first error.
    - Only `retryable` errors (default `TRANSIENT_ERRORS`) are retried;
      anything else propagates immediately.
    - `deadline_s` bounds total wall time including backoff sleeps: once
      exceeded, no further attempt is made.
    - An exhausted budget re-raises the ORIGINAL error with
      `retry_attempts` set to the number of calls made — the failure the
      operator debugs is the real one, with the retry evidence attached.
    - Every retry increments `flow.retry` (and `flow.retry.<site>`).
    """
    from . import config

    budget = config.transient_retries if retries is None else int(retries)
    base = config.retry_base_delay_s if base_delay_s is None else float(base_delay_s)
    cap = config.retry_max_delay_s if max_delay_s is None else float(max_delay_s)
    classes = TRANSIENT_ERRORS if retryable is None else retryable
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except classes as e:  # type: ignore[misc]
            out_of_budget = attempt > budget
            out_of_time = (
                deadline_s is not None and time.monotonic() - start >= deadline_s
            )
            if out_of_budget or out_of_time:
                e.retry_attempts = attempt  # evidence on the ORIGINAL error
                raise
            metrics.inc_counter("flow.retry")
            if site:
                metrics.inc_counter(f"flow.retry.{site}")
            if timeline.enabled():
                timeline.record_instant(
                    timeline.LANE_FLOW,
                    f"retry.{site or 'unsited'}",
                    attempt=attempt,
                    error=type(e).__name__,
                )
            if on_retry is not None:
                on_retry(e, attempt)
            delay = min(cap, base * (2 ** (attempt - 1)))
            # full jitter (50-100% of the backoff step): retries from
            # concurrent sites decorrelate instead of stampeding together
            time.sleep(delay * (0.5 + 0.5 * random.random()))


# ---------------------------------------------------------------------------
# straggler watchdog
# ---------------------------------------------------------------------------

class PersistentStraggler(RuntimeError):
    """The watchdog's typed escalation (opt-in via
    `config.straggler_escalate` or the `escalate` ctor arg): one stage
    was flagged on `consecutive` samples IN A ROW — no longer a blip the
    EMA will absorb but a stage that has durably stopped keeping up, the
    input a supervisor can act on (quarantine, re-dispatch, abort)
    where a counter is only a breadcrumb. Carries the evidence so the
    handler never parses a message string."""

    def __init__(self, stage: str, consecutive: int, seconds: float, mean_s: float):
        super().__init__(
            f"stage {stage!r} straggled on {consecutive} consecutive samples "
            f"(last {seconds * 1000.0:.1f}ms vs trailing mean "
            f"{mean_s * 1000.0:.1f}ms)"
        )
        self.stage = stage
        self.consecutive = consecutive
        self.seconds = seconds
        self.mean_s = mean_s


class StragglerWatchdog:
    """Flag stage executions that exceed a multiple of the stage's
    trailing-mean latency.

    The trailing mean is an EMA (`alpha`); the first `warmup` samples
    only seed it (cold caches and first-call compiles are not
    stragglers). A flagged sample increments `flow.straggler` and
    `flow.straggler.<stage>` and publishes the offending latency as the
    `flow.straggler.<stage>.lastMs` gauge — obs counters, not exceptions:
    a straggler is a symptom to surface, not a failure to inject.

    Escalation (opt-in): with `escalate` set (ctor arg, falling back to
    `config.straggler_escalate`; 0 = off), `record` raises a typed
    `PersistentStraggler` once that many consecutive samples flag — the
    counter stays a symptom, the streak becomes a failure. A healthy
    sample resets the streak, and the escalating sample still folds into
    the mean first, so a caller that catches and continues observes the
    same trailing mean as a non-escalating watchdog."""

    def __init__(
        self,
        stage: str,
        factor: Optional[float] = None,
        warmup: int = 5,
        alpha: float = 0.25,
        escalate: Optional[int] = None,
    ):
        self.stage = stage
        self._factor = factor
        self.warmup = max(1, int(warmup))
        self.alpha = float(alpha)
        self._escalate = escalate
        self._mean = 0.0
        self._n = 0
        self._streak = 0  # consecutive flagged samples

    @property
    def factor(self) -> float:
        if self._factor is not None:
            return self._factor
        from . import config

        return config.straggler_factor

    @property
    def escalate_after(self) -> int:
        """Consecutive flags that raise `PersistentStraggler` (0 = never)."""
        if self._escalate is not None:
            return max(0, int(self._escalate))
        from . import config

        return max(0, int(config.straggler_escalate))

    @property
    def trailing_mean_s(self) -> float:
        return self._mean

    @property
    def samples(self) -> int:
        """Samples folded so far (warmup arming rides on this)."""
        return self._n

    @property
    def consecutive_flags(self) -> int:
        return self._streak

    @contextmanager
    def observe(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def record(self, seconds: float) -> bool:
        """Fold one latency sample; returns True when it was flagged.
        Raises `PersistentStraggler` when escalation is armed and this
        sample extends the consecutive-flag streak to the threshold."""
        flagged = (
            self._n >= self.warmup
            and self._mean > 0.0
            and seconds > self.factor * self._mean
        )
        if flagged:
            metrics.inc_counter("flow.straggler")
            metrics.inc_counter(f"flow.straggler.{self.stage}")
            metrics.set_gauge(f"flow.straggler.{self.stage}.lastMs", seconds * 1000.0)
        # stragglers still fold into the mean: a stage that got
        # permanently slower stops being flagged once the mean catches up
        mean_before = self._mean
        self._mean = (
            seconds
            if self._n == 0
            else (1.0 - self.alpha) * self._mean + self.alpha * seconds
        )
        self._n += 1
        self._streak = self._streak + 1 if flagged else 0
        threshold = self.escalate_after
        if flagged and threshold and self._streak >= threshold:
            metrics.inc_counter("flow.straggler.escalated")
            metrics.inc_counter(f"flow.straggler.{self.stage}.escalated")
            self._streak = 0  # a caller that catches and continues re-arms
            raise PersistentStraggler(self.stage, threshold, seconds, mean_before)
        return flagged
