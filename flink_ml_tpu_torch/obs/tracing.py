"""Span tracing core: nested, structured, always-on-cheap.

Port of flink_ml_tpu/obs/tracing.py. A span is one timed region of host
control flow: a pipeline stage's fit, a training epoch, a packed
device-to-host readback, a graph capture. Spans nest through a
`contextvars.ContextVar`, so the parent chain survives threads spawned
with a copied context.

Sinks (either or both, process-wide):

- JSONL file: `FLINK_ML_TPU_TRACE_FILE` (or `configure(trace_file=)`), one
  JSON object a line, `{"name", "spanId", "parentId", "startUs", "durUs",
  "attrs"}` with `startUs` monotonic microseconds from the process's trace
  origin;
- ring buffer: `FLINK_ML_TPU_TRACE_RING=<n>` (or `configure(ring_size=n)`);
  `drain_ring()` returns and clears it.

The timeline flight recorder (timeline.py) counts as a sink too. While
torch.profiler records, every span is also a `record_function` range, so
the profiler's trace carries the program's phases as `user_annotation`
events on its own clock. With no sink configured and no profiler
recording, `span()` returns a shared no-op context manager: two global
loads and one call, no allocation. Completed spans are folded into the
`span.<name>` timers of `utils.metrics`.

`timed(name)` is a phase that is always timed: its host time goes into
the `<name>` timer whatever the sinks, and it is a span (with no
`span.<name>` sample) and a profiler range when those are on. The
phases of a fit and a transform: `stage.fit` / `stage.transform`
(`instrument_stage_methods`), `sgd.stage` (ops/optimizer.py),
`iteration.dispatch` (parallel/dispatch.py), `readback.wait` and
`readback.copy` (utils/packing.py). `device_timed(name, device)` times
the card's part of a block with a pair of CUDA events, folded into the
`<name>` timer once the card has passed the second (`replay.device`,
`transform.device`), on a sample of the calls; nothing about it blocks.

Accounting funnels: `account_readback` (the packed readbacks,
`utils/packing.py`), `account_host_sync`,
`account_collective` (every accounted collective of
`parallel/collectives.py`), and
`account_compile`, which the program funnel (utils/lazyjit.py) calls for
every capture, as the JAX package's compile-event hook
(`install_jax_hooks`) does for every backend compile: `jit.compiles`, the
`jit.compile` timer, the `jit.compileMs` histogram and a
`compile`-category span. `instrument_stage_methods` wraps every stage's
own `fit`/`transform` (api.Stage.__init_subclass__) in a `stage.fit` /
`stage.transform` phase, and every fit in `memledger.fit_peak_scope`.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import torch
from torch.autograd import profiler as _profiler

from ..utils import metrics
from . import timeline

# Monotonic origin for startUs: consumers need ordering and durations only
_ORIGIN_NS = time.perf_counter_ns()

_ids = itertools.count(1)
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "flink_ml_tpu_torch_obs_span", default=None
)

_lock = threading.Lock()
_trace_path: Optional[str] = None
_trace_file = None  # lazily opened append handle for _trace_path
_ring: Optional[deque] = None
_enabled = False  # True iff a sink is configured


def enabled() -> bool:
    """True when a span sink (file, ring, or the timeline flight recorder)
    is configured."""
    return _enabled


def _refresh_enabled() -> None:
    """Recompute the span fast-path flag; the timeline flight recorder
    counts as a sink (timeline.configure calls this)."""
    global _enabled
    _enabled = _trace_path is not None or _ring is not None or timeline.enabled()


def configure(trace_file: Optional[str] = None, ring_size: Optional[int] = None) -> None:
    """(Re)configure the span sinks. None/0 for both disables tracing (the
    no-op fast path, unless the timeline flight recorder is configured)."""
    global _trace_path, _trace_file, _ring
    with _lock:
        if _trace_file is not None:
            _trace_file.close()
            _trace_file = None
        _trace_path = trace_file or None
        _ring = deque(maxlen=int(ring_size)) if ring_size else None
    _refresh_enabled()


def _init_from_env() -> None:
    path = os.environ.get("FLINK_ML_TPU_TRACE_FILE")
    ring = os.environ.get("FLINK_ML_TPU_TRACE_RING")
    if path or ring:
        configure(trace_file=path, ring_size=int(ring) if ring else None)


def drain_ring():
    """Return and clear the ring's span records."""
    with _lock:
        if _ring is None:
            return []
        out = list(_ring)
        _ring.clear()
    return out


def _emit(record: Dict[str, Any]) -> None:
    global _trace_file
    with _lock:
        if _ring is not None:
            _ring.append(record)
        if _trace_path is not None:
            if _trace_file is None:
                _trace_file = open(_trace_path, "a", buffering=1)
            _trace_file.write(json.dumps(record, default=str) + "\n")


class _NoopSpan:
    """Shared do-nothing span: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key: str, value) -> None:
        pass


_NOOP = _NoopSpan()


def _open_range(name: str):
    """A `record_function` range entered while torch.profiler records
    (one read of the profiler's module flag); None otherwise."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


class _Range(_NoopSpan):
    """A span that is a profiler range alone: tracing off, profiler on."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _open_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


class Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "_start_ns", "_token", "_range",
                 "_timer")

    def __init__(self, name: str, attrs: Dict[str, Any], timer: bool = True):
        self.name = name
        self.attrs = attrs
        self._timer = timer

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self):
        parent = _current.get()
        self.parent_id = parent.span_id if parent is not None else 0
        self.span_id = next(_ids)
        self._token = _current.set(self)
        if timeline.enabled():
            timeline.record_begin(timeline.host_lane(), self.name, ref=self.span_id)
        self._range = _open_range(self.name)
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        dur_ns = end_ns - self._start_ns
        if self._timer:
            metrics.record_time("span." + self.name, dur_ns / 1e9)
        if timeline.enabled():
            timeline.record_end(timeline.host_lane(), self.name, ref=self.span_id, **self.attrs)
        _emit({
            "name": self.name,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startUs": (self._start_ns - _ORIGIN_NS) / 1000.0,
            "durUs": dur_ns / 1000.0,
            "attrs": self.attrs,
        })
        return False


def span(name: str, **attrs):
    """Context manager timing a named region nested under the current span
    (and a profiler range while torch.profiler records); the shared no-op
    object when no sink is configured and the profiler is off."""
    if _enabled:
        return Span(name, attrs)
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return _NOOP


class _Timed:
    """An always-timed phase (`timed`): after the block, `start_ns` and
    `dur_ns` hold its host time."""

    __slots__ = ("name", "_inner", "start_ns", "dur_ns")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        if _enabled:
            self._inner = Span(name, attrs, timer=False)
        elif _profiler._is_profiler_enabled:
            self._inner = _Range(name)
        else:
            self._inner = _NOOP

    @property
    def seconds(self) -> float:
        return self.dur_ns / 1e9

    def __enter__(self):
        self._inner.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        metrics.record_time(self.name, self.dur_ns / 1e9)
        return self._inner.__exit__(exc_type, exc, tb)


def timed(name: str, **attrs) -> _Timed:
    """A phase whose host time always goes into the `<name>` timer of
    `utils.metrics`; with a sink configured it is also a span (its time
    not doubled into `span.<name>`), and while torch.profiler records a
    `record_function` range."""
    return _Timed(name, attrs)


def event(name: str, **attrs) -> None:
    """Zero-duration mark under the current span (a bank load, a run
    summary)."""
    if not _enabled:
        return
    parent = _current.get()
    _emit({
        "name": name,
        "spanId": next(_ids),
        "parentId": parent.span_id if parent is not None else 0,
        "startUs": (time.perf_counter_ns() - _ORIGIN_NS) / 1000.0,
        "durUs": 0.0,
        "attrs": attrs,
    })


def current_span() -> Optional[Span]:
    return _current.get()


def add_attr(key: str, value) -> None:
    """Attach an attribute to the innermost active span (no-op outside)."""
    sp = _current.get()
    if sp is not None:
        sp.attrs[key] = value


def emit_completed(name: str, start_ns: int, dur_s: float, **attrs) -> None:
    """Record a span whose timing was measured elsewhere (a capture, a
    readback)."""
    if not _enabled:
        return
    parent = _current.get()
    _emit({
        "name": name,
        "spanId": next(_ids),
        "parentId": parent.span_id if parent is not None else 0,
        "startUs": (start_ns - _ORIGIN_NS) / 1000.0,
        "durUs": dur_s * 1e6,
        "attrs": attrs,
    })


# ---------------------------------------------------------------------------
# runtime accounting: readbacks, host syncs, captures
# ---------------------------------------------------------------------------

def account_readback(nbytes: int, seconds: float, arrays: int = 1) -> None:
    """Fold one device-to-host transfer of `arrays` tensors into the
    registry (`readback.count`, `readback.bytes`, the `readback` timer), the
    timeline's `readback` lane and a `readback`-category span."""
    metrics.inc_counter("readback.count")
    metrics.inc_counter("readback.bytes", int(nbytes))
    metrics.record_time("readback", seconds)
    if timeline.enabled():
        end_ns = time.perf_counter_ns()
        timeline.record_complete(timeline.LANE_READBACK, "readback", end_ns - int(seconds * 1e9),
                                 int(seconds * 1e9), bytes=int(nbytes), arrays=arrays)
    if _enabled:
        emit_completed("readback", time.perf_counter_ns() - int(seconds * 1e9), seconds,
                       category="readback", bytes=int(nbytes), arrays=arrays)


def account_collective(op: str, nbytes: int, chunks: int, axis: str,
                       dense_equiv_bytes: Optional[int] = None) -> None:
    """Fold one collective call into the registry (+ a trace event and a
    mark on the timeline's `collective` lane). The port's wrappers call it
    once per call (the JAX package's, once per traced program). `nbytes`
    is the per-participant payload, `chunks` the bucket/leaf count. For a
    sparse index-value reduction `dense_equiv_bytes` is the payload the
    densified gradient would have moved; the running
    `collective.sparse_ratio` gauge (sparse bytes / dense-equivalent bytes)
    is << 1 when gradient bytes scale with nnz, not dim."""
    metrics.inc_counter(f"collective.{op}.calls")
    metrics.inc_counter(f"collective.{op}.bytes", int(nbytes))
    if chunks > 1:
        metrics.inc_counter(f"collective.{op}.chunks", int(chunks))
    if dense_equiv_bytes:
        metrics.inc_counter("collective.sparse.bytes", int(nbytes))
        metrics.inc_counter("collective.sparse.dense_equiv_bytes", int(dense_equiv_bytes))
        metrics.set_gauge(
            "collective.sparse_ratio",
            metrics.get_counter("collective.sparse.bytes")
            / max(metrics.get_counter("collective.sparse.dense_equiv_bytes"), 1))
    if timeline.enabled():
        timeline.record_instant(timeline.LANE_COLLECTIVE, f"collective.{op}", bytes=int(nbytes),
                                axis=axis)
    if _enabled:
        attrs = dict(category="collective", bytes=int(nbytes), chunks=int(chunks), axis=axis)
        if dense_equiv_bytes:
            attrs["denseEquivBytes"] = int(dense_equiv_bytes)
        event(f"collective.{op}", **attrs)


def account_host_sync(kind: str = "drain", count: int = 1) -> None:
    """Fold one blocking host-device synchronization point into the
    registry: `iteration.host_sync` and `iteration.host_sync.<kind>` (a fit
    result's readback, a transform's guard drain)."""
    metrics.inc_counter("iteration.host_sync", count)
    metrics.inc_counter(f"iteration.host_sync.{kind}", count)
    if timeline.enabled():
        timeline.record_instant(timeline.host_lane(), f"host_sync.{kind}")


def account_compile(seconds: float, **attrs) -> None:
    """One program capture (utils/lazyjit.py, pipeline.FusedSegment): the
    counterpart of a backend compile. `jit.compiles`, the `jit.compile`
    timer, the `jit.compileMs` histogram, and a `jit.compile` span of
    category `compile` when tracing is on."""
    from . import hist

    metrics.inc_counter("jit.compiles")
    metrics.record_time("jit.compile", seconds)
    hist.record("jit.compileMs", seconds * 1000.0)
    if _enabled:
        emit_completed("jit.compile", time.perf_counter_ns() - int(seconds * 1e9), seconds,
                       category="compile", **attrs)


# ---------------------------------------------------------------------------
# the card's time from CUDA events
# ---------------------------------------------------------------------------

#: event pairs the card has not passed yet, at most; a record beyond it
#: drops the oldest (`device_timer.dropped`)
DEVICE_PENDING = 64
#: a timer records a pair on one of this many of its calls: an event
#: recorded while the card is idle, as it is when a transform starts after
#: the last one was waited for, delays the work behind it by ~40 us on an
#: H100, 1-2% of a 10M-row transform; sampled, the cost is a sixteenth
DEVICE_SAMPLE_EVERY = 16
_device_lock = threading.Lock()
#: timer name -> its calls so far, for the sampling
_device_calls: Dict[str, int] = {}
#: (timer name, device index, start event, end event), oldest first
_device_pending: deque = deque(maxlen=DEVICE_PENDING)
#: device index -> timing events free for reuse
_event_pool: Dict[int, list] = {}


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def _fold_passed() -> None:
    """Fold the pending pairs the card has passed, oldest first, into their
    timers, and pool their events. Holds `_device_lock`."""
    while _device_pending:
        name, index, start, end = _device_pending[0]
        if not end.query():
            return
        _device_pending.popleft()
        metrics.record_time(name, start.elapsed_time(end) / 1e3)
        _event_pool.setdefault(index, []).extend((start, end))


def poll_device_timers() -> None:
    """Fold the event pairs the card has passed; never waits for one."""
    if _device_pending:
        with _device_lock:
            _fold_passed()


class _DeviceTimed:
    __slots__ = ("name", "device", "_index", "_stream", "_start")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def _take(self):
        pool = _event_pool.get(self._index)
        return pool.pop() if pool else _new_event()

    def __enter__(self):
        self._start = None
        device = self.device
        if device is not None and device.type != "cuda":
            return self
        calls = _device_calls.get(self.name, 0)
        _device_calls[self.name] = calls + 1
        if calls % DEVICE_SAMPLE_EVERY:
            return self
        if _profiler._is_profiler_enabled or torch.cuda.is_current_stream_capturing():
            return self
        index = device.index if device is not None and device.index is not None \
            else torch.cuda.current_device()
        self._stream = torch.cuda.current_stream(index)
        with _device_lock:
            self._index = index
            start = self._take()
            start.record(self._stream)
        self._start = start
        return self

    def __exit__(self, exc_type, exc, tb):
        start = self._start
        if start is None:
            return False
        with _device_lock:
            if exc_type is not None:
                _event_pool.setdefault(self._index, []).append(start)
                return False
            end = self._take()
            end.record(self._stream)
            if len(_device_pending) == _device_pending.maxlen:  # the append drops the oldest
                metrics.inc_counter("device_timer.dropped")
            _device_pending.append((self.name, self._index, start, end))
            # folded here, while the card runs the work just enqueued, not
            # before it, where the card would wait for the host
            _fold_passed()
        return False


def device_timed(name: str, device=None) -> _DeviceTimed:
    """The card's time on the work the block enqueues on the current
    stream of `device` (None: the current card), from a pair of timing
    events folded into the `<name>` timer once the card has passed the
    second (`poll_device_timers`, also run after each pair's second
    record); one call in `DEVICE_SAMPLE_EVERY` of each timer records a
    pair, so the timer's total over its count is the mean of a sample.
    Nothing blocks: no synchronize, no `elapsed_time` of an event not yet
    passed. Nothing is recorded off the card, while the stream is being
    captured, or while torch.profiler records (its trace times the card
    itself, and the events would stretch the gaps it measures)."""
    return _DeviceTimed(name, device)


# ---------------------------------------------------------------------------
# automatic stage instrumentation (api.Stage.__init_subclass__)
# ---------------------------------------------------------------------------

def _wrap_stage_method(fn, op: str):
    import functools

    from . import memledger

    name = "stage." + op

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if op == "fit":
            # the per-fit memory watermark (hbm.peak.fit): always on, like
            # the metrics registry
            with _Timed(name, {"stage": type(self).__name__}), memledger.fit_peak_scope():
                return fn(self, *args, **kwargs)
        with _Timed(name, {"stage": type(self).__name__}):
            return fn(self, *args, **kwargs)

    wrapper._obs_instrumented = True
    return wrapper


def instrument_stage_methods(cls) -> None:
    """Wrap a Stage subclass's `fit`/`transform` in `stage.fit` /
    `stage.transform` phases (`timed`): its own, or one it takes from a mixin that is
    not a Stage (the port's linear models take `transform` from one).
    Definitions already wrapped are left alone, so each call produces
    exactly one sample and span."""
    for op in ("fit", "transform"):
        fn = cls.__dict__.get(op, getattr(cls, op, None))
        if fn is None or not callable(fn):
            continue
        if getattr(fn, "_obs_instrumented", False) or getattr(fn, "__isabstractmethod__", False):
            continue
        setattr(cls, op, _wrap_stage_method(fn, op))


_init_from_env()
