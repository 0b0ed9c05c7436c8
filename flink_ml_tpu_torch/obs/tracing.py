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

The timeline flight recorder (timeline.py) counts as a sink too. With no
sink configured `span()` returns a shared no-op context manager: one
global load and one call, no allocation. Completed spans are folded into
the `span.<name>` timers of `utils.metrics`.

Accounting funnels: `account_readback` (the packed readbacks,
`utils/packing.py`), `account_host_sync`, `set_dispatch_depth`,
`account_collective` (every accounted collective of
`parallel/collectives.py`), and
`account_compile`, which the program funnel (utils/lazyjit.py) calls for
every capture, as the JAX package's compile-event hook
(`install_jax_hooks`) does for every backend compile: `jit.compiles`, the
`jit.compile` timer, the `jit.compileMs` histogram and a
`compile`-category span. `instrument_stage_methods` wraps every stage's
own `fit`/`transform` (api.Stage.__init_subclass__) in a `stage.fit` /
`stage.transform` span, and every fit in `memledger.fit_peak_scope`.
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


class Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "_start_ns", "_token")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self):
        parent = _current.get()
        self.parent_id = parent.span_id if parent is not None else 0
        self.span_id = next(_ids)
        self._token = _current.set(self)
        if timeline.enabled():
            timeline.record_begin(timeline.host_lane(), self.name, ref=self.span_id)
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        dur_ns = end_ns - self._start_ns
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
    """Context manager timing a named region nested under the current span;
    the shared no-op object when no sink is configured."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs)


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


def set_dispatch_depth(depth: int) -> None:
    """Record the in-flight dispatch depth a pipelined loop ran at."""
    metrics.set_gauge("iteration.dispatch_depth", depth)


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
# automatic stage instrumentation (api.Stage.__init_subclass__)
# ---------------------------------------------------------------------------

def _wrap_stage_method(fn, op: str):
    import functools

    from . import memledger

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if op == "fit":
            # the per-fit memory watermark (hbm.peak.fit): always on, like
            # the metrics registry
            with memledger.fit_peak_scope():
                if not _enabled:
                    return fn(self, *args, **kwargs)
                with Span("stage." + op, {"stage": type(self).__name__}):
                    return fn(self, *args, **kwargs)
        if not _enabled:
            return fn(self, *args, **kwargs)
        with Span("stage." + op, {"stage": type(self).__name__}):
            return fn(self, *args, **kwargs)

    wrapper._obs_instrumented = True
    return wrapper


def instrument_stage_methods(cls) -> None:
    """Wrap a Stage subclass's `fit`/`transform` in `stage.fit` /
    `stage.transform` spans: its own, or one it takes from a mixin that is
    not a Stage (the port's linear models take `transform` from one).
    Definitions already wrapped are left alone, so each call produces
    exactly one span."""
    for op in ("fit", "transform"):
        fn = cls.__dict__.get(op, getattr(cls, op, None))
        if fn is None or not callable(fn):
            continue
        if getattr(fn, "_obs_instrumented", False) or getattr(fn, "__isabstractmethod__", False):
            continue
        setattr(cls, op, _wrap_stage_method(fn, op))


_init_from_env()
