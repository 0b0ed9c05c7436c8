"""Spans, and host-sync and readback accounting.

Port of flink_ml_tpu/obs/tracing.py's `span` (`:183`) with its ring sink,
and of its accounting half: `account_host_sync` (`:314`) and
`account_readback` (`:245`), which the readback funnel
(`utils/packing.py`) and the serving readbacks call.

A span is one timed region of host control flow. Spans nest through a
`contextvars.ContextVar`. With no sink configured `span()` returns a shared
no-op context manager (one global load and one call: what the serving
dispatch pays); with the ring sink (`configure(ring_size=n)`) or the
timeline flight recorder configured, each completed span is a record
`{"name", "spanId", "parentId", "startUs", "durUs", "attrs"}`, folded into
the `span.<name>` timer of `utils.metrics` and marked on the timeline. The
JSONL file sink, the stage instrumentation and the exporters are not
ported yet (ROADMAP A.14).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ..utils import metrics
from . import timeline

_ORIGIN_NS = time.perf_counter_ns()

_ids = itertools.count(1)
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "flink_ml_tpu_torch_obs_span", default=None
)

_lock = threading.Lock()
_ring: Optional[deque] = None
_enabled = False  # True iff a sink is configured


def enabled() -> bool:
    """True when a span sink (the ring, or the timeline flight recorder) is
    configured."""
    return _enabled


def _refresh_enabled() -> None:
    """Recompute the span fast-path flag; the timeline flight recorder
    counts as a sink (timeline.configure calls this)."""
    global _enabled
    _enabled = _ring is not None or timeline.enabled()


def configure(ring_size: Optional[int] = None) -> None:
    """(Re)configure the span ring; None/0 disables it (the no-op fast
    path, unless the timeline flight recorder is configured)."""
    global _ring
    with _lock:
        _ring = deque(maxlen=int(ring_size)) if ring_size else None
    _refresh_enabled()


def drain_ring():
    """Return and clear the ring's span records."""
    with _lock:
        if _ring is None:
            return []
        out = list(_ring)
        _ring.clear()
    return out


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
        record = {
            "name": self.name,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startUs": (self._start_ns - _ORIGIN_NS) / 1000.0,
            "durUs": dur_ns / 1000.0,
            "attrs": self.attrs,
        }
        with _lock:
            if _ring is not None:
                _ring.append(record)
        return False


def span(name: str, **attrs):
    """Context manager timing a named region nested under the current span;
    the shared no-op object when no sink is configured."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs)


def account_readback(nbytes: int, seconds: float, arrays: int = 1) -> None:
    """Fold one device-to-host transfer of `arrays` tensors into the
    registry: `readback.count`, `readback.bytes` and the `readback` timer."""
    metrics.inc_counter("readback.count")
    metrics.inc_counter("readback.bytes", int(nbytes))
    metrics.record_time("readback", seconds)


def account_host_sync(kind: str = "drain", count: int = 1) -> None:
    """Fold one blocking host-device synchronization point into the
    registry: `iteration.host_sync` and `iteration.host_sync.<kind>` (a fit
    result's readback, a transform's guard drain)."""
    metrics.inc_counter("iteration.host_sync", count)
    metrics.inc_counter(f"iteration.host_sync.{kind}", count)
