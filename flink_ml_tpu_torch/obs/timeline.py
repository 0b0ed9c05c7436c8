"""Flight recorder: a bounded, lock-cheap ring of timeline events.

Port of the recording core of flink_ml_tpu/obs/timeline.py. A
`TimelineRing` is a fixed-size ring written without a lock (one
`itertools.count` fetch picks the slot, one list store publishes the
event); wrapping overwrites the oldest events and `snapshot_events`
reports how many fell off. The flow channels, the serving stages, the
lifecycle's promotions and rollbacks, the H2D uploads and the spans record
here when the ring is configured (`configure(ring_size=n)` or
`FLINK_ML_TPU_TIMELINE_RING=<n>`); otherwise every record call is one
module-global load. The Chrome trace export, the JSONL dump and load and
`dispatch_attribution` are not ported (ROADMAP A.14).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "configure",
    "enabled",
    "now_us",
    "record_begin",
    "record_end",
    "record_complete",
    "record_instant",
    "record_counter",
    "drain",
    "snapshot_events",
    "host_lane",
    "TimelineRing",
    "LANE_DISPATCH",
    "LANE_DEVICE",
    "LANE_READBACK",
    "LANE_H2D",
    "LANE_COLLECTIVE",
    "LANE_FLOW",
    "LANE_SERVING",
    "LANE_LIFECYCLE",
    "LANE_SUPERVISOR",
    "LANE_MEMORY",
]

# Logical-stream lanes (host threads get their own "host:<name>" lanes).
LANE_DISPATCH = "dispatch"
LANE_DEVICE = "device"
LANE_READBACK = "readback"
LANE_H2D = "h2d"
LANE_COLLECTIVE = "collective"
LANE_FLOW = "flow"
LANE_SERVING = "serving"
LANE_LIFECYCLE = "lifecycle"
LANE_SUPERVISOR = "supervisor"
LANE_MEMORY = "memory"

_ORIGIN_NS = time.perf_counter_ns()

_enabled = False
_ring: Optional["TimelineRing"] = None
_lock = threading.Lock()


class TimelineRing:
    """Fixed-capacity event ring. Writers are lock-free: an atomic
    counter fetch picks the slot, a list store publishes. Readers
    (`events()`) scan the slots and order by sequence number; events
    overwritten by wrapping are reported as `truncated`."""

    def __init__(self, size: int):
        n = 1
        while n < max(16, int(size)):
            n <<= 1
        self.size = n
        self._mask = n - 1
        self._buf: List[Optional[Tuple]] = [None] * n
        self._seq = itertools.count()

    def append(self, ev: Tuple) -> None:
        i = next(self._seq)
        self._buf[i & self._mask] = (i, ev)

    def events(self) -> Tuple[List[Tuple], int]:
        """(ordered event tuples, truncated-count). Safe to call while
        writers are active — the scan sees a consistent per-slot view."""
        slots = [s for s in list(self._buf) if s is not None]
        slots.sort(key=lambda s: s[0])
        if not slots:
            return [], 0
        written = slots[-1][0] + 1
        return [ev for _, ev in slots], max(0, written - len(slots))


def enabled() -> bool:
    return _enabled


def now_us() -> float:
    """The current timeline clock (same origin as event `tsUs`) — lets a
    caller bracket a region and filter `snapshot_events` to it."""
    return (time.perf_counter_ns() - _ORIGIN_NS) / 1000.0


def host_lane() -> str:
    """The current thread's host lane name."""
    return "host:" + threading.current_thread().name


def configure(ring_size: Optional[int] = None) -> None:
    """(Re)configure the process-wide flight recorder. `ring_size`
    None/0 disables it (the no-op fast path)."""
    global _enabled, _ring
    with _lock:
        _ring = TimelineRing(int(ring_size)) if ring_size else None
        _enabled = _ring is not None
    # the flight recorder counts as a span sink: spans flow while only the
    # timeline is configured
    from . import tracing

    tracing._refresh_enabled()


def _init_from_env() -> None:
    ring = os.environ.get("FLINK_ML_TPU_TIMELINE_RING")
    if ring:
        configure(ring_size=int(ring))


# ---------------------------------------------------------------------------
# recording — event tuples: (ph, lane, name, ts_ns, dur_ns, ref, args)
# ---------------------------------------------------------------------------

def record_begin(lane: str, name: str, ref: Optional[int] = None) -> None:
    ring = _ring
    if ring is not None:
        ring.append(("B", lane, name, time.perf_counter_ns(), 0, ref, None))


def record_end(lane: str, name: str, ref: Optional[int] = None, **args) -> None:
    ring = _ring
    if ring is not None:
        ring.append(
            ("E", lane, name, time.perf_counter_ns(), 0, ref, args or None)
        )


def record_complete(
    lane: str, name: str, start_ns: int, dur_ns: int, **args
) -> None:
    """One already-measured interval (readback, h2d upload, chunk
    dispatch) — exported as a Chrome `X` event."""
    ring = _ring
    if ring is not None:
        ring.append(("X", lane, name, int(start_ns), max(0, int(dur_ns)), None, args or None))


def record_instant(lane: str, name: str, **args) -> None:
    """Zero-duration mark (collective op, channel shed, promote/swap)."""
    ring = _ring
    if ring is not None:
        ring.append(("i", lane, name, time.perf_counter_ns(), 0, None, args or None))


def record_counter(lane: str, name: str, **series) -> None:
    """One sample of a set of named counter series (Chrome `C` events —
    Perfetto renders them as a stacked track). The HBM ledger samples
    per-category live bytes onto the `memory` lane on every change."""
    ring = _ring
    if ring is not None:
        ring.append(
            ("C", lane, name, time.perf_counter_ns(), 0, None, series or None)
        )


def _event_dict(ev: Tuple) -> Dict:
    ph, lane, name, ts_ns, dur_ns, ref, args = ev
    out: Dict[str, Any] = {
        "ph": ph,
        "lane": lane,
        "name": name,
        "tsUs": (ts_ns - _ORIGIN_NS) / 1000.0,
        "durUs": dur_ns / 1000.0,
    }
    if ref is not None:
        out["ref"] = ref
    if args:
        out["args"] = args
    return out


def snapshot_events() -> Tuple[List[Dict], int]:
    """(events as dicts in order, truncated-count) without clearing."""
    ring = _ring
    if ring is None:
        return [], 0
    evs, truncated = ring.events()
    return [_event_dict(e) for e in evs], truncated


def drain() -> List[Dict]:
    """Return the recorded events in order and reset the ring."""
    global _ring
    with _lock:
        ring = _ring
        if ring is None:
            return []
        _ring = TimelineRing(ring.size)
    evs, _ = ring.events()
    return [_event_dict(e) for e in evs]



_init_from_env()
