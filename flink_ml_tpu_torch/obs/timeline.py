"""Flight recorder: a bounded, lock-cheap ring of timeline events.

Port of the recording core of flink_ml_tpu/obs/timeline.py. A
`TimelineRing` is a fixed-size ring written without a lock (one
`itertools.count` fetch picks the slot, one list store publishes the
event); wrapping overwrites the oldest events and `snapshot_events`
reports how many fell off. The flow channels, the serving stages, the
lifecycle's promotions and rollbacks, the H2D uploads, the readbacks, the
host syncs and the spans record here when the ring is configured
(`configure(ring_size=n)`, `FLINK_ML_TPU_TIMELINE_RING=<n>`); otherwise
every record call is one module-global load.

`to_chrome` renders the events as Chrome/Perfetto trace-event JSON (one
`tid` a lane; begin/end pairs matched by span ref, pairs broken by the
ring's wrap dropped and counted in `otherData.unmatchedDropped`);
`dump_jsonl`/`load_events` are the on-disk hand-off
(`FLINK_ML_TPU_TIMELINE_FILE=<path>` dumps the ring at process exit),
`export_chrome_file` writes the Chrome document, and
`dispatch_attribution` reduces the dispatch, device and readback lanes to
`wall = dispatch + device + readback + idle-gap` per chunk.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

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
    "to_chrome",
    "dispatch_attribution",
    "dump_jsonl",
    "export_chrome_file",
    "load_events",
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
#: a mark per accounted collective call (tracing.account_collective)
LANE_COLLECTIVE = "collective"
LANE_FLOW = "flow"
LANE_SERVING = "serving"
LANE_LIFECYCLE = "lifecycle"
LANE_SUPERVISOR = "supervisor"
LANE_MEMORY = "memory"

#: Stable lane ordering for Chrome `tid` assignment: host lanes first,
#: then the logical streams in pipeline order, then anything else.
_LANE_ORDER = (
    LANE_DISPATCH,
    LANE_DEVICE,
    LANE_READBACK,
    LANE_H2D,
    LANE_COLLECTIVE,
    LANE_FLOW,
    LANE_SERVING,
    LANE_LIFECYCLE,
    LANE_SUPERVISOR,
    LANE_MEMORY,
)

_ORIGIN_NS = time.perf_counter_ns()

_enabled = False
_ring: Optional["TimelineRing"] = None
_dump_path: Optional[str] = None
_lock = threading.Lock()
_atexit_registered = False


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


def configure(ring_size: Optional[int] = None, dump_file: Optional[str] = None) -> None:
    """(Re)configure the process-wide flight recorder. `ring_size`
    None/0 disables it (the no-op fast path). `dump_file` also dumps the
    ring as JSONL at process exit (for scripts/obs_timeline.py in another
    process)."""
    global _enabled, _ring, _dump_path, _atexit_registered
    with _lock:
        if dump_file and not ring_size:
            ring_size = 65536
        _ring = TimelineRing(int(ring_size)) if ring_size else None
        _dump_path = dump_file or None
        _enabled = _ring is not None
        if _dump_path is not None and not _atexit_registered:
            atexit.register(_dump_at_exit)
            _atexit_registered = True
    # the flight recorder counts as a span sink: spans flow while only the
    # timeline is configured
    from . import tracing

    tracing._refresh_enabled()


def _dump_at_exit() -> None:
    if _dump_path is not None and _ring is not None:
        try:
            dump_jsonl(_dump_path)
        except OSError:
            pass


def _init_from_env() -> None:
    ring = os.environ.get("FLINK_ML_TPU_TIMELINE_RING")
    path = os.environ.get("FLINK_ML_TPU_TIMELINE_FILE")
    if ring or path:
        configure(ring_size=int(ring) if ring else None, dump_file=path)


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


# ---------------------------------------------------------------------------
# export: events -> Chrome trace-event JSON (Perfetto-loadable)
# ---------------------------------------------------------------------------

def _resolve(events: Iterable[Dict]) -> Tuple[List[Dict], int]:
    """Match B/E pairs into X events (by lane + ref, falling back to a
    per-lane name stack); pass X/i through. Unmatched begins/ends —
    the ring-truncation case — are dropped and counted, never raised."""
    resolved: List[Dict] = []
    open_by_ref: Dict[Tuple[str, Any], Dict] = {}
    open_stack: Dict[str, List[Dict]] = {}
    dropped = 0
    for ev in events:
        ph = ev.get("ph")
        if ph == "B":
            if ev.get("ref") is not None:
                open_by_ref[(ev["lane"], ev["ref"])] = ev
            else:
                open_stack.setdefault(ev["lane"], []).append(ev)
        elif ph == "E":
            begin = None
            if ev.get("ref") is not None:
                begin = open_by_ref.pop((ev["lane"], ev["ref"]), None)
            else:
                stack = open_stack.get(ev["lane"])
                if stack:
                    begin = stack.pop()
            if begin is None:
                dropped += 1  # begin fell off the ring
                continue
            resolved.append(
                {
                    "ph": "X",
                    "lane": ev["lane"],
                    "name": ev["name"],
                    "tsUs": begin["tsUs"],
                    "durUs": max(0.0, ev["tsUs"] - begin["tsUs"]),
                    "args": ev.get("args"),
                }
            )
        elif ph in ("X", "i", "C"):
            resolved.append(ev)
    dropped += len(open_by_ref) + sum(len(s) for s in open_stack.values())
    resolved.sort(key=lambda e: e["tsUs"])
    return resolved, dropped


def _lane_tids(events: Iterable[Dict]) -> Dict[str, int]:
    lanes = sorted({e["lane"] for e in events})
    host = [ln for ln in lanes if ln.startswith("host:")]
    rest = [ln for ln in lanes if not ln.startswith("host:")]
    ordered = host + [ln for ln in _LANE_ORDER if ln in rest]
    ordered += [ln for ln in rest if ln not in _LANE_ORDER]
    return {lane: tid for tid, lane in enumerate(ordered, start=1)}


def _json_safe(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return {k: str(v) for k, v in obj.items()}


def to_chrome(events: Optional[Iterable[Dict]] = None) -> Dict:
    """Render timeline events (default: the live ring) as a Chrome
    trace-event JSON document. `otherData` carries the drop accounting
    (`unmatchedDropped`, `truncated`)."""
    truncated = 0
    if events is None:
        events, truncated = snapshot_events()
    resolved, dropped = _resolve(events)
    tids = _lane_tids(resolved)
    trace_events: List[Dict] = [
        {
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "flink_ml_tpu_torch"},
        }
    ]
    for lane, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        trace_events.append(
            {
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": lane},
            }
        )
    for ev in resolved:
        rec: Dict[str, Any] = {
            "ph": ev["ph"] if ev["ph"] in ("X", "C") else "i",
            "pid": 1,
            "tid": tids[ev["lane"]],
            "name": ev["name"],
            "ts": ev["tsUs"],
        }
        if ev["ph"] == "X":
            rec["dur"] = ev.get("durUs", 0.0)
        elif ev["ph"] != "C":
            rec["s"] = "t"  # instant scoped to its thread/lane
        if ev.get("args"):
            rec["args"] = _json_safe(ev["args"])
        trace_events.append(rec)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"unmatchedDropped": dropped, "truncated": truncated},
    }


def dump_jsonl(path: str, events: Optional[Iterable[Dict]] = None) -> int:
    """Write timeline events (default: the live ring, without clearing)
    as JSONL — the on-disk handoff to scripts/obs_timeline.py. Returns
    the number of events written."""
    if events is None:
        events, _ = snapshot_events()
    events = list(events)
    with open(path, "w") as f:
        for ev in events:
            if ev.get("args"):
                ev = {**ev, "args": _json_safe(ev["args"])}
            f.write(json.dumps(ev) + "\n")
    return len(events)


def export_chrome_file(path: str, events: Optional[Iterable[Dict]] = None) -> Dict:
    doc = to_chrome(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def load_events(path: str) -> List[Dict]:
    """Read a `dump_jsonl` file back; tolerates a truncated final line
    (a killed process) by skipping unparseable lines."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict) and "ph" in ev and "lane" in ev:
                out.append(ev)
    return out


# ---------------------------------------------------------------------------
# dispatch-wall attribution: wall = dispatch + device + readback + idle-gap
# ---------------------------------------------------------------------------

def dispatch_attribution(events: Optional[Iterable[Dict]] = None) -> Dict:
    """Reduce the dispatch/device/readback lanes to the per-chunk and
    per-epoch dispatch-wall identity.

    The window spans the first chunk dispatch to the last drain; each
    chunk's wall (its dispatch start to the next chunk's, or window
    end) splits into `dispatch` (host-side dispatch call), `device`
    (estimated execution interval), `readback` (blocking drains) and
    `idleGap` (the residual — host Python between
    dispatches, what a captured whole fit removes). Totals,
    per-chunk rows, and per-epoch means (chunk args carry start/end
    epochs) are returned; empty dict when no dispatch events exist."""
    truncated = 0
    if events is None:
        events, truncated = snapshot_events()
    resolved, _ = _resolve(events)
    disp = [e for e in resolved if e["lane"] == LANE_DISPATCH and e["ph"] == "X"]
    if not disp:
        return {}
    dev = [e for e in resolved if e["lane"] == LANE_DEVICE and e["ph"] == "X"]
    rb = [e for e in resolved if e["lane"] == LANE_READBACK and e["ph"] == "X"]

    def _end(e):
        return e["tsUs"] + e.get("durUs", 0.0)

    def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for lo, hi in sorted(intervals):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def _clip(events_list, lo, hi) -> List[Tuple[float, float]]:
        out = []
        for x in events_list:
            a, b = max(x["tsUs"], lo), min(_end(x), hi)
            if b > a:
                out.append((a, b))
        return out

    def _length(iv):
        return sum(hi - lo for lo, hi in iv)

    def _subtract(iv, cover) -> List[Tuple[float, float]]:
        """Intervals of `iv` not covered by `cover` (both disjoint-sorted)."""
        out = []
        for lo, hi in iv:
            cur = lo
            for clo, chi in cover:
                if chi <= cur or clo >= hi:
                    continue
                if clo > cur:
                    out.append((cur, clo))
                cur = max(cur, chi)
                if cur >= hi:
                    break
            if cur < hi:
                out.append((cur, hi))
        return out

    window_start = disp[0]["tsUs"]
    window_end = max(max((_end(e) for e in disp + dev + rb)), window_start)
    chunks: List[Dict] = []
    epochs_total = 0
    for i, e in enumerate(disp):
        c_start = e["tsUs"]
        c_end = disp[i + 1]["tsUs"] if i + 1 < len(disp) else window_end
        wall = max(0.0, c_end - c_start)
        # clip every lane to the chunk window, then attribute with
        # priority dispatch > readback > device (overlaps count once:
        # a device-est interval spanning a host dispatch is host time)
        d_iv = _union(_clip([e], c_start, c_end))
        r_iv = _subtract(_union(_clip(rb, c_start, c_end)), d_iv)
        dr_iv = _union(d_iv + r_iv)
        v_iv = _subtract(_union(_clip(dev, c_start, c_end)), dr_iv)
        dispatch_us = _length(d_iv)
        readback_us = _length(r_iv)
        device_us = _length(v_iv)
        idle_us = max(0.0, wall - _length(_union(dr_iv + v_iv)))
        args = e.get("args") or {}
        n_epochs = None
        if "end" in args and "start" in args:
            n_epochs = max(1, int(args["end"]) - int(args["start"]))
            epochs_total += n_epochs
        chunks.append(
            {
                "wallMs": wall / 1000.0,
                "dispatchMs": dispatch_us / 1000.0,
                "deviceMs": device_us / 1000.0,
                "readbackMs": readback_us / 1000.0,
                "idleGapMs": idle_us / 1000.0,
                "epochs": n_epochs,
            }
        )
    totals = {
        key: sum(c[key] for c in chunks)
        for key in ("wallMs", "dispatchMs", "deviceMs", "readbackMs", "idleGapMs")
    }
    out = {
        "windowMs": (window_end - window_start) / 1000.0,
        "gapCount": len(chunks),
        "truncated": truncated,
        **totals,
        "chunks": chunks,
    }
    if epochs_total:
        out["epochs"] = epochs_total
        out["perEpoch"] = {k: v / epochs_total for k, v in totals.items()}
    return out


_init_from_env()
