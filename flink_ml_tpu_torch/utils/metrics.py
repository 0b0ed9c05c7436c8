"""Process-wide metrics: timers, gauges, counters and a profiler scope.

Port of flink_ml_tpu/utils/metrics.py (`:35-114`), with its names:

- `timed(name)` accumulates wall-clock spans per named phase
  (`pipeline.fit`, `pipeline.transform`);
- `set_gauge`/`inc_counter` are the metric-group analogue (the fusion
  planner's `pipeline.fused_segments`, `iteration.host_sync`, `jit.traces`);
- `profile_trace(dir)` records a `torch.profiler` trace of the block,
  written by `tensorboard_trace_handler` (the JAX package's scope records
  a `jax.profiler` trace).

Everything is a plain module-level registry: `snapshot()` returns a copy,
`snapshot_delta` the activity between two snapshots, `reset()` clears.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

_timers: Dict[str, List[float]] = {}
_gauges: Dict[str, float] = {}
_counters: Dict[str, int] = {}


@contextmanager
def timed(name: str):
    """Accumulate the wall-clock duration of this block under `name`."""
    start = time.perf_counter()
    try:
        yield
    finally:
        _timers.setdefault(name, []).append(time.perf_counter() - start)


def record_time(name: str, seconds: float) -> None:
    _timers.setdefault(name, []).append(seconds)


def set_gauge(name: str, value: float) -> None:
    _gauges[name] = value


def get_gauge(name: str, default=None):
    return _gauges.get(name, default)


def inc_counter(name: str, delta: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + delta


def get_counter(name: str, default: int = 0) -> int:
    return _counters.get(name, default)


def timer_totals() -> Dict[str, float]:
    """Total seconds per phase."""
    return {k: float(sum(v)) for k, v in _timers.items()}


def snapshot() -> Dict[str, Dict]:
    """A copyable view of every metric: per-phase {count, totalMs, lastMs},
    gauges, counters."""
    return {
        "timers": {
            k: {"count": len(v), "totalMs": sum(v) * 1000.0, "lastMs": v[-1] * 1000.0}
            for k, v in _timers.items()
        },
        "gauges": dict(_gauges),
        "counters": dict(_counters),
    }


def snapshot_delta(before: Dict[str, Dict], after: Dict[str, Dict]) -> Dict[str, Dict]:
    """The registry activity between two `snapshot()` calls: timer and
    counter increments (entries that did not move are dropped), gauges as
    of `after`."""
    timers = {}
    for name, stats in after["timers"].items():
        prev = before["timers"].get(name, {"count": 0, "totalMs": 0.0})
        count = stats["count"] - prev["count"]
        if count:
            timers[name] = {
                "count": count,
                "totalMs": stats["totalMs"] - prev["totalMs"],
                "lastMs": stats["lastMs"],
            }
    counters = {}
    for name, value in after["counters"].items():
        delta = value - before["counters"].get(name, 0)
        if delta:
            counters[name] = delta
    return {"timers": timers, "gauges": dict(after["gauges"]), "counters": counters}


def reset() -> None:
    _timers.clear()
    _gauges.clear()
    _counters.clear()


@contextmanager
def profile_trace(log_dir: str):
    """Record a torch.profiler trace of this block (host, and the card's
    kernels when there is one) into `log_dir`, as TensorBoard's profile
    plugin and chrome://tracing read it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
