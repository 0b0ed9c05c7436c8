"""Profiler-trace capture and analysis on torch.profiler.

Port of flink_ml_tpu/utils/traceprof.py. `capture_trace(fn)` runs `fn`
under `torch.profiler.profile` (CPU and CUDA activities), exports the
chrome trace and reduces it with `analyze_trace` to what a performance
measurement reads from the device timeline:

- `deviceBusyMs`: the union of the kernel, memcpy and memset intervals on
  the card's streams (overlapping streams count once);
- `windowMs` and `deviceIdleShare`: the traced window (the first to the
  last event of the trace, host and device) and the share of it with no
  device interval;
- `topKernels`: the device events by total time;
- `hostToDeviceMs` and `hostToDeviceUnderKernelsMs`: the host-to-device
  copies' time, and the part of it that ran while a kernel ran (an
  upload overlapped with compute);
- `wallMs` (capture_trace only): the host wall of the traced call.

The JAX package's `hbmBytesAccessed` and `modelFlops` come from XLA's
cost model, which a torch.profiler trace does not carry; they are left
out rather than estimated. A kernel that ran inside a replayed CUDA graph
appears in the trace only where CUPTI reports graph kernels;
`deviceEvents` says how many device events the trace held.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: chrome-trace categories of device work in a torch.profiler export
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def capture_trace(fn: Callable[[], Any], trace_dir: Optional[str] = None) -> Dict:
    """Run `fn` under torch.profiler; return `analyze_trace` of its chrome
    trace plus the traced call's host wall time and the trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="flink_ml_tpu_torch_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    stats = analyze_trace(path)
    stats["wallMs"] = wall_s * 1000.0
    stats["tracePath"] = path
    return stats


def _load(path: str) -> Dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def analyze_trace(path: str) -> Dict:
    """Reduce a chrome-format torch.profiler trace (plain or gzipped JSON)
    to device-side totals: busy time (the union of the device intervals),
    the traced window and the idle share of it, and the top kernels."""
    trace = _load(path)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device])
    busy_us = sum(hi - lo for lo, hi in busy)
    if spans:
        lo = min(float(e["ts"]) for e in spans)
        hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
        window_us = max(0.0, hi - lo)
    else:
        window_us = 0.0
    kernels = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                      for e in device if e.get("cat") == "kernel"])
    uploads = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device
               if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    under = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in uploads for ka, kb in kernels)
    by_name: Dict[str, Dict[str, float]] = {}
    by_category: Dict[str, Dict[str, float]] = {}
    for e in device:
        dur = float(e.get("dur", 0.0))
        top = by_name.setdefault(e.get("name", ""), {"durUs": 0.0, "count": 0})
        top["durUs"] += dur
        top["count"] += 1
        cat = by_category.setdefault(e.get("cat", ""), {"durUs": 0.0, "count": 0})
        cat["durUs"] += dur
        cat["count"] += 1
    return {
        "deviceBusyMs": busy_us / 1000.0,
        "windowMs": window_us / 1000.0,
        "deviceIdleShare": (1.0 - busy_us / window_us) if window_us > 0 else None,
        "deviceEvents": len(device),
        "hostToDeviceMs": sum(b - a for a, b in uploads) / 1000.0,
        "hostToDeviceUnderKernelsMs": under / 1000.0,
        "byCategory": dict(sorted(by_category.items(), key=lambda kv: -kv[1]["durUs"])),
        "topKernels": dict(sorted(by_name.items(), key=lambda kv: -kv[1]["durUs"])[:12]),
    }
