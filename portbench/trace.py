"""The device trace of a run's traced slice, reduced to what the
per-layer metrics read.

`traced(body)` runs `body` under torch.profiler (host and CUDA activity),
exports the chrome trace into the run's temporary directory, reduces it
with `reduce_trace` and deletes it. The reduction's arithmetic is a copy
of the port's `utils/traceprof.analyze_trace`: the device is busy where
any kernel, memcpy or memset runs (the union of their intervals, so
overlapping streams count once), and the window runs from the trace's
first event to its last, host and device. Beside it:

- `kernels`: each device operation's total seconds and count, by its
  base name (the identifier before its template and argument list:
  `(anonymous namespace)::row_dots_kernel(int const*, ...)` is
  `row_dots_kernel`);
- `idle_by_host`: the device's idle gaps, each named by what the host's
  busiest thread was doing at the gap's middle (its innermost open event:
  an operator, a runtime call or a request's annotation), summed by name.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def base_name(name: str) -> str:
    """A device operation's qualified identifier, without its template
    arguments, parameter list, return type or anonymous namespace; a copy
    or a fill keeps its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    kept, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            kept.append(ch)
    head = "".join(kept).split()
    return head[-1] if head else name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def _host_label(events, points: List[float]) -> List[str]:
    """For each time in `points` (ascending), the innermost open event of
    the thread with the most host events, or "none"."""
    by_tid: Dict = {}
    for e in events:
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    if not by_tid:
        return ["none"] * len(points)
    main = max(by_tid.values(), key=len)
    main.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    labels, stack, k = [], [], 0
    for p in points:
        while k < len(main) and float(main[k]["ts"]) <= p:
            e = main[k]
            while stack and stack[-1][0] <= float(e["ts"]):
                stack.pop()
            stack.append((float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "")))
            k += 1
        while stack and stack[-1][0] < p:
            stack.pop()
        labels.append(stack[-1][1] if stack else "outside any host operator")
    return labels


def reduce_trace(path: str) -> Dict:
    """busy_s, window_s, kernels {base name: [seconds, count]},
    idle_by_host {label: seconds} and device_events of a chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device])
    if spans:
        lo = min(float(e["ts"]) for e in spans)
        hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
    else:
        lo = hi = 0.0
    kernels: Dict[str, List[float]] = {}
    for e in device:
        entry = kernels.setdefault(base_name(e.get("name", "")), [0.0, 0])
        entry[0] += float(e.get("dur", 0.0)) / 1e6
        entry[1] += 1
    gaps, prev = [], lo
    for b_lo, b_hi in busy + [(hi, hi)]:
        if b_lo > prev:
            gaps.append((prev, b_lo))
        prev = max(prev, b_hi)
    host = [e for e in spans if e.get("cat") in HOST_CATEGORIES]
    idle: Dict[str, float] = {}
    for (g_lo, g_hi), label in zip(gaps, _host_label(host, [(a + b) / 2 for a, b in gaps])):
        idle[label] = idle.get(label, 0.0) + (g_hi - g_lo) / 1e6
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "kernels": kernels,
        "idle_by_host": idle,
        "device_events": len(device),
    }


def traced(body: Callable):
    """Run `body(annotate)` under torch.profiler, `annotate` being
    `record_function`; return (body's result, reduce_trace of its trace).
    The trace file, in the run's temporary directory, is deleted once
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = body(record_function)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        summary = reduce_trace(path)
        print(f"portbench: trace of {summary['device_events']} device events, "
              f"{os.path.getsize(path) / 2**20:.1f} MiB, exported and reduced in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    finally:
        os.remove(path)
    return result, summary


def top(mapping: Dict[str, float], k: int = 10) -> List[List]:
    """The k largest entries as [name, value] pairs."""
    return [[name, value] for name, value in sorted(mapping.items(), key=lambda kv: -kv[1])[:k]]
