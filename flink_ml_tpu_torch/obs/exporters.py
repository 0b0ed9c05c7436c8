"""Exporters: the metrics and histogram registries as JSON or Prometheus
text.

Port of flink_ml_tpu/obs/exporters.py, with its metric names and its
default prefix `flink_ml_tpu` (a dashboard scraping either package reads
the same series).

All render functions operate on `metrics.snapshot()` / `hist.snapshot()`
(or any snapshot-shaped dict, e.g. the per-entry deltas the benchmark
runner embeds in its result JSON), so a snapshot captured at one point
can be exported later or off-process.

Prometheus mapping:

- counters   -> `<prefix>_<name>_total`
- gauges     -> `<prefix>_<name>`
- timers     -> `<prefix>_<name>_ms_total` + `<prefix>_<name>_count`
- histograms -> the native histogram exposition:
  `<prefix>_<name>_bucket{le="..."}` (cumulative, `+Inf` included),
  `<prefix>_<name>_sum`, `<prefix>_<name>_count`

Because Prometheus names collapse `.`/`-` to `_`, two registry names can
silently merge into one exported series; `check_name_collisions` detects
that and `snapshot_prometheus` refuses to emit a colliding snapshot (a
collision is an instrumentation bug, not a render-time choice).

`bench_entry_prometheus` exports a benchmark entry's first-class fields
(retryCount, shedCount, rejectCount, swapCount, rollbackCount,
hostSyncCount, dispatchGapMs, ...) as labelled gauges, so a scraped
benchmark run carries the same evidence its JSON does.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from . import hist as hist_mod
from ..utils import metrics

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def snapshot_json(snap: Optional[Dict] = None, indent: int = 2) -> str:
    """The registry as a JSON document (timers/gauges/counters)."""
    return json.dumps(snap if snap is not None else metrics.snapshot(), indent=indent)


def _prom_name(prefix: str, name: str) -> str:
    return _NAME_RE.sub("_", f"{prefix}_{name}")


def check_name_collisions(
    snap: Optional[Dict] = None,
    hists: Optional[Dict] = None,
    prefix: str = "flink_ml_tpu",
) -> List[str]:
    """Exported metric names that more than one registry entry collapses
    to after Prometheus sanitization (e.g. counter `a.b` vs counter
    `a_b`, or a timer and a histogram sharing a `_count`). Empty list =
    clean."""
    snap = snap if snap is not None else metrics.snapshot()
    hists = hists if hists is not None else hist_mod.snapshot(include_buckets=False)
    seen: Dict[str, str] = {}
    collisions: List[str] = []

    def claim(metric: str, source: str) -> None:
        prior = seen.get(metric)
        if prior is not None and prior != source:
            collisions.append(f"{metric} ({prior} vs {source})")
        seen[metric] = source

    for name in snap.get("counters", {}):
        claim(_prom_name(prefix, name) + "_total", f"counter:{name}")
    for name in snap.get("gauges", {}):
        claim(_prom_name(prefix, name), f"gauge:{name}")
    for name in snap.get("timers", {}):
        base = _prom_name(prefix, name)
        claim(base + "_ms_total", f"timer:{name}")
        claim(base + "_count", f"timer:{name}")
    for name in hists:
        base = _prom_name(prefix, name)
        for suffix in ("_bucket", "_sum", "_count"):
            claim(base + suffix, f"histogram:{name}")
    return collisions


def snapshot_prometheus(
    snap: Optional[Dict] = None,
    prefix: str = "flink_ml_tpu",
    hists: Optional[Dict] = None,
) -> str:
    """The registries in the Prometheus text exposition format.

    Counters map to `<prefix>_<name>_total`, gauges to
    `<prefix>_<name>`, each timer to a `_ms_total` counter plus a
    `_count` counter (the summary pair scrapers can rate() over), and
    each obs/hist.py histogram to the native histogram exposition
    (cumulative `_bucket{le=...}` with log2 bounds, `_sum`, `_count`).
    Raises ValueError when two registry names collapse into one exported
    series (see `check_name_collisions`)."""
    snap = snap if snap is not None else metrics.snapshot()
    hists = hists if hists is not None else hist_mod.snapshot()
    collisions = check_name_collisions(snap, hists, prefix)
    if collisions:
        raise ValueError(
            "Prometheus name collision(s) after sanitization: "
            + "; ".join(collisions)
        )
    lines = []
    for name, value in sorted(snap.get("counters", {}).items()):
        metric = _prom_name(prefix, name) + "_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {value}")
    for name, value in sorted(snap.get("gauges", {}).items()):
        metric = _prom_name(prefix, name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {value}")
    for name, stats in sorted(snap.get("timers", {}).items()):
        base = _prom_name(prefix, name)
        lines.append(f"# TYPE {base}_ms_total counter")
        lines.append(f"{base}_ms_total {stats['totalMs']}")
        lines.append(f"# TYPE {base}_count counter")
        lines.append(f"{base}_count {stats['count']}")
    for name, h in sorted(hists.items()):
        if not h.get("count", 0):
            # zero observations: emitting an all-zero bucket series would
            # invite scrapers to interpolate percentiles out of nothing —
            # the histogram appears once it has a sample (matching
            # ServerHealth.stageLatencyMs reporting None for empty stages)
            continue
        base = _prom_name(prefix, name)
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for i, c in sorted(
            ((int(i), c) for i, c in (h.get("buckets") or {}).items())
        ):
            cum += c
            le = hist_mod.bucket_upper_bound(i)
            lines.append(f'{base}_bucket{{le="{le:g}"}} {cum}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {h.get("count", 0)}')
        lines.append(f"{base}_sum {h.get('sum', 0.0)}")
        lines.append(f"{base}_count {h.get('count', 0)}")
    return "\n".join(lines) + "\n"


#: The benchmark runner's first-class per-entry fields exported by
#: `bench_entry_prometheus`.
BENCH_FIELDS = (
    "totalTimeMs",
    "inputThroughput",
    "outputThroughput",
    "hostSyncCount",
    "hostDispatchMs",
    "dispatchGapMs",
    "gapCount",
    "dispatchDepth",
    "fusedSegments",
    "h2dBytes",
    "h2dCount",
    "deviceCacheHits",
    "deviceCacheMisses",
    "checkpointCount",
    "checkpointBytes",
    "retryCount",
    "shedCount",
    "rejectCount",
    "peakQueueDepth",
    "peakHbmBytes",
    "residentModelBytes",
    "swapCount",
    "rollbackCount",
    "promoteRejected",
    # the serving surface: open-loop rates, model store paging, and the
    # capture count of the first serve
    "offeredQps",
    "goodputQps",
    "saturationQps",
    "pageInCount",
    "recompileCount",
)


def bench_entry_prometheus(
    entry: Dict, name: Optional[str] = None, prefix: str = "flink_ml_tpu_bench"
) -> str:
    """One benchmark-runner result dict as labelled Prometheus gauges:
    `<prefix>_<field>{benchmark="<name>"} <value>` for every first-class
    numeric field present (see BENCH_FIELDS). The embedded metrics delta
    is exportable separately via `snapshot_prometheus(entry["metrics"])`."""
    label = name if name is not None else entry.get("name", "unknown")
    lines = []
    for field in BENCH_FIELDS:
        value = entry.get(field)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            metric = _prom_name(prefix, field)
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f'{metric}{{benchmark="{label}"}} {value}')
    return "\n".join(lines) + "\n"
