"""Streaming log2-bucketed histograms: the SLO percentile surface.

Port of flink_ml_tpu/obs/hist.py, whole: the same 96 log2 buckets, the
same interpolation and clamping, so for the same recorded values
`percentiles` gives the JAX package's numbers.

- A sample lands in bucket `floor(log2(v)) + 48` (one `math.frexp`); a
  quantile interpolates linearly inside its bucket and clamps to the
  observed min and max.
- Every histogram shares the bucket bounds, so `merge` adds counts.
- `configure(enabled=False)` makes `record` a no-op (one global load).

Names carry their unit (`serving.dispatchMs`); `serving.ServerHealth`
reports the serving stages' percentiles.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional

__all__ = [
    "Histogram",
    "configure",
    "enabled",
    "get",
    "record",
    "percentiles",
    "snapshot",
    "reset",
    "BUCKETS",
    "bucket_upper_bound",
]

#: Number of log2 buckets per histogram. Bucket i holds values in
#: [2^(i - BIAS - 1), 2^(i - BIAS)); bucket 0 additionally absorbs <= 0
#: and underflow, the last bucket absorbs overflow.
BUCKETS = 96
_BIAS = 48

_enabled = True
_hists: Dict[str, "Histogram"] = {}
_registry_lock = threading.Lock()


def configure(enabled: bool = True) -> None:
    """Process-wide enable/disable. Disabled recording is a no-op (one
    global load); existing histogram contents are retained."""
    global _enabled
    _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


def _bucket_index(v: float) -> int:
    if v <= 0.0:
        return 0
    i = math.frexp(v)[1] + _BIAS  # v in [2^(e-1), 2^e) for exponent e
    if i < 0:
        return 0
    if i >= BUCKETS:
        return BUCKETS - 1
    return i


def bucket_upper_bound(i: int) -> float:
    """Exclusive upper bound of bucket i (inclusive for Prometheus `le`)."""
    return float(2.0 ** (i - _BIAS))


class Histogram:
    """One mergeable log2-bucketed streaming distribution.

    Thread-safe: `record`/`merge` mutate under a per-histogram lock so
    concurrent writers never lose counts (the lock hold is a handful of
    integer ops — the pinned-cost budget includes it)."""

    __slots__ = ("name", "counts", "count", "total", "vmin", "vmax", "_lock")

    def __init__(self, name: str = ""):
        self.name = name
        self.counts: List[int] = [0] * BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        if not _enabled:
            return
        v = float(value)
        i = _bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other`'s counts into this histogram (identical bucket
        bounds by construction — the mergeability contract)."""
        with other._lock:
            counts = list(other.counts)
            count, total = other.count, other.total
            vmin, vmax = other.vmin, other.vmax
        with self._lock:
            for i, c in enumerate(counts):
                if c:
                    self.counts[i] += c
            self.count += count
            self.total += total
            if vmin < self.vmin:
                self.vmin = vmin
            if vmax > self.vmax:
                self.vmax = vmax
        return self

    def percentile(self, q: float) -> Optional[float]:
        """The q-quantile (q in [0, 1]) by cumulative bucket walk with
        linear interpolation inside the landing bucket, clamped to the
        observed [min, max]. None on an empty histogram — including a
        nonzero `count` with an all-zero bucket array (a summary rebuilt
        via `from_dict(include_buckets=False)` output): interpolating a
        percentile out of buckets that hold no observations would report
        fiction, so those answer None too."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0.0
        seen = False
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            seen = True
            if cum + c >= target:
                lo = 0.0 if i == 0 else bucket_upper_bound(i - 1)
                hi = bucket_upper_bound(i)
                frac = (target - cum) / c
                v = lo + frac * (hi - lo)
                return min(max(v, self.vmin), self.vmax)
            cum += c
        return self.vmax if seen and self.vmax != -math.inf else None

    def to_dict(self, include_buckets: bool = True) -> Dict:
        """Snapshot: summary stats + percentiles (+ the sparse nonzero
        bucket map, the mergeable wire format)."""
        with self._lock:
            counts = list(self.counts)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        out: Dict = {
            "count": count,
            "sum": total,
            "min": vmin if count else None,
            "max": vmax if count else None,
        }
        for label, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99), ("p999", 0.999)):
            out[label] = self.percentile(q)
        if include_buckets:
            out["buckets"] = {str(i): c for i, c in enumerate(counts) if c}
        return out

    @staticmethod
    def from_dict(d: Dict, name: str = "") -> "Histogram":
        """Rebuild a histogram from `to_dict(include_buckets=True)` output
        (the merge path for off-process aggregation)."""
        h = Histogram(name)
        h.count = int(d.get("count", 0))
        h.total = float(d.get("sum", 0.0))
        h.vmin = d["min"] if d.get("min") is not None else math.inf
        h.vmax = d["max"] if d.get("max") is not None else -math.inf
        for i, c in (d.get("buckets") or {}).items():
            h.counts[int(i)] = int(c)
        return h


# ---------------------------------------------------------------------------
# module-level registry (the metrics.py idiom: flat names, snapshot/reset)
# ---------------------------------------------------------------------------

def get(name: str) -> Histogram:
    """Get-or-create the named histogram."""
    h = _hists.get(name)
    if h is None:
        with _registry_lock:
            h = _hists.get(name)
            if h is None:
                h = Histogram(name)
                _hists[name] = h
    return h


def record(name: str, value: float) -> None:
    """Record one sample into the named histogram (no-op when disabled —
    the `get` is skipped too, so the disabled path is one global load)."""
    if not _enabled:
        return
    get(name).record(value)


def percentiles(name: str) -> Optional[Dict]:
    """Percentile summary of one histogram (no buckets), None if absent
    or empty."""
    h = _hists.get(name)
    if h is None or h.count == 0:
        return None
    return h.to_dict(include_buckets=False)


def snapshot(include_buckets: bool = True) -> Dict[str, Dict]:
    """Every named histogram as a plain dict (JSON-serializable)."""
    with _registry_lock:
        items = list(_hists.items())
    return {name: h.to_dict(include_buckets=include_buckets) for name, h in items}


def reset() -> None:
    with _registry_lock:
        _hists.clear()


if os.environ.get("FLINK_ML_TPU_HIST") == "0":
    _enabled = False
