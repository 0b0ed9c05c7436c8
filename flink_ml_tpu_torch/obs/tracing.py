"""Host-sync and readback accounting.

Port of the accounting half of flink_ml_tpu/obs/tracing.py:
`account_host_sync` (`:314`) and `account_readback` (`:245`), which the
readback funnel (`utils/packing.py`) calls. Spans, the timeline, the
stage instrumentation and the exporters are not ported yet (ROADMAP
A.14), so these two only fold into `utils.metrics`.
"""

from __future__ import annotations

from ..utils import metrics


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
