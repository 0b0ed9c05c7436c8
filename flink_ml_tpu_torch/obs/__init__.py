"""Observability: span tracing and runtime accounting.

Port of flink_ml_tpu/obs/__init__.py. Where a fit or a transform spends
its time, split into compute, readback, compile (program captures) and
cache, without a profiler pass:

- `tracing` — `span(name, **attrs)`: nested spans with monotonic
  timestamps, emitted as JSONL (`FLINK_ML_TPU_TRACE_FILE`) or into a ring
  (`FLINK_ML_TPU_TRACE_RING`), folded into `metrics.snapshot()`, and
  `record_function` ranges while torch.profiler records; with no sink and
  no profiler the no-op path is two global loads and one call.
  `timed(name)`: a phase always timed into the `<name>` timer (a fit's and
  a transform's phases); `device_timed(name, device)`: the card's time on
  a block from CUDA events, folded without blocking;
- `timeline` — the flight recorder: a bounded ring of begin/end events
  with thread and logical-stream lanes (`FLINK_ML_TPU_TIMELINE_RING`,
  `FLINK_ML_TPU_TIMELINE_FILE`), exported as Chrome/Perfetto trace-event
  JSON and reduced to dispatch-wall attribution;
- `hist` — mergeable log2-bucketed streaming histograms;
- `memledger` — live device-memory accounting, peaks and budgets;
- `exporters` — `metrics.snapshot()` and the histograms as JSON or
  Prometheus text, with a name-collision check;
- `report` — a JSONL trace reduced to per-stage and per-epoch tables.
"""

from . import hist, timeline  # noqa: F401
from .tracing import (  # noqa: F401
    account_compile,
    account_host_sync,
    add_attr,
    configure,
    current_span,
    drain_ring,
    enabled,
    event,
    span,
)
