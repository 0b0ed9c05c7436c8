"""Fault-injection sites: the reference's `FailingMap` idiom.

Port of flink_ml_tpu/ckpt/faults.py. Two entry styles:

- `failing_map(items, after_records)`: wrap a stream; it raises
  `InjectedFault` once the cumulative record count crosses the threshold.
- `inject(site, after)` + `tick(site)`: code calls `tick(<site>)` at its
  boundaries; a test arms one plan and the matching tick raises.
- `flaky(site, times)`: the transient twin of `inject`: the site fails its
  first `times` hits with `TransientFault` (a `flow.TransientError`, so
  `flow.with_retries` retries it), then succeeds. `InjectedFault` models a
  crash and is never retried.

The sites the port ticks:

| site                     | boundary                                        |
|--------------------------|-------------------------------------------------|
| `chunk`                  | a checkpointed chunk drained (SGD, the fleet,   |
|                          | `iterate_bounded`)                              |
| `epoch`                  | a stream epoch (SGD `optimize_stream`, KMeans   |
|                          | out of core)                                    |
| `batch`                  | a global batch folded (`iterate_unbounded`)     |
| `snapshot.write`         | in `save_job_snapshot`, after the temp file,    |
|                          | before the atomic rename                        |
| `snapshot.read`          | in `load_job_snapshot`, before the npz opens    |
| `snapshot.shard.write`   | in one host's shard write, before its rename;   |
|                          | ticks once a host                               |
| `snapshot.commit`        | in the manifest commit, after every shard       |
|                          | landed, before the manifest's rename            |
| `snapshot.manifest.read` | in each manifest read of a sharded restore      |
| `snapshot.shard.read`    | in each shard-file read (restore, digesting)    |
| `datacache.append`       | in `DataCache.append_array`, before the write   |
| `datacache.read`         | in `DataCache.read_into`                        |
| `serving.batch`          | in `MicroBatchServer`'s batch dispatch          |
| `lifecycle.promote`      | at `ModelLifecycle.promote` entry               |
| `lifecycle.swap`         | in `promote`, after the snapshot, before the    |
|                          | pointer swap                                    |
| `host.die[.<phase>]`     | at every supervised boundary (parallel/         |
| `host.hang[.<phase>]`    | supervisor.py), phase `dispatch`, `collective`  |
|                          | or `commit`: a death stops the victim's         |
|                          | heartbeat, a hang blocks the fit thread         |

Disarmed cost is one module-global load per tick.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional

from ..flow import TransientError

__all__ = [
    "InjectedFault",
    "TransientFault",
    "FaultPlan",
    "FlakyPlan",
    "inject",
    "flaky",
    "tick",
    "armed",
    "failing_map",
]


class InjectedFault(RuntimeError):
    """The planted failure. Deliberately NOT a subclass of any framework
    error (and NOT a `flow.TransientError`): it models a crash, so tests
    assert the kill propagated un-swallowed — a retry wrapper that ate it
    would un-test the checkpoint path."""

    def __init__(self, site: str, hits: int):
        super().__init__(f"injected fault at site {site!r} (hit {hits})")
        self.site = site
        self.hits = hits


class TransientFault(TransientError):
    """The planted BLIP: raised by a `flaky` plan for the first N hits of
    its site, then the site succeeds. Subclasses `flow.TransientError`,
    so `flow.with_retries` treats it as retryable by contract."""

    def __init__(self, site: str, hits: int):
        super().__init__(f"transient fault at site {site!r} (hit {hits})")
        self.site = site
        self.hits = hits


@dataclass
class FaultPlan:
    """One armed failure: raise at the `after`-th hit of `site`."""

    site: str
    after: int
    hits: int = 0
    fired: bool = False


@dataclass
class FlakyPlan:
    """One armed transient: the first `times` hits of `site` raise
    `TransientFault`, every later hit passes."""

    site: str
    times: int
    hits: int = 0
    failures: int = 0


_plan: Optional[FaultPlan] = None
_flaky: Optional[FlakyPlan] = None


def armed() -> bool:
    return _plan is not None or _flaky is not None


@contextmanager
def inject(site: str, after: int = 1):
    """Arm a fault plan for the enclosed block (one plan at a time; plans
    restore on exit, so nesting shadows). Yields the plan so tests can
    inspect `hits`/`fired` afterwards."""
    global _plan
    prev = _plan
    plan = FaultPlan(site, max(1, int(after)))
    _plan = plan
    try:
        yield plan
    finally:
        _plan = prev


@contextmanager
def flaky(site: str, times: int = 1):
    """Arm a flaky plan for the enclosed block: `site` fails its first
    `times` hits with `TransientFault`, then succeeds (one flaky plan at
    a time; nesting shadows). Yields the plan so tests can assert
    `failures`/`hits` — e.g. that a retry loop paid exactly `times`
    retries before the site went healthy."""
    global _flaky
    prev = _flaky
    plan = FlakyPlan(site, max(1, int(times)))
    _flaky = plan
    try:
        yield plan
    finally:
        _flaky = prev


def tick(site: str, count: int = 1) -> None:
    """Record `count` hits of an injection site. Raises `InjectedFault`
    when an armed fatal plan's threshold is crossed (once — a fired plan
    stays quiet so cleanup code re-entering the site cannot
    double-throw), and `TransientFault` while an armed flaky plan still
    has failures to spend."""
    plan = _plan
    if plan is not None and not plan.fired and plan.site == site:
        plan.hits += count
        if plan.hits >= plan.after:
            plan.fired = True
            raise InjectedFault(site, plan.hits)
    fplan = _flaky
    if fplan is not None and fplan.site == site:
        fplan.hits += count
        if fplan.failures < fplan.times:
            fplan.failures += 1
            raise TransientFault(site, fplan.hits)


def _default_records(item: Any) -> int:
    """Record count of one stream item: a Table-like (num_rows), an
    (X, y, w) chunk tuple, or a bare array; anything else counts 1."""
    rows = getattr(item, "num_rows", None)
    if rows is not None:
        return int(rows)
    probe = item[0] if isinstance(item, tuple) and len(item) else item
    shape = getattr(probe, "shape", None)
    if shape:
        return int(shape[0])
    return 1


def failing_map(
    items: Iterable,
    after_records: int,
    site: str = "record",
    records: Optional[Callable[[Any], int]] = None,
) -> Iterator:
    """The FailingMap idiom: pass items through, raising `InjectedFault`
    once `after_records` cumulative records have been yielded. The item
    that crosses the threshold is NOT yielded (the failure lands at an
    arbitrary record boundary, mid-stream). Standalone — no `inject`
    arming required."""
    count = records if records is not None else _default_records
    seen = 0
    for item in items:
        seen += count(item)
        if seen >= after_records:
            raise InjectedFault(site, seen)
        yield item
