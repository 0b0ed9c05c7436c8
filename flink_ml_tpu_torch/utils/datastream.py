"""Batch helpers over Tables and StreamTables.

Port of flink_ml_tpu/utils/datastream.py (the reference's
DataStreamUtils.java: `aggregate` :182, `sample` :212, `mapPartition`
:115, `reduce` :132, `windowAllAndProcess` :262). A StreamTable is an
iterator of bounded Tables, so each helper is a host fold over batches.

- `sample` draws rows with numpy's `RandomState(seed)` in the JAX
  package's order of draws, so both packages keep the same rows.
- `window_all_and_process` re-chunks the input by a window descriptor
  (common/window.py). The row groups of the event-time windows are host
  int64 indices computed from the `timestamp` column as the JAX package
  computes them; `Table.take` of a group gathers tensor columns on their
  own device, so a device table is never read back but its timestamps.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, TypeVar, Union

import numpy as np

from ..common.window import (
    CountTumblingWindows,
    EventTimeSessionWindows,
    EventTimeTumblingWindows,
    GlobalWindows,
    ProcessingTimeSessionWindows,
    ProcessingTimeTumblingWindows,
)
from ..table import StreamTable, Table, _to_numpy

A = TypeVar("A")
R = TypeVar("R")

__all__ = [
    "aggregate",
    "event_time_window_groups",
    "event_time_groups_from_table",
    "iter_batches",
    "map_partition",
    "reduce",
    "sample",
    "window_all_and_process",
]


def iter_batches(data: Union[Table, StreamTable]) -> Iterable[Table]:
    """A bounded Table is a stream of one batch."""
    if isinstance(data, Table):
        return [data]
    return data


def _concat_all(tables: List[Table]) -> Table:
    """The batches' rows in order: one np.concatenate per column when every
    part of every column is a plain ndarray of one dtype, else a linear
    fold of Table.concat (tensor, sparse and token columns join there)."""
    if len(tables) == 1:
        return tables[0]
    cols = {}
    for name in tables[0].column_names:
        parts = [t.column(name) for t in tables]
        if not all(isinstance(x, np.ndarray) and x.dtype == parts[0].dtype for x in parts):
            break
        cols[name] = np.concatenate(parts)
    else:
        if all(t.column_names == tables[0].column_names for t in tables):
            return Table(cols)
    out = tables[0]
    for b in tables[1:]:
        out = out.concat(b)
    return out


def event_time_groups_from_table(table: Table, windows, timestamp_col: str = "timestamp"):
    """The event-time row groups of a table, from its timestamp column
    (read back when it is a tensor); raises without that column."""
    if timestamp_col not in table.column_names:
        raise ValueError(
            f"Event-time windows need a {timestamp_col!r} column carrying "
            "each record's event time in milliseconds"
        )
    return event_time_window_groups(_to_numpy(table.column(timestamp_col)), windows)


def aggregate(
    data: Union[Table, StreamTable],
    create_accumulator: Callable[[], A],
    add: Callable[[A, Table], A],
    get_result: Callable[[A], R],
    merge: Optional[Callable[[A, A], A]] = None,
) -> R:
    """Fold every batch into an accumulator, then extract the result. `add`
    takes a whole batch; `merge` is accepted for the reference's signature
    (callers that combine per-shard accumulators do it themselves)."""
    acc = create_accumulator()
    for batch in iter_batches(data):
        acc = add(acc, batch)
    return get_result(acc)


def sample(data: Union[Table, StreamTable], num_samples: int, seed: int = 0) -> Table:
    """A uniform reservoir sample of `num_samples` rows without replacement
    (Algorithm R, one draw call per batch): the first rows fill the
    reservoir; then row i of the stream (1-based) replaces a uniform slot
    with probability k / i, later rows of a batch winning a shared slot."""
    if num_samples <= 0:
        raise ValueError("num_samples must be > 0")
    rng = np.random.RandomState(seed)
    reservoir: Optional[Table] = None
    seen = 0
    for batch in iter_batches(data):
        n = batch.num_rows
        if n == 0:
            continue
        if reservoir is None or reservoir.num_rows < num_samples:
            have = 0 if reservoir is None else reservoir.num_rows
            take = min(num_samples - have, n)
            head = batch.take(np.arange(take))
            reservoir = head if reservoir is None else reservoir.concat(head)
            seen += take
            if take == n:
                continue
            batch = batch.take(np.arange(take, n))
            n = batch.num_rows
        global_idx = seen + np.arange(n) + 1
        accept = rng.random(n) < num_samples / global_idx
        slots = rng.randint(0, num_samples, size=n)
        seen += n
        if not np.any(accept):
            continue
        incoming: List[int] = [-1] * num_samples
        for i in np.nonzero(accept)[0]:
            incoming[slots[i]] = int(i)
        repl_slots = [s for s, i in enumerate(incoming) if i >= 0]
        repl_idx = [incoming[s] for s in repl_slots]
        survivors = np.setdiff1d(np.arange(reservoir.num_rows),
                                 np.asarray(repl_slots, dtype=np.int64))
        reservoir = reservoir.take(survivors).concat(
            batch.take(np.asarray(repl_idx, dtype=np.int64)))
    if reservoir is None:
        raise ValueError("cannot sample from an empty stream")
    return reservoir


def map_partition(
    data: Union[Table, StreamTable], fn: Callable[[Table], Table]
) -> Union[Table, StreamTable]:
    """`fn` of each bounded batch: a Table maps to a Table, a StreamTable
    lazily batch by batch."""
    if isinstance(data, Table):
        return fn(data)
    return StreamTable(fn(batch) for batch in data)


def reduce(data: Union[Table, StreamTable], fn: Callable[[Table, Table], Table]) -> Table:
    """Every batch folded pairwise into one Table."""
    acc = None
    for batch in iter_batches(data):
        acc = batch if acc is None else fn(acc, batch)
    if acc is None:
        raise ValueError("reduce over an empty stream")
    return acc


def event_time_window_groups(timestamps: np.ndarray, windows) -> List[np.ndarray]:
    """Row-index groups (int64) of event-time windows over a bounded input,
    in firing order (window start, session start).

    Tumbling (TumblingEventTimeWindows.assignWindows): a record at time t
    belongs to the window that starts at ``t - (t % size)``, epoch-aligned
    (numpy's % floors, so negative times align too). Session: windows merge
    while consecutive event times are within ``gap`` of each other."""
    ts = np.asarray(timestamps, dtype=np.int64)
    if isinstance(windows, EventTimeTumblingWindows):
        size = int(windows.size_ms)
        if size <= 0:
            raise ValueError("Event-time tumbling window size must be positive")
        starts = ts - (ts % size)
        order = np.argsort(starts, kind="stable")
        uniq, first = np.unique(starts[order], return_index=True)
        bounds = list(first) + [len(order)]
        return [order[bounds[i]: bounds[i + 1]] for i in range(len(uniq))]
    if isinstance(windows, EventTimeSessionWindows):
        gap = int(windows.gap_ms)
        if gap <= 0:
            raise ValueError("Session gap must be positive")
        order = np.argsort(ts, kind="stable")
        if order.size == 0:
            return []
        breaks = np.nonzero(np.diff(ts[order]) > gap)[0] + 1
        return [np.sort(g) for g in np.split(order, breaks)]
    raise TypeError(f"Not an event-time descriptor: {type(windows).__name__}")


def window_all_and_process(
    data: Union[Table, StreamTable],
    windows,
    fn: Callable[[Table], Table],
    timestamp_col: str = "timestamp",
    clock: Optional[Callable[[], float]] = None,
) -> Union[Table, StreamTable]:
    """`fn` of each window of the input (DataStreamUtils.windowAllAndProcess).

    - GlobalWindows: one window over the whole bounded input (a StreamTable
      is materialised first, so pass bounded streams only).
    - CountTumblingWindows(k): windows of exactly k rows; count windows
      fire only when full, so the ragged tail is dropped.
    - Event-time windows: each record's time (ms) from `timestamp_col`;
      the windows fire in window-start order once the input ends.
    - Processing-time windows: each incoming batch is stamped with
      `clock()` (seconds, default time.monotonic; inject one for tests) and
      a window fires when a batch arrives past its boundary. A bounded
      Table arrives at one instant and is one window.

    A Table in gives a Table out (the windows' results concatenated, or a
    column-less empty Table when no window fires); a StreamTable in gives
    a StreamTable of the results."""
    import time as _time

    if isinstance(windows, (EventTimeTumblingWindows, EventTimeSessionWindows)):
        batches = list(iter_batches(data))
        if not batches:
            return StreamTable([]) if isinstance(data, StreamTable) else Table({})
        whole = _concat_all(batches)
        groups = event_time_groups_from_table(whole, windows, timestamp_col)
        results = [fn(whole.take(g)) for g in groups]
        if isinstance(data, StreamTable):
            return StreamTable(results)
        if not results:
            return Table({})
        return _concat_all(results)

    if isinstance(windows, (ProcessingTimeTumblingWindows, ProcessingTimeSessionWindows)):
        # an invalid descriptor fails whatever the input
        if isinstance(windows, ProcessingTimeTumblingWindows):
            size_s = int(windows.size_ms) / 1000.0
            if size_s <= 0:
                raise ValueError("Processing-time window size must be positive")
        else:
            gap_s = int(windows.gap_ms) / 1000.0
            if gap_s <= 0:
                raise ValueError("Session gap must be positive")
        if isinstance(data, Table):
            return fn(data)
        clock = clock or _time.monotonic
        if isinstance(windows, ProcessingTimeTumblingWindows):

            def proc_chunks() -> Iterable[Table]:
                pending: List[Table] = []
                window_end: Optional[float] = None
                for batch in data:
                    now = clock()
                    if window_end is None:
                        window_end = (now // size_s + 1) * size_s
                    elif now >= window_end:
                        if pending:
                            yield _concat_all(pending)
                        pending = []
                        window_end = (now // size_s + 1) * size_s
                    pending.append(batch)
                if pending:
                    yield _concat_all(pending)

            return StreamTable(fn(w) for w in proc_chunks())

        def session_chunks() -> Iterable[Table]:
            pending: List[Table] = []
            last: Optional[float] = None
            for batch in data:
                now = clock()
                if last is not None and now - last > gap_s and pending:
                    yield _concat_all(pending)
                    pending = []
                pending.append(batch)
                last = now
            if pending:
                yield _concat_all(pending)

        return StreamTable(fn(w) for w in session_chunks())

    if isinstance(windows, GlobalWindows):
        batches = list(iter_batches(data))
        if not batches:
            return StreamTable([]) if isinstance(data, StreamTable) else Table({})
        result = fn(_concat_all(batches))
        return StreamTable([result]) if isinstance(data, StreamTable) else result
    if isinstance(windows, CountTumblingWindows):
        size = int(windows.size)

        def chunks() -> Iterable[Table]:
            # whole batches gather until a window is full, then one concat
            # a fired window (re-concatenating per batch would be quadratic)
            pending: List[Table] = []
            pending_rows = 0
            for batch in iter_batches(data):
                pending.append(batch)
                pending_rows += batch.num_rows
                while pending_rows >= size:
                    merged = _concat_all(pending)
                    off = 0
                    while merged.num_rows - off >= size:
                        yield merged.take(np.arange(off, off + size))
                        off += size
                    pending = ([merged.take(np.arange(off, merged.num_rows))]
                               if off < merged.num_rows else [])
                    pending_rows = merged.num_rows - off

        if isinstance(data, Table):
            results = [fn(w) for w in chunks()]
            if not results:
                return Table({})
            out = results[0]
            for r in results[1:]:
                out = out.concat(r)
            return out
        return StreamTable(fn(w) for w in chunks())
    raise NotImplementedError(
        f"{type(windows).__name__} needs event-/processing-time semantics; "
        "use the online iteration runtime for time windows"
    )
