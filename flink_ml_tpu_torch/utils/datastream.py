"""Batch helpers over Tables and StreamTables.

Port of `iter_batches` and `sample` of flink_ml_tpu/utils/datastream.py
(the reference's DataStreamUtils.sample, DataStreamUtils.java:212). A
StreamTable is an iterator of bounded Tables, so the reservoir is a host
fold over batches. Rows are drawn with numpy's `RandomState(seed)` in the
JAX package's order of draws, so both packages keep the same rows; the
reservoir itself is a Table built with `take` and `concat`, and tensor
columns stay on their device.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

import numpy as np

from ..table import StreamTable, Table

__all__ = ["iter_batches", "sample"]


def iter_batches(data: Union[Table, StreamTable]) -> Iterable[Table]:
    """A bounded Table is a stream of one batch."""
    if isinstance(data, Table):
        return [data]
    return data


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
