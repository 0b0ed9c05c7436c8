"""The spillable data cache and replayable streams.

Port of flink_ml_tpu/native/datacache.py over the same C++ segment store
(native/src/datacache.cc; the reference's datacache/nonkeyed/
DataCacheWriter.java, ReplayOperator.java:125-246):

- `DataCache` appends host arrays as segments, in memory until the budget
  is spent, then to a spill file; a segment reads back into a new array or
  straight into a caller's buffer (a pinned staging buffer, say);
- `ReplayableStreamTable` caches a one-shot stream of Tables on its first
  pass so that every later pass replays it. A partly consumed pass still
  leaves later passes complete: each pass replays what is cached, then goes
  on reading the source.

Spill I/O runs under `flow.with_retries` with the JAX package's fault
sites (`:60-121`): `datacache.append` ticks before the native write, whose
failure commits no segment, so a retried append never appends twice;
`datacache.read` ticks inside the (idempotent) read. Accounting, with
the JAX package's names: `datacache.append`, `datacache.appendBytes`,
`datacache.hit` / `datacache.miss` (a read of an in-memory or a spilled
segment), `datacache.readBytes`, `datacache.evict` and a `cache.evict`
event (category `cache`) for a segment that spilled. The JAX package's
pure-Python cache is not ported: the library builds at first use or the
cache raises.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import flow
from ..ckpt import faults
from ..obs import tracing
from ..utils import metrics
from ..table import SparseBatch, Table, _to_numpy
from . import load as _load_native


def _destroy(lib, handle, spill_path) -> None:
    lib.dc_destroy(handle)
    # dc_destroy removes the spill file it opened; a file left by a failed
    # native write goes too
    if os.path.exists(spill_path):
        os.remove(spill_path)


class DataCache:
    """Append-only segment cache with a memory budget and disk spill."""

    def __init__(self, memory_budget_bytes: int = 64 << 20, spill_dir: Optional[str] = None):
        self._lib = _load_native()
        self._meta: List[Tuple[np.dtype, tuple]] = []  # per segment
        self._spilled: List[bool] = []  # per segment: written to the spill file
        spill_dir = spill_dir or tempfile.gettempdir()
        self.spill_path = os.path.join(
            spill_dir, f"flink_ml_tpu_torch_cache_{os.getpid()}_{id(self):x}.bin"
        )
        self._handle = self._lib.dc_create(
            ctypes.c_uint64(int(memory_budget_bytes)), self.spill_path.encode()
        )
        self._finalizer = weakref.finalize(
            self, _destroy, self._lib, self._handle, self.spill_path
        )

    def append_array(self, array: np.ndarray) -> int:
        """Copy `array` into a new segment; returns its id."""
        array = np.asarray(array)
        shape = array.shape
        array = np.ascontiguousarray(array)  # a 0-d array becomes 1-d

        def append() -> int:
            # the retried unit: a failed dc_append commits no segment, and
            # the site ticks before the write, so a retry appends once
            faults.tick("datacache.append")
            seg = self._lib.dc_append(
                self._handle, array.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(array.nbytes)
            )
            if seg < 0:
                raise IOError(f"native data cache append failed (spill file {self.spill_path})")
            return int(seg)

        metrics.inc_counter("datacache.append")
        metrics.inc_counter("datacache.appendBytes", int(array.nbytes))
        spilled_before = self.spilled_segments
        seg = flow.with_retries(append, site="datacache.append")
        self._meta.append((array.dtype, shape))
        spilled = self.spilled_segments > spilled_before
        self._spilled.append(spilled)
        if spilled:  # over budget: this segment went to the spill file
            metrics.inc_counter("datacache.evict")
            tracing.event("cache.evict", category="cache", bytes=int(array.nbytes), seg=int(seg))
        return seg

    def segment_shape(self, seg: int) -> tuple:
        return self._meta[seg][1]

    def segment_nbytes(self, seg: int) -> int:
        dtype, shape = self._meta[seg]
        return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize

    def read_into(self, seg: int, out: np.ndarray) -> np.ndarray:
        """Copy segment `seg` into the front of the C-contiguous buffer
        `out`; returns that part of `out` as the segment's dtype and shape."""
        dtype, shape = self._meta[seg]
        nbytes = self.segment_nbytes(seg)
        if not out.flags.c_contiguous or not out.flags.writeable or out.nbytes < nbytes:
            raise ValueError(f"segment {seg} needs a writable contiguous buffer of {nbytes} bytes")

        def read() -> None:
            # the retried unit: a segment read is idempotent
            faults.tick("datacache.read")
            rc = self._lib.dc_read(self._handle, seg, out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IOError(f"native data cache read of segment {seg} failed with code {rc}")

        spilled = seg < len(self._spilled) and self._spilled[seg]
        metrics.inc_counter("datacache.miss" if spilled else "datacache.hit")
        flow.with_retries(read, site="datacache.read")
        metrics.inc_counter("datacache.readBytes", nbytes)
        return out.reshape(-1).view(np.uint8)[:nbytes].view(dtype).reshape(shape)

    def read_array(self, seg: int) -> np.ndarray:
        return self.read_into(seg, np.empty(self.segment_nbytes(seg), np.uint8))

    @property
    def num_segments(self) -> int:
        return int(self._lib.dc_num_segments(self._handle))

    @property
    def spilled_segments(self) -> int:
        return int(self._lib.dc_spilled_segments(self._handle))

    @property
    def memory_used(self) -> int:
        return int(self._lib.dc_memory_used(self._handle))

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "numSegments": self.num_segments,
            "spilledSegments": self.spilled_segments,
            "memoryUsedBytes": self.memory_used,
        }

    def close(self) -> None:
        """Free the segments and remove the spill file; idempotent."""
        self._finalizer()


class ReplayableStreamTable:
    """Caches a one-shot batch stream so that it replays on every pass
    (ReplayOperator.java semantics). Columns must be numeric or sparse."""

    def __init__(self, batches, memory_budget_bytes: int = 64 << 20,
                 spill_dir: Optional[str] = None):
        self._source = iter(batches)
        self._cache = DataCache(memory_budget_bytes, spill_dir)
        self._schemas: List[Dict] = []  # per batch: {col: (kind, ...segment ids)}
        self._exhausted = False

    def _cache_batch(self, table: Table) -> None:
        schema = {}
        for name in table.column_names:
            col = table.column(name)
            if isinstance(col, SparseBatch):
                schema[name] = (
                    "sparse",
                    col.size,
                    self._cache.append_array(_to_numpy(col.indices)),
                    self._cache.append_array(_to_numpy(col.values)),
                )
            else:
                arr = _to_numpy(col)
                if arr.dtype == object:
                    raise TypeError(
                        f"Column {name!r} holds python objects; only numeric "
                        "and sparse columns can be cached natively"
                    )
                schema[name] = ("dense", self._cache.append_array(arr))
        self._schemas.append(schema)

    def _restore_batch(self, schema: Dict, columns=None) -> Table:
        cols = {}
        for name, spec in schema.items():
            if columns is not None and name not in columns:
                continue
            if spec[0] == "sparse":
                _, size, seg_i, seg_v = spec
                cols[name] = SparseBatch(
                    size, self._cache.read_array(seg_i), self._cache.read_array(seg_v)
                )
            else:
                cols[name] = self._cache.read_array(spec[1])
        return Table(cols)

    def __iter__(self) -> Iterator[Table]:
        for schema in list(self._schemas):
            yield self._restore_batch(schema)
        if not self._exhausted:
            for table in self._source:
                self._cache_batch(table)
                yield table
            self._exhausted = True

    def batch_rows(self) -> List[int]:
        """Cache what is left of the source; returns the row count of every
        batch, read from the cache's segment shapes."""
        if not self._exhausted:
            for table in self._source:
                self._cache_batch(table)
            self._exhausted = True
        return [self._rows(schema) for schema in self._schemas]

    def _rows(self, schema: Dict) -> int:
        for spec in schema.values():  # every column has the batch's rows
            return self._cache.segment_shape(spec[-1])[0]
        return 0

    def batch(self, i: int, columns=None) -> Table:
        """Cached batch `i`, with only `columns` when given."""
        return self._restore_batch(self._schemas[i], columns)

    @property
    def stats(self) -> Dict[str, int]:
        return self._cache.stats

    def close(self) -> None:
        self._cache.close()
