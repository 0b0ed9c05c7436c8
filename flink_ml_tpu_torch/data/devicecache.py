"""The device-resident epoch cache over the host data cache.

Port of flink_ml_tpu/data/devicecache.py (`:134`, `:231`). A bounded
iteration over a stream replays its batches every epoch; this keeps the
staged batches on the device, so a batch crosses to the device once:

- `within_device_budget` (`:66`): does an allocation fit that budget;
- `DeviceEpochCache`: a keyed LRU of staged batches under
  `config.device_cache_bytes` (None is unbounded, 0 caches nothing). An
  evicted batch stays in the host cache and is staged again when next
  asked for, so every budget computes the same result;
- `CachedEpochLoader`: the cache behind the one-worker `Prefetcher`. The
  worker resolves each key, a hit from the cache or a miss by
  `stage(key)`, up to `config.input_prefetch_depth` keys ahead, so batch
  b+1's cache read and copy run while batch b trains; results come in key
  order. A key that repeats the one before reuses its batch without a
  lookup or a copy, whatever the budget.

- `cache_contents_section` / `restore_cache_contents` (`:88-130`): the
  stream cache's contents as a snapshot section, so a resumed stream fit
  rebuilds its host cache from a sharded snapshot and does not read its
  input again. The section holds each segment as the JAX package's packed
  (batch, d + 2) [X | y | w] array, so either package restores the
  other's.

Accounting (the JAX package's, `:124-214`): every insert opens a
`batchCache` entry in the memory ledger (obs/memledger.py) and every
eviction, replacement or clear closes it, so the ledger's `batchCache`
live bytes equal the cache's `devicecache.bytes` gauge after any sequence
(`check_ledger_parity`); the counters `devicecache.hit`,
`devicecache.miss`, `devicecache.evict`, `devicecache.evictBytes`,
`devicecache.replaceBytes` and `devicecache.contents.restored`.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Iterable, Iterator, Optional

import numpy as np

from .. import config
from ..obs import memledger
from ..parallel.prefetch import Prefetcher, Staged
from ..utils import metrics

__all__ = ["DeviceEpochCache", "CachedEpochLoader", "within_device_budget",
           "cache_contents_section", "restore_cache_contents"]

_UNSET = object()


def within_device_budget(nbytes: int) -> bool:
    """Does a device allocation of `nbytes` fit `config.device_cache_bytes`?
    None is an unbounded budget (it fits), 0 a disabled cache (nothing fits)."""
    if config.device_cache_bytes is None:
        return True
    return int(nbytes) <= int(config.device_cache_bytes)


def _release_ledger_entries(handles) -> None:
    for handle in handles.values():
        memledger.release(handle)
    handles.clear()


class DeviceEpochCache:
    """Keyed LRU of staged batches (`Staged`) under a byte budget, each
    entry a `batchCache` entry of the memory ledger."""

    def __init__(self, budget_bytes=_UNSET):
        if budget_bytes is _UNSET:
            budget_bytes = config.device_cache_bytes
        self.budget_bytes: Optional[int] = None if budget_bytes is None else max(0, int(budget_bytes))
        self._entries: "OrderedDict[Hashable, Staged]" = OrderedDict()
        self._handles: Dict[Hashable, int] = {}  # key -> ledger handle
        self._used = 0
        self.hits = self.misses = self.evictions = 0
        # a cache dropped without clear() must not strand its ledger entries
        weakref.finalize(self, _release_ledger_entries, self._handles)

    @property
    def enabled(self) -> bool:
        return self.budget_bytes is None or self.budget_bytes > 0

    def get(self, key: Hashable) -> Optional[Staged]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            metrics.inc_counter("devicecache.miss")
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        metrics.inc_counter("devicecache.hit")
        return entry

    def put(self, key: Hashable, staged: Staged) -> bool:
        """Cache `staged`, evicting the least recently used entries while
        over budget; False when the budget cannot hold it at all."""
        nbytes = staged.nbytes
        if self.budget_bytes is not None and nbytes > self.budget_bytes:
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self._used -= old.nbytes
            memledger.release(self._handles.pop(key, None))
            metrics.inc_counter("devicecache.replaceBytes", old.nbytes)
        self._entries[key] = staged
        self._handles[key] = memledger.register("batchCache", nbytes)
        self._used += nbytes
        while self.budget_bytes is not None and self._used > self.budget_bytes:
            ev_key, evicted = self._entries.popitem(last=False)
            self._used -= evicted.nbytes
            memledger.release(self._handles.pop(ev_key, None))
            self.evictions += 1
            metrics.inc_counter("devicecache.evict")
            metrics.inc_counter("devicecache.evictBytes", evicted.nbytes)
        metrics.set_gauge("devicecache.bytes", self._used)
        return True

    def clear(self) -> None:
        _release_ledger_entries(self._handles)
        self._entries.clear()
        self._used = 0
        metrics.set_gauge("devicecache.bytes", 0)

    def check_ledger_parity(self) -> None:
        """Assert the ledger's `batchCache` live bytes equal this cache's
        own (exact while this is the only live DeviceEpochCache: the
        ledger's category is process-wide)."""
        ledgered = memledger.live_bytes("batchCache")
        assert ledgered == self._used, (
            f"ledger batchCache={ledgered} != devicecache bytes={self._used}")

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "residentBytes": self._used,
            "budgetBytes": -1 if self.budget_bytes is None else self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


class CachedEpochLoader:
    """Serve keyed batches from the device cache; misses are staged by
    `stage(key) -> Staged` on the prefetch worker, the only thread that
    touches the cache and the stager during an epoch."""

    def __init__(self, stage: Callable[[Hashable], Staged],
                 cache: Optional[DeviceEpochCache] = None, depth: Optional[int] = None):
        self.stage = stage
        self.cache = cache if cache is not None else DeviceEpochCache()
        self.depth = depth
        self._last: Optional[tuple] = None  # (key, staged) resolved last

    def _resolve(self, key: Hashable) -> Staged:
        if self._last is not None and self._last[0] == key:
            return self._last[1]
        staged = self.cache.get(key) if self.cache.enabled else None
        if staged is None:
            staged = self.stage(key)
            self.cache.put(key, staged)
        self._last = (key, staged)
        return staged

    def epoch(self, keys: Iterable[Hashable]) -> Iterator:
        """The device batch of each key, in order. Closing the generator
        early stops the staging worker; a stage error re-raises here."""
        return Prefetcher(self._resolve, self.depth, policy="block").iterate(keys)


# ---------------------------------------------------------------------------
# the cache's contents as a snapshot section (sharded snapshots)
# ---------------------------------------------------------------------------

def cache_contents_section(cache, segs, layout):
    """The stream cache's segments as the host arrays of a snapshot
    `cache` section, each the (batch, d + 2) [X | y | w] array of the JAX
    package's layout. Called once, at fit start, before the epoch loader's
    worker reads the (serial) cache; the saves close over the arrays."""
    out = []
    for seg in segs:
        X, y, w = layout.views(cache.read_array(seg))
        out.append(np.concatenate([X, y[:, None], w[:, None]], axis=1))
    return tuple(out)


def restore_cache_contents(snap, cache, layout):
    """Append a snapshot's `cache` section to a fresh cache in replay order
    as `layout`'s packed segments; returns (segment ids, layout), or None
    when the snapshot carries no cache contents (the caller then ingests
    the stream)."""
    section = snap.sections.get("cache")
    if section is None:
        return None
    flat = np.zeros(layout.size, np.float32)
    Xv, yv, wv = layout.views(flat)
    segs = []
    for arr in section:
        arr = np.asarray(arr, np.float32)
        if arr.shape != (layout.batch, layout.d + 2):
            return None
        Xv[:], yv[:], wv[:] = arr[:, :layout.d], arr[:, layout.d], arr[:, layout.d + 1]
        segs.append(cache.append_array(flat))
    metrics.inc_counter("devicecache.contents.restored", len(segs))
    return segs, layout
