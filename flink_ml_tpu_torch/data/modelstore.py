"""Multi-tenant model store: device memory paged at model-count scale.

Port of flink_ml_tpu/data/modelstore.py. A `ModelStore` holds registered
`(key -> model)` entries and pages each model's kernel constants between
host and card under an LRU byte budget (`config.model_store_bytes`):

- **Page-in rides the accounted upload.** `page_in` calls each served
  stage's `device_constants()`, which uploads the stage's packed host
  constants (`api.HostConstants`, page-locked, kept across page-outs)
  with one copy and ledgers the tensors under `model` (obs/memledger.py),
  so the store's bytes are the ledger's.
- **Page-out frees the card's bytes.** `invalidate_device_constants()`
  drops the only reference to the uploaded tensors: the ledger entries
  close at once (CPython refcounting) and the caching allocator takes the
  block back. A registered `PipelineModel` serves its constants as
  operands of captured graphs shared by its architecture
  (`PipelineModel.constants_as_operands`), so no graph keeps a paged-out
  model's constants alive and a page-in captures nothing.
- **Admission is conservative.** Eviction is driven by `_host_nbytes`, the
  bytes an upload allocates for the constants (each leaf in its host
  dtype, aligned to `HostConstants.ALIGN`, the buffer to the allocator's
  512), which bounds the ledgered bytes, so the store's ledgered residency
  stays within `budget_bytes`.

A key may carry a `lifecycle.ModelLifecycle` (promote through
`ModelStore.promote`, so the accounting follows the republish) and an
admission `quota`, which `serving.MicroBatchServer`'s per-tenant gates use.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from .. import config, flow
from ..api import AlgoOperator, HostConstants
from ..obs import memledger
from ..pipeline import PipelineModel
from ..utils import metrics

__all__ = ["ModelStore", "ModelStoreBudgetExceeded"]

_UNSET = object()
#: the caching allocator rounds a block up to this
_BLOCK_ALIGN = 512


class ModelStoreBudgetExceeded(RuntimeError):
    """One model's constants exceed the whole store budget: no eviction
    can make it fit."""

    def __init__(self, key: str, nbytes: int, budget: int):
        super().__init__(f"model {key!r} needs ~{nbytes} constant bytes but "
                         f"config.model_store_bytes={budget}")
        self.key, self.nbytes, self.budget = key, nbytes, budget


def _served_stages(model) -> List[Any]:
    """The stages whose `device_constants()` are the model's resident
    bytes: a PipelineModel's AlgoOperator stages, or the model itself."""
    if isinstance(model, PipelineModel):
        return [s for s in model.stages if isinstance(s, AlgoOperator)]
    if isinstance(model, AlgoOperator):
        return [model]
    raise TypeError(f"ModelStore pages PipelineModel/AlgoOperator stages, got {type(model).__name__}")


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def _host_nbytes(tree) -> int:
    """The device bytes an upload allocates for a kernel-constants tree
    (`HostConstants`): every leaf in its host dtype, aligned to
    `HostConstants.ALIGN`, the buffer rounded to 512 (0 for a tree without
    leaves)."""
    leaves: List[np.ndarray] = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            leaves.append(np.asarray(node))

    walk(tree)
    if not leaves:
        return 0
    return _round_up(sum(_round_up(a.nbytes, HostConstants.ALIGN) for a in leaves), _BLOCK_ALIGN)


@dataclass
class _StoredModel:
    model: Any
    stages: List[Any]
    lifecycle: Any = None
    quota: Optional[int] = None
    est_nbytes: int = 0  # the admission estimate
    dev_nbytes: int = 0  # ledgered bytes while resident
    resident: bool = False
    page_ins: int = 0


class ModelStore:
    """LRU-paged registry of served models, ledgered under `model`.

    `budget_bytes` defaults to `config.model_store_bytes` (None:
    unbounded). `acquire(key)` returns the model ready to dispatch, paging
    it in (and evicting the least recently used first) as needed;
    `prefetch(keys)` warms tenants off the dispatch path. All mutation is
    serialized by one lock, so a dispatch worker and a prefetch worker may
    share a store. The store owns paging from `register` on: registration
    drops constants uploaded before, and republishes go through `promote`
    (or `refresh(key)`) so the accounting follows the new arrays."""

    def __init__(self, budget_bytes=_UNSET, name: str = "modelstore"):
        self.name = name
        self._budget = config.model_store_bytes if budget_bytes is _UNSET else budget_bytes
        if self._budget is not None:
            self._budget = max(0, int(self._budget))
        self._entries: "OrderedDict[str, _StoredModel]" = OrderedDict()
        self._lock = threading.RLock()
        self._used = 0  # ledgered bytes of resident entries
        # the largest ledgered/estimated ratio seen (>= 1.0): reservations
        # are inflated by it should a model's uploads outgrow its estimate
        self._infl = 1.0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # -- registry ------------------------------------------------------------
    def register(self, key: str, model, lifecycle=None, quota: Optional[int] = None) -> None:
        """Add (or replace) a served model; `lifecycle` attaches a version
        ring, `quota` is the tenant's share of the admission queue."""
        stages = _served_stages(model)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None and old.resident:
                self._page_out_locked(key, old)
            entry = _StoredModel(model=model, stages=stages, lifecycle=lifecycle,
                                 quota=None if quota is None else max(1, int(quota)))
            if isinstance(model, PipelineModel):
                model.constants_as_operands()
            for stage in stages:  # start clean: the store owns residency now
                stage.invalidate_device_constants()
            entry.est_nbytes = sum(_host_nbytes(s._kernel_constants()) for s in stages)
            if self._budget is not None and entry.est_nbytes > self._budget:
                raise ModelStoreBudgetExceeded(key, entry.est_nbytes, self._budget)
            self._entries[key] = entry
            metrics.set_gauge("modelstore.models", len(self._entries))

    def unregister(self, key: str) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None and entry.resident:
                self._page_out_locked(key, entry)
            metrics.set_gauge("modelstore.models", len(self._entries))

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def lifecycle(self, key: str):
        return self._entry(key).lifecycle

    def quota(self, key: str) -> Optional[int]:
        return self._entry(key).quota

    def estimated_nbytes(self, key: str) -> int:
        """One model's admission estimate (what sizing a budget against N
        models costs)."""
        return self._entry(key).est_nbytes

    def _entry(self, key: str) -> _StoredModel:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                raise KeyError(f"model {key!r} is not registered in {self.name}")
            return entry

    # -- paging --------------------------------------------------------------
    def acquire(self, key: str):
        """The dispatch-path read: page `key` in if needed, mark it most
        recently used, return its model."""
        return self.page_in(key).model

    def page_in(self, key: str) -> _StoredModel:
        """Make `key` resident through each stage's `device_constants()`,
        evicting least recently used residents first so the estimated
        residency stays within the budget."""
        with self._lock:
            entry = self._entry(key)
            self._entries.move_to_end(key)
            if entry.resident and all("_device_consts" in s.__dict__ for s in entry.stages):
                self._hits += 1
                metrics.inc_counter("modelstore.hit")
                return entry
            self._misses += 1
            metrics.inc_counter("modelstore.miss")
            if entry.resident:
                # invalidated outside the store (a republish outside
                # `promote`): drop the stale accounting and upload again
                self._page_out_locked(key, entry, count_eviction=False)
            self._ensure_room(key, math.ceil(entry.est_nbytes * self._infl))
            dev = 0
            for stage in entry.stages:
                dev += memledger.tracked_nbytes(stage.device_constants())
            if entry.est_nbytes > 0:
                self._infl = max(self._infl, dev / entry.est_nbytes)
            entry.resident = True
            entry.dev_nbytes = dev
            entry.page_ins += 1
            self._used += dev
            metrics.inc_counter("modelstore.pageIn")
            metrics.inc_counter("modelstore.pageInBytes", dev)
            metrics.set_gauge("modelstore.bytes", self._used)
            return entry

    def page_out(self, key: str) -> None:
        """Release `key`'s device constants."""
        with self._lock:
            entry = self._entry(key)
            if entry.resident:
                self._page_out_locked(key, entry)

    def _page_out_locked(self, key: str, entry: _StoredModel, count_eviction: bool = True) -> None:
        for stage in entry.stages:
            stage.invalidate_device_constants()
        self._used -= entry.dev_nbytes
        if count_eviction:
            self._evictions += 1
            metrics.inc_counter("modelstore.evict")
            metrics.inc_counter("modelstore.evictBytes", entry.dev_nbytes)
        entry.resident = False
        entry.dev_nbytes = 0
        metrics.set_gauge("modelstore.bytes", self._used)

    def _ensure_room(self, incoming_key: str, est_nbytes: int) -> None:
        """Evict least recently used residents until the estimate fits."""
        if self._budget is None:
            return
        if est_nbytes > self._budget:
            raise ModelStoreBudgetExceeded(incoming_key, est_nbytes, self._budget)
        while self._used + est_nbytes > self._budget:
            victim = next((k for k, e in self._entries.items() if e.resident and k != incoming_key),
                          None)
            if victim is None:
                break
            self._page_out_locked(victim, self._entries[victim])

    def prefetch(self, keys: Iterable[str], wait: bool = True):
        """Page `keys` in ahead of their dispatches; `wait=False` pages on a
        `flow.spawn` worker and returns it."""
        keys = list(keys)

        def _warm():
            for k in keys:
                metrics.inc_counter("modelstore.prefetch")
                self.page_in(k)

        if wait:
            _warm()
            return None
        return flow.spawn(_warm, name=f"{self.name}.prefetch")

    def warmup_programs(self, server, example, buckets=None) -> Dict[str, float]:
        """Drive every (registered tenant x bucket) serving program once
        through `server` (a MicroBatchServer) ahead of traffic."""
        return server.warmup(example, tenants=self.keys(), buckets=buckets)

    # -- lifecycle -----------------------------------------------------------
    def promote(self, key: str, arrays: tuple, version: Optional[int] = None):
        """Promote a candidate through `key`'s lifecycle, then refresh the
        accounting (a resident entry uploads the new constants at once)."""
        entry = self._entry(key)
        if entry.lifecycle is None:
            raise ValueError(f"model {key!r} has no lifecycle attached")
        result = entry.lifecycle.promote(arrays, version=version)
        self.refresh(key)
        return result

    def refresh(self, key: str) -> None:
        """Re-sync the accounting after `key`'s arrays changed: a new
        estimate and, if resident, a new upload."""
        with self._lock:
            entry = self._entry(key)
            was_resident = entry.resident
            if was_resident:
                self._page_out_locked(key, entry, count_eviction=False)
            entry.est_nbytes = sum(_host_nbytes(s._kernel_constants()) for s in entry.stages)
            if self._budget is not None and entry.est_nbytes > self._budget:
                raise ModelStoreBudgetExceeded(key, entry.est_nbytes, self._budget)
            if was_resident:
                self.page_in(key)

    # -- introspection -------------------------------------------------------
    def resident_keys(self) -> List[str]:
        with self._lock:
            return [k for k, e in self._entries.items() if e.resident]

    @property
    def budget_bytes(self) -> Optional[int]:
        return self._budget

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "models": len(self._entries),
                "resident": sum(1 for e in self._entries.values() if e.resident),
                "bytes": self._used,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
            }

    def check_ledger_parity(self) -> None:
        """Assert the store's bytes equal the ledger's tracked bytes of every
        resident entry's constants."""
        with self._lock:
            tracked = 0
            for entry in self._entries.values():
                if not entry.resident:
                    continue
                for stage in entry.stages:
                    cached = stage.__dict__.get("_device_consts")
                    if cached is not None:
                        tracked += memledger.tracked_nbytes(cached[1])
            if tracked != self._used:
                raise AssertionError(
                    f"{self.name}: ledger parity broken — tracked {tracked} != accounted {self._used}")
