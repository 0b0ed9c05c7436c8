"""Device-memory ledger: live bytes by category, peaks, budget admission.

Port of the ledger of flink_ml_tpu/obs/memledger.py over torch tensors.
The accounted staging funnel (`parallel/prefetch.py`), the constant
upload (`api.HostConstants`) and a server's window (`serving.py`) report
here:

- **Ownership entries** (`register`/`release`): the owner knows the
  allocation's lifetime exactly (a served batch's upload, from dispatch to
  retirement).
- **Tracked trees** (`track`): each tensor leaf of a tree (tensors and
  `SparseBatch` leaves in dicts, lists and tuples) gets a
  `weakref.finalize` that releases its entry when the tensor object dies.
  A model's constants (`model`) are tracked, so `hbm.live.model` falls
  the moment a model store drops a model's constants (CPython
  refcounting), and `live_bytes("model")` is the store's residency.

Surfaces: the gauges `hbm.live.<category>`, `hbm.live`, `hbm.peak` and
`hbm.peak.fit` (through `utils.metrics`); the `memory` lane of the
timeline; `mark_peak()`/`peak_since(tok)` watermark tokens, and
`fit_peak_scope` (every stage's fit runs in one: obs/tracing.py) and
`record_fleet_fit_peak` for the per-fit and per-member peaks; budget
admission against `config.hbm_budget_bytes` (`admit` raises the typed
`HbmBudgetExceeded` before the allocating copy; a budget that never fires
changes nothing); `wrap_oom`, which turns a `torch.cuda.OutOfMemoryError`
into `HbmExhausted` carrying the ledger's snapshot (also written to
`FLINK_ML_TPU_HBM_DUMP` when set); `ranked_entries`, `snapshot`,
`dump_snapshot` and `load_dump` for the forensic view. The ledger sees
what is tracked or registered (the staged fit inputs, the program
funnel's static buffers, the epoch cache, model constants, served
batches), not a kernel's temporaries: `torch.cuda.max_memory_allocated`
sees those too.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from ..utils import metrics

__all__ = [
    "CATEGORIES",
    "HbmBudgetExceeded",
    "HbmExhausted",
    "register",
    "release",
    "track",
    "tracked_nbytes",
    "admit",
    "wrap_oom",
    "live_bytes",
    "peak_bytes",
    "mark_peak",
    "peak_since",
    "fit_peak_scope",
    "record_fleet_fit_peak",
    "snapshot",
    "ranked_entries",
    "dump_snapshot",
    "load_dump",
    "reset",
]

#: The residency categories; `scratch` is the catch-all for explicitly
#: tracked transients.
CATEGORIES = ("model", "optimizer", "batchCache", "streamSegments", "serving", "fleet", "scratch")

_lock = threading.Lock()
#: (key, handle) of tracked tensors that died while the lock was held: a
#: finalizer may run inside a locked section (the garbage collector runs
#: at any allocation), where taking the lock again would deadlock
# tpulint: disable=unbounded-queue -- one entry a dead tracked tensor; the next release drains
_pending: deque = deque()
_ids = itertools.count(1)
#: handle -> (category, nbytes, shape, dtype, site)
_entries: Dict[int, Tuple[str, int, Optional[Tuple], Optional[str], str]] = {}
_live: Dict[str, int] = {}
_total = 0
_peak = 0
_marks: Dict[int, int] = {}  # mark token -> max total seen since the mark
#: id(tensor) -> ledger handle, so tracking one tensor twice counts once
_tracked_ids: Dict[int, int] = {}


class HbmBudgetExceeded(RuntimeError):
    """A staging request would exceed `config.hbm_budget_bytes`. Raised
    before the allocating copy; carries `requested_bytes`, `budget_bytes`,
    `live_bytes` and the per-category `breakdown`."""

    def __init__(self, requested_bytes: int, budget_bytes: int, live: Dict[str, int],
                 category: Optional[str] = None):
        self.requested_bytes = int(requested_bytes)
        self.budget_bytes = int(budget_bytes)
        self.live_bytes = int(sum(live.values()))
        self.breakdown = dict(sorted(live.items(), key=lambda kv: -kv[1]))
        self.category = category
        held = ", ".join(f"{k}={v}" for k, v in self.breakdown.items()) or "nothing ledgered"
        super().__init__(
            f"staging {self.requested_bytes} bytes"
            + (f" ({category})" if category else "")
            + f" would exceed hbm_budget_bytes={self.budget_bytes}: "
            f"{self.live_bytes} bytes live ({held})"
        )


class HbmExhausted(RuntimeError):
    """A real out-of-memory error of the card, with the ledger's snapshot
    (`snapshot`: top entries by bytes, categories and allocation sites) at
    failure time. The original error is chained as `__cause__`."""

    def __init__(self, message: str, snap: Dict[str, Any]):
        self.snapshot = snap
        top = "; ".join(f"{e['category']}:{e['nbytes']}b@{e['site']}"
                        for e in snap.get("topEntries", [])[:3])
        super().__init__(
            f"device memory exhausted: {message} — ledger: {snap.get('liveBytes', 0)} bytes "
            f"live, peak {snap.get('peakBytes', 0)}" + (f"; top: {top}" if top else "")
        )


@contextmanager
def _locked():
    """Hold `_lock`; the releases of tensors that died meanwhile are applied
    before it is let go."""
    with _lock:
        _drain_pending()
        yield
        _drain_pending()


def _drain_pending() -> None:
    while _pending:
        key, handle = _pending.popleft()
        if _tracked_ids.get(key) == handle:
            del _tracked_ids[key]
        _release_locked(handle)


def _call_site() -> str:
    """file:line of the nearest caller outside the funnel plumbing."""
    skip = ("memledger.py", "prefetch.py", "api.py")
    f = sys._getframe(1)
    while f is not None:
        fname = f.f_code.co_filename
        if not fname.endswith(skip):
            base = os.path.basename(os.path.dirname(fname))
            return f"{base}/{os.path.basename(fname)}:{f.f_lineno}"
        f = f.f_back
    return "unknown"


def _publish_locked(category: str) -> None:
    """Refresh gauges, peak and timeline after a change; holds `_lock`."""
    global _peak
    metrics.set_gauge(f"hbm.live.{category}", _live.get(category, 0))
    metrics.set_gauge("hbm.live", _total)
    if _total > _peak:
        _peak = _total
        metrics.set_gauge("hbm.peak", _peak)
    for tok in _marks:
        if _total > _marks[tok]:
            _marks[tok] = _total
    from . import timeline

    if timeline.enabled():
        timeline.record_counter(timeline.LANE_MEMORY, "hbm",
                                **{c: _live.get(c, 0) for c in CATEGORIES if _live.get(c)})


def register(category: str, nbytes: int, shape: Optional[Tuple] = None,
             dtype: Optional[str] = None, site: Optional[str] = None) -> int:
    """Open an entry: `nbytes` of device memory became resident under
    `category`. Returns the handle to `release`."""
    global _total
    if category not in CATEGORIES:
        raise ValueError(f"unknown ledger category {category!r} (see CATEGORIES)")
    nbytes = int(nbytes)
    if site is None:
        site = _call_site()
    with _locked():
        handle = next(_ids)
        _entries[handle] = (category, nbytes, shape, dtype, site)
        _live[category] = _live.get(category, 0) + nbytes
        _total += nbytes
        _publish_locked(category)
    return handle


def release(handle: Optional[int]) -> None:
    """Close an entry (idempotent; None and unknown handles are no-ops)."""
    if handle is None:
        return
    with _locked():
        _release_locked(handle)


def _release_locked(handle: int) -> None:
    global _total
    entry = _entries.pop(handle, None)
    if entry is None:
        return
    category, nbytes = entry[0], entry[1]
    _live[category] = _live.get(category, 0) - nbytes
    _total -= nbytes
    _publish_locked(category)


def _leaf_tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and SparseBatches."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _leaf_tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaf_tensors(value)
    elif hasattr(tree, "indices") and hasattr(tree, "values"):  # a SparseBatch
        yield from _leaf_tensors((tree.indices, tree.values))


def track(tree, category: str, site: Optional[str] = None):
    """Ledger every tensor leaf of `tree` under `category`, releasing each
    entry when its tensor object dies. A tensor already tracked counts
    once. Returns `tree`."""
    if site is None:
        site = _call_site()
    for t in _leaf_tensors(tree):
        key = id(t)
        with _locked():
            if key in _tracked_ids:
                continue
        handle = register(category, t.numel() * t.element_size(), shape=tuple(t.shape),
                          dtype=str(t.dtype), site=site)
        with _locked():
            _tracked_ids[key] = handle
        weakref.finalize(t, _release_tracked, key, handle)
    return tree


def _release_tracked(key: int, handle: int) -> None:
    """A tracked tensor's finalizer: its release now if the lock is free,
    else when its holder lets it go (`_locked`)."""
    _pending.append((key, handle))
    if _lock.acquire(blocking=False):
        try:
            _drain_pending()
        finally:
            _lock.release()


def tracked_nbytes(tree) -> int:
    """Ledgered bytes of `tree`'s tensor leaves (0 for untracked ones)."""
    total = 0
    with _locked():
        for t in _leaf_tensors(tree):
            handle = _tracked_ids.get(id(t))
            if handle is not None and handle in _entries:
                total += _entries[handle][1]
    return total


def live_bytes(category: Optional[str] = None) -> int:
    with _locked():
        return _total if category is None else _live.get(category, 0)


def peak_bytes() -> int:
    with _locked():
        return _peak


def mark_peak() -> int:
    """Open a watermark: `peak_since(tok)` returns the most total live
    bytes seen between the mark and the query."""
    with _locked():
        tok = next(_ids)
        _marks[tok] = _total
        return tok


def peak_since(token: int, close: bool = True) -> int:
    with _locked():
        value = _marks.get(token, 0)
        if close:
            _marks.pop(token, None)
        return value


#: fleets larger than this record only the first this-many member gauges
_FLEET_MEMBER_GAUGE_CAP = 64


class fit_peak_scope:
    """Context manager bracketing one fit: on exit, the peak live bytes
    seen inside the scope land on the `hbm.peak.fit` gauge (and on
    `hbm.peak.fit.member.<i>` for a fleet member `member`)."""

    def __init__(self, member: Optional[int] = None):
        self._member = member

    def __enter__(self):
        self._tok = mark_peak()
        return self

    def __exit__(self, *exc):
        peak = peak_since(self._tok)
        metrics.set_gauge("hbm.peak.fit", peak)
        if self._member is not None and self._member < _FLEET_MEMBER_GAUGE_CAP:
            metrics.set_gauge(f"hbm.peak.fit.member.{self._member}", peak)
        return False


def record_fleet_fit_peak(peak: int, num_members: int) -> None:
    """A fleet fit is one program: its one watermark is every member's
    (on the first `_FLEET_MEMBER_GAUGE_CAP` member gauges)."""
    metrics.set_gauge("hbm.peak.fit", peak)
    for i in range(min(num_members, _FLEET_MEMBER_GAUGE_CAP)):
        metrics.set_gauge(f"hbm.peak.fit.member.{i}", peak)


def admit(nbytes: int, category: Optional[str] = None) -> None:
    """Raise `HbmBudgetExceeded` when staging `nbytes` more would push the
    ledgered live bytes over `config.hbm_budget_bytes` (None: always
    admit). Admission never changes state."""
    from .. import config

    budget = config.hbm_budget_bytes
    if budget is None or nbytes <= 0:
        return
    with _locked():
        total = _total
        live = {c: b for c, b in _live.items() if b}
    if total + int(nbytes) > int(budget):
        metrics.inc_counter("hbm.budget.rejected")
        raise HbmBudgetExceeded(int(nbytes), int(budget), live, category)


def wrap_oom(exc: BaseException) -> Optional[HbmExhausted]:
    """`HbmExhausted` carrying the ledger's snapshot if `exc` is the card's
    out-of-memory error, else None; callers raise it `from exc`."""
    if not isinstance(exc, torch.cuda.OutOfMemoryError):
        return None
    metrics.inc_counter("hbm.exhausted")
    snap = snapshot()
    dump_path = os.environ.get("FLINK_ML_TPU_HBM_DUMP")
    if dump_path:
        try:
            dump_snapshot(dump_path, snap)
        except OSError:
            pass
    msg = str(exc)
    return HbmExhausted(msg.splitlines()[0] if msg else type(exc).__name__, snap)


def ranked_entries(top_n: int = 20) -> List[Dict[str, Any]]:
    """The live entries ranked by bytes, largest first."""
    with _locked():
        entries = list(_entries.values())
    entries.sort(key=lambda e: -e[1])
    return [{"category": cat, "nbytes": nbytes, "shape": list(shape) if shape else None,
             "dtype": dtype, "site": site}
            for cat, nbytes, shape, dtype, site in entries[:top_n]]


def snapshot(top_n: int = 20) -> Dict[str, Any]:
    """Per-category live bytes, totals, peak and the top-N entries."""
    with _locked():
        live = {c: b for c, b in _live.items() if b}
        total, peak, entry_count = _total, _peak, len(_entries)
    return {"liveBytes": total, "peakBytes": peak, "entryCount": entry_count,
            "categories": dict(sorted(live.items(), key=lambda kv: -kv[1])),
            "topEntries": ranked_entries(top_n)}


def dump_snapshot(path: str, snap: Optional[Dict[str, Any]] = None) -> Dict:
    """Write the forensic snapshot as JSON (the `HbmExhausted` dump)."""
    snap = snap if snap is not None else snapshot()
    with open(path, "w") as f:
        json.dump(snap, f, indent=2)
    return snap


def load_dump(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def reset() -> None:
    """Forget every entry and the peak (tests); finalizers of tensors still
    alive later release unknown handles, which are no-ops."""
    global _total, _peak
    with _locked():
        _pending.clear()
        _entries.clear()
        _live.clear()
        _tracked_ids.clear()
        _marks.clear()
        _total = 0
        _peak = 0
    for c in CATEGORIES:
        metrics.set_gauge(f"hbm.live.{c}", 0)
    metrics.set_gauge("hbm.live", 0)
    metrics.set_gauge("hbm.peak", 0)
