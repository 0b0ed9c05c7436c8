"""Input staging: accounted host-to-device copies, shape buckets and a
one-worker prefetcher.

Port of flink_ml_tpu/parallel/prefetch.py (`:114`, `:136`, `:214-262`,
`:275-319`):

- `DeviceStager` stages host arrays to one device. On a CUDA device it
  copies each batch into one of a small ring of pinned host buffers, then
  to the device with one `non_blocking` copy on a side stream, and records
  an event there. The caller gets a `Staged` handle, whose `wait()` makes
  the consuming thread's current stream wait on that event and
  `record_stream`s the device buffer onto it, so the caching allocator
  cannot hand the buffer out again while the consumer still reads it. A
  ring slot is written again only after its last copy has finished. On the
  CPU the staging is a plain copy. `stage_to_device` is the one-call form,
  and `to_device` the accounted `torch.as_tensor` of a one-off upload.
  Every staging is accounted (`h2d.count`, `h2d.bytes`), admitted against
  `config.hbm_budget_bytes` before it allocates, and, given a `category`,
  ledgered (obs/memledger.py: `model` for constants, `serving` for served
  batches); the card's out-of-memory error comes back as
  `memledger.HbmExhausted` with the ledger's snapshot.
- `next_bucket`, `pad_rows` and `slice_rows`: the serving batch-shape
  schedule (powers of two from 8, or an explicit bucket list) and its pad,
  which repeats the last real row, so a pad row can fire no guard the real
  rows would not.
- `Prefetcher` runs `stage(item)` on one worker thread (`flow.pump`), up to
  `depth` items ahead of the consumer, through a `flow.BoundedChannel`
  under an overload policy ("block": every item in order; "shed_oldest"
  and "sample": bounded memory, items dropped and counted in `flow.shed`),
  every stage timed by a `flow.StragglerWatchdog`. It yields the results
  in input order, waited for. An exception in `stage` or in the source
  re-raises at the consumer's next `__next__`, after the items staged
  before it; closing the generator early cancels the channel and joins the
  worker.

A leaf of a staged tree is an array, a tensor, or a list of arrays that
are the row pieces of one array: the pieces are copied one after another
into the staging buffer, so a batch cut from several host chunks is never
concatenated on the host first.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import config, flow
from ..obs import memledger, timeline
from ..utils import metrics

__all__ = ["DeviceStager", "Prefetcher", "Staged", "stage_to_device", "to_device", "account_h2d",
           "next_bucket", "pad_rows", "slice_rows"]

#: bytes each leaf's region of a staging buffer is aligned to
_ALIGN = 256


class Staged:
    """A staged tree of tensors (views of `buffer`, the staged bytes), and
    the event its copy recorded (None when nothing is in flight)."""

    __slots__ = ("value", "event", "buffer")

    def __init__(self, value, event, buffer: torch.Tensor):
        self.value, self.event, self.buffer = value, event, buffer

    def wait(self):
        """The tree, safe to read on the calling thread's current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.buffer.device)
            stream.wait_event(self.event)
            self.buffer.record_stream(stream)
        return self.value

    @property
    def nbytes(self) -> int:
        return self.buffer.numel() * self.buffer.element_size()


def _leaves(tree) -> List:
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _rebuild(tree, leaves: Iterator):
    if isinstance(tree, tuple):
        return tuple(_rebuild(part, leaves) for part in tree)
    return next(leaves)


def _host_leaf(leaf):
    """(shape, dtype, pieces) of a leaf to stage: its row pieces as
    tensors that share the host arrays' memory."""
    pieces = leaf if isinstance(leaf, list) else [leaf]
    pieces = [p if isinstance(p, torch.Tensor) else torch.from_numpy(np.asarray(p)) for p in pieces]
    rows = sum(int(p.shape[0]) for p in pieces)
    return (rows, *pieces[0].shape[1:]), pieces[0].dtype, pieces


class DeviceStager:
    """Stage host trees to `device` (default `config.device()`), casting
    floating leaves to `dtype` when one is given."""

    def __init__(self, device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None,
                 slots: Optional[int] = None, side_stream: bool = True):
        self.device = torch.device(device) if device is not None else config.device()
        self.dtype = dtype
        self.cuda = self.device.type == "cuda"
        # the prefetch window, the item being staged and the one in use
        num_slots = slots if slots is not None else config.input_prefetch_depth + 2
        self._ring: List[Optional[torch.Tensor]] = [None] * max(1, num_slots)
        self._done: List[Optional[torch.cuda.Event]] = [None] * len(self._ring)
        self._next = 0
        # without a side stream the copy goes on the caller's current
        # stream, ahead of the work that reads it (a caller that stages and
        # computes on one thread, as a server does); nothing to wait for
        self._stream = torch.cuda.Stream(self.device) if self.cuda and side_stream else None

    def stage(self, nbytes: int, fill: Callable[[torch.Tensor], None]) -> Staged:
        """A device buffer of `nbytes` that `fill(host_uint8_buffer)`
        writes; the fill runs on the calling thread."""
        if not self.cuda:
            host = torch.empty(nbytes, dtype=torch.uint8)
            fill(host)
            return Staged(host, None, host)
        slot = self._next
        self._next = (slot + 1) % len(self._ring)
        if self._done[slot] is not None:
            # tpulint: disable=host-sync-leak -- a ring slot's refill waits for its copy
            self._done[slot].synchronize()  # the slot's last copy has landed
        pinned = self._ring[slot]
        if pinned is None or pinned.numel() < nbytes:
            pinned = self._ring[slot] = torch.empty(
                max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        fill(pinned[:nbytes])
        if self._stream is None:
            out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            out.copy_(pinned[:nbytes], non_blocking=True)
            self._done[slot] = torch.cuda.Event()
            self._done[slot].record()
            return Staged(out, None, out)
        with torch.cuda.stream(self._stream):
            out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            out.copy_(pinned[:nbytes], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._done[slot] = event
        return Staged(out, event, out)

    def __call__(self, tree, category: Optional[str] = None) -> Staged:
        """Stage a tree (nested tuples) of arrays, tensors or row-piece
        lists in one accounted copy; returns a `Staged` tree of device
        tensors, ledgered under `category` when one is given."""
        specs, total = [], 0  # per leaf: (shape, dtype, pieces, offset, nbytes)
        leaves = _leaves(tree)
        for leaf in leaves:
            shape, dtype, pieces = _host_leaf(leaf)
            if self.dtype is not None and dtype.is_floating_point:
                dtype = self.dtype
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            specs.append((shape, dtype, pieces, total, nbytes))
            total += -(-nbytes // _ALIGN) * _ALIGN

        def views(buf: torch.Tensor):
            for shape, dtype, _, off, nbytes in specs:
                yield buf[off:off + nbytes].view(dtype).view(shape)

        def fill(host: torch.Tensor) -> None:
            for (_, _, pieces, _, _), view in zip(specs, views(host)):
                row = 0
                for piece in pieces:
                    view[row:row + piece.shape[0]].copy_(piece)
                    row += piece.shape[0]

        memledger.admit(total, category)
        t0 = time.perf_counter()
        try:
            staged = self.stage(total, fill)
        except torch.cuda.OutOfMemoryError as e:
            raise memledger.wrap_oom(e) from e
        account_h2d(sum(spec[4] for spec in specs), arrays=len(leaves),
                    seconds=time.perf_counter() - t0)
        buf = staged.value
        staged.value = _rebuild(tree, views(buf))
        if category is not None:
            memledger.track(staged.value, category, site=f"staging:{category}")
        return staged


def stage_to_device(tree, device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None, category: Optional[str] = None) -> Staged:
    """Stage one tree through a one-slot `DeviceStager`. A loop that stages
    many batches keeps one stager, so its pinned buffers are reused."""
    return DeviceStager(device, dtype, slots=1)(tree, category)


def to_device(data, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`data` (host values, a host tensor or a tensor anywhere) as a tensor
    on `device`, as `torch.as_tensor(data, dtype=dtype, device=device)`
    gives it, with a copy from the host to the card accounted (`h2d.*`).
    The one-off uploads of a stage (indices, a model's constants, a host
    column) take this; the bulk paths stage through `DeviceStager`."""
    out = torch.as_tensor(data, dtype=dtype, device=device)
    if out.is_cuda and not (isinstance(data, torch.Tensor) and data.is_cuda):
        account_h2d(out.numel() * out.element_size())
    return out


def account_h2d(nbytes: int, arrays: int = 1, seconds: Optional[float] = None) -> None:
    """Fold one host-to-device transfer into the registry (`h2d.count`,
    `h2d.bytes`), and onto the timeline's `h2d` lane when it records."""
    metrics.inc_counter("h2d.count", arrays)
    metrics.inc_counter("h2d.bytes", int(nbytes))
    if timeline.enabled():
        dur_ns = int((seconds or 0.0) * 1e9)
        timeline.record_complete(timeline.LANE_H2D, "h2d", time.perf_counter_ns() - dur_ns,
                                 dur_ns, bytes=int(nbytes), arrays=arrays)


# ---------------------------------------------------------------------------
# batch-shape buckets (serving)
# ---------------------------------------------------------------------------

def next_bucket(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """The smallest bucket >= n: of `buckets` (sorted) when given, n itself
    beyond the largest; else a power of two >= 8. 0 stays 0."""
    if n <= 0:
        return n
    if buckets:
        for b in buckets:
            if b >= n:
                return int(b)
        return int(n)
    b = 8
    while b < n:
        b <<= 1
    return b


def pad_rows(col, n: int, bucket: int):
    """A column padded from n to `bucket` rows by repeating its last row:
    host numpy, a tensor (on its device) or a SparseBatch of either."""
    if bucket == n:
        return col
    from ..table import SparseBatch

    if isinstance(col, SparseBatch):
        return SparseBatch(col.size, pad_rows(col.indices, n, bucket),
                           pad_rows(col.values, n, bucket))
    if isinstance(col, torch.Tensor):
        return torch.cat([col, col[n - 1:].expand((bucket - n,) + tuple(col.shape[1:]))])
    col = np.asarray(col)
    return np.concatenate([col, np.broadcast_to(col[n - 1:], (bucket - n,) + col.shape[1:])])


def slice_rows(col, n: int):
    """The first n rows of a column (undoes `pad_rows`; a view)."""
    from ..table import SparseBatch

    if isinstance(col, SparseBatch):
        return SparseBatch(col.size, col.indices[:n], col.values[:n])
    return col[:n]


# ---------------------------------------------------------------------------
# bounded-depth single-worker prefetch
# ---------------------------------------------------------------------------

class Prefetcher:
    """Run `stage(item)` on one worker thread up to `depth` items ahead of
    the consumer (default `config.input_prefetch_depth`), through a
    `flow.BoundedChannel` under `policy` (default "block")."""

    def __init__(self, stage: Callable[[Any], Any], depth: Optional[int] = None,
                 policy: str = flow.BLOCK, name: str = "prefetch"):
        if policy not in flow.POLICIES:
            raise ValueError(f"unknown overload policy {policy!r} (one of {flow.POLICIES})")
        self.stage = stage
        self.depth = max(1, int(depth if depth is not None else config.input_prefetch_depth))
        self.policy = policy
        self.name = name
        self.watchdog = flow.StragglerWatchdog(name)
        self.channel: Optional[flow.BoundedChannel] = None  # the latest iterate()'s window

    def iterate(self, items: Iterable) -> Iterator:
        """The staged items in input order (those the policy kept); a
        `Staged` result is waited for on the consumer's stream before it
        is yielded."""
        metrics.set_gauge("prefetch.depth", self.depth)
        channel = flow.BoundedChannel(self.depth, policy=self.policy, name=self.name)
        self.channel = channel
        worker = flow.pump(items, channel, transform=self.stage, watchdog=self.watchdog)
        try:
            for entry in channel:
                yield entry.wait() if isinstance(entry, Staged) else entry
        finally:
            channel.cancel()  # early exit: stop the speculative staging
            worker.join()
