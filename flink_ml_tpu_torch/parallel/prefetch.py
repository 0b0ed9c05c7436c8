"""Input staging: host-to-device copies and a one-worker prefetcher.

Port of the staging half of flink_ml_tpu/parallel/prefetch.py (`:136`,
`:275-319`):

- `DeviceStager` stages host arrays to one device. On a CUDA device it
  copies each batch into one of a small ring of pinned host buffers, then
  to the device with one `non_blocking` copy on a side stream, and records
  an event there. The caller gets a `Staged` handle, whose `wait()` makes
  the consuming thread's current stream wait on that event and
  `record_stream`s the device buffer onto it, so the caching allocator
  cannot hand the buffer out again while the consumer still reads it. A
  ring slot is written again only after its last copy has finished. On the
  CPU the staging is a plain copy. `stage_to_device` is the one-call form.
- `Prefetcher` runs `stage(item)` on one worker thread, up to `depth`
  items ahead of the consumer, and yields the results in input order,
  waited for. An exception in `stage` or in the source re-raises at the
  consumer's next `__next__`, after the items staged before it; closing
  the generator early stops and joins the worker.

A leaf of a staged tree is an array, a tensor, or a list of arrays that
are the row pieces of one array: the pieces are copied one after another
into the staging buffer, so a batch cut from several host chunks is never
concatenated on the host first. The JAX package's upload accounting, HBM
ledger, shape bucketing and flow-control policies are not ported (ROADMAP
A.12, A.14); only the "block" policy exists.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import config

__all__ = ["DeviceStager", "Prefetcher", "Staged", "stage_to_device"]

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
                 slots: Optional[int] = None):
        self.device = torch.device(device) if device is not None else config.device()
        self.dtype = dtype
        self.cuda = self.device.type == "cuda"
        # the prefetch window, the item being staged and the one in use
        num_slots = slots if slots is not None else config.input_prefetch_depth + 2
        self._ring: List[Optional[torch.Tensor]] = [None] * max(1, num_slots)
        self._done: List[Optional[torch.cuda.Event]] = [None] * len(self._ring)
        self._next = 0
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None

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
            self._done[slot].synchronize()  # the slot's last copy has landed
        pinned = self._ring[slot]
        if pinned is None or pinned.numel() < nbytes:
            pinned = self._ring[slot] = torch.empty(
                max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        fill(pinned[:nbytes])
        with torch.cuda.stream(self._stream):
            out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            out.copy_(pinned[:nbytes], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._done[slot] = event
        return Staged(out, event, out)

    def __call__(self, tree) -> Staged:
        """Stage a tree (nested tuples) of arrays, tensors or row-piece
        lists in one copy; returns a `Staged` tree of device tensors."""
        specs, total = [], 0  # per leaf: (shape, dtype, pieces, offset, nbytes)
        for leaf in _leaves(tree):
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

        staged = self.stage(total, fill)
        buf = staged.value
        staged.value = _rebuild(tree, views(buf))
        return staged


def stage_to_device(tree, device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None) -> Staged:
    """Stage one tree through a one-slot `DeviceStager`. A loop that stages
    many batches keeps one stager, so its pinned buffers are reused."""
    return DeviceStager(device, dtype, slots=1)(tree)


_END = object()


class _Failure:
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Run `stage(item)` on one worker thread up to `depth` items ahead of
    the consumer (default `config.input_prefetch_depth`)."""

    def __init__(self, stage: Callable[[Any], Any], depth: Optional[int] = None,
                 policy: Optional[str] = None):
        config.check_overload_policy(policy if policy is not None else config.online_overload_policy)
        self.stage = stage
        self.depth = max(1, int(depth if depth is not None else config.input_prefetch_depth))

    def iterate(self, items: Iterable) -> Iterator:
        """The staged items in input order; a `Staged` result is waited for
        on the consumer's stream before it is yielded."""
        window: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(entry) -> bool:
            while not stop.is_set():
                try:
                    window.put(entry, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def work() -> None:
            try:
                for item in items:
                    if stop.is_set() or not put(self.stage(item)):
                        return
            except BaseException as e:  # handed to the consumer, who re-raises it
                put(_Failure(e))
                return
            put(_END)

        worker = threading.Thread(target=work, name="prefetch", daemon=True)
        worker.start()
        try:
            while True:
                entry = window.get()
                if entry is _END:
                    return
                if isinstance(entry, _Failure):
                    raise entry.error
                yield entry.wait() if isinstance(entry, Staged) else entry
        finally:
            stop.set()
            worker.join()
