"""The program funnel: functions run as captured CUDA-graph programs.

Port of flink_ml_tpu/utils/lazyjit.py (`lazy_jit` `:88`, `keyed_jit`
`:111`). The JAX package jits a kernel once and reuses the compiled
program for every call of the same abstract signature; here a wrapped
function becomes one captured CUDA graph per input signature:

- the **signature** is the call's tree of arguments: each tensor's shape,
  dtype, strides and device, and a token for every other value (the
  static arguments named in `static_argnames`, Python numbers and named
  singletons such as a `LossFunc`);
- **on the card**, the first call of a signature copies its tensor
  operands into static buffers, runs the function eagerly on them (its
  answer, with real, counted kernel launches, built outside any capture:
  the warm-up `torch.cuda.graph` asks for) and then captures the same
  function on the same buffers. Every later call copies its operands into
  the buffers, replays, and clones the outputs out of the graph's pool;
- **on the CPU** the function runs eagerly on every call, and a new
  signature is counted as the card counts a capture.

A `Feed` operand is written straight into its static buffer (a staged
fit input that needs padding or a cast is copied once, not once to
stage and once more into the graph). A tensor on the card passed for an
argument named in `borrow` (a fit's training data) gets no static
buffer: the graph reads the caller's tensor in place, so the data is
never copied and the cache keeps no copy of it after the call. Such a
graph has a home, the borrowed tensors' addresses: it serves later
calls whose data lies there (the same tensors, or tensors of the
signature the allocator put there). A call of the signature with its
data elsewhere (a pipeline stage's fresh output, another table) runs
eagerly, as `whole_fit = "off"` does: it neither captures nor copies,
so it costs no more than the op-by-op fit; once the home graph is
evicted, the next call captures a new home. A graph with buffers for
every operand (a banked one, or one captured for host data) serves a
call at any address.

Counters, with the JAX package's names: `jit.kernels` once per wrapper;
`jit.traces` once per capture (a call that had to wait for one);
`jit.compiles` and the `jit.compile` timer, a capture's host time, with
a `compile`-category span when tracing is on (`tracing.account_compile`,
which stands in for the JAX package's compile-event hook);
`jit.kernelCacheEvict` and `jit.kernelCacheSize` for the LRU bounds at
`config.kernel_cache_size` (keyed_jit's wrappers, and each wrapper's
graphs).

One capture mechanism serves the fused transform segments
(pipeline.FusedSegment) and the whole fits: `GraphCache` (one memory pool
shared by a cache's graphs, whose replays run one at a time and clone
their outputs out at once), `make_room` (eviction by count, and by the
bytes the graphs keep against what the card has free, over every cache),
`capture_lock` (held by every capture, which runs in
`capture_error_mode="thread_local"`), and `capture` (which moves the
sparse kernels' counted launches from the capture to each replay).

What a graph keeps (`kept_bytes`, which `make_room` evicts by) is
measured on the card, from the allocator's own blocks: the blocks the
capture left allocated in the pool and the blocks of the graph's static
buffers, rounding and unsplit segment tails included. A capture runs on
a stream of its thread's own whose library state (cuBLAS's workspace
for the stream) was made before, outside the pool, so that state, which
outlives every graph, is not counted as any graph's. `make_room` adds
each live pool's reserved but unallocated bytes, its graphs' scratch
(`pool_reserve`), and counts as free only the default pool's unused
blocks. On the CPU no graph exists and a graph's figure is what its
static inputs and outputs hold by their sizes.

The program bank (compilebank.py): with `config.program_bank_dir` set, a
wrapper's signatures are recorded in the bank, and a fresh process
captures every banked signature ahead of its first call (`warm_load`).
`config.whole_fit = "off"` makes every wrapper a plain eager call.
"""

from __future__ import annotations

import inspect
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

#: held by every capture, and by CUDA work on other threads that must not
#: run inside one (a lifecycle's canary and publication)
capture_lock = threading.RLock()

_stamps = itertools.count(1)
_caches: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()
#: (thread, device index) -> the stream that thread's captures run on
_capture_streams: Dict[Tuple[int, int], Any] = {}
#: kernel id -> the wrapper's kernel, for the bank's warm loads
_registry: Dict[str, "_Kernel"] = {}


# ---------------------------------------------------------------------------
# trees of operands
# ---------------------------------------------------------------------------

class Feed:
    """A tensor operand not made yet: `rows` rows of `source` (a tensor on
    any device, or a numpy array) cast to `dtype` on `device`, padded to
    `shape[0]` rows with `fill`. The funnel writes it straight into a
    static buffer (`write_to`); an eager call makes it (`materialize`)."""

    __slots__ = ("source", "shape", "dtype", "device", "fill")

    def __init__(self, source, shape, dtype: torch.dtype, device: torch.device, fill=0):
        self.source = source
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.fill = fill

    def stride(self) -> Tuple[int, ...]:
        return torch.empty(self.shape, device="meta").stride()

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * torch.empty((), dtype=self.dtype).element_size()

    def _source_tensor(self) -> torch.Tensor:
        src = self.source
        return src if isinstance(src, torch.Tensor) else torch.as_tensor(src)

    def write_to(self, out: torch.Tensor) -> None:
        src = self._source_tensor()
        rows = src.shape[0]
        out[:rows].copy_(src)
        if rows < out.shape[0]:
            out[rows:].fill_(self.fill)

    def materialize(self) -> torch.Tensor:
        """The operand as a contiguous tensor (the source itself where it
        already is one)."""
        src = self._source_tensor()
        if src.shape[0] == self.shape[0]:
            return src.to(device=self.device, dtype=self.dtype).contiguous()
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        self.write_to(out)
        return out


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, Feed))


def flatten(node) -> Tuple[List[Any], Any]:
    """(tensor and Feed leaves, structure) of a tree of tuples (named ones
    too), lists and dicts. Other values stay in the structure."""
    leaves: List[Any] = []

    def walk(n):
        if _is_leaf(n):
            leaves.append(n)
            return ("*",)
        if isinstance(n, tuple) and hasattr(n, "_fields"):
            return ("N", type(n), tuple(walk(v) for v in n))
        if isinstance(n, (tuple, list)):
            return ("T" if isinstance(n, tuple) else "L", tuple(walk(v) for v in n))
        if isinstance(n, dict):
            return ("D", tuple((k, walk(n[k])) for k in sorted(n, key=repr)))
        return ("V", n)

    return leaves, walk(node)


def unflatten(structure, leaves) -> Any:
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "*":
            return next(it)
        if kind == "N":
            return s[1](*(build(c) for c in s[2]))
        if kind in ("T", "L"):
            items = [build(c) for c in s[1]]
            return tuple(items) if kind == "T" else items
        if kind == "D":
            return {k: build(c) for k, c in s[1]}
        return s[1]

    return build(structure)


def _structure_token(s) -> str:
    """A stable text form of a tree structure: its kinds, and a token for
    each value it holds (compilebank.static_token, else the value's repr)."""
    from .. import compilebank

    kind = s[0]
    if kind == "*":
        return "*"
    if kind == "N":
        return f"{s[1].__name__}(" + ",".join(_structure_token(c) for c in s[2]) + ")"
    if kind in ("T", "L"):
        inner = ",".join(_structure_token(c) for c in s[1])
        if kind == "L":
            return "[" + inner + "]"
        return "(" + inner + ("," if len(s[1]) == 1 else "") + ")"
    if kind == "D":
        return "{" + ",".join(f"{k!r}:{_structure_token(c)}" for k, c in s[1]) + "}"
    token = compilebank.static_token(s[1])
    return token if token is not None else f"<{type(s[1]).__name__}@{id(s[1])}>"


def leaf_descriptor(leaf) -> Tuple:
    """(shape, dtype name, strides, device type) of a tensor or Feed."""
    dtype = str(leaf.dtype).replace("torch.", "")
    return (tuple(leaf.shape), dtype, tuple(leaf.stride()), leaf.device.type)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def materialize(node):
    """The tree with every Feed made into its tensor."""
    leaves, structure = flatten(node)
    return unflatten(structure, [x.materialize() if isinstance(x, Feed) else x for x in leaves])


def static_buffers(leaves) -> List[torch.Tensor]:
    """A static buffer for each leaf (its shape, dtype and strides), filled
    from it."""
    out = []
    for leaf in leaves:
        buf = torch.empty_strided(tuple(leaf.shape), tuple(leaf.stride()), dtype=leaf.dtype,
                                  device=leaf.device)
        write_leaf(buf, leaf)
        out.append(buf)
    return out


def write_leaf(buf: torch.Tensor, leaf) -> None:
    if isinstance(leaf, Feed):
        leaf.write_to(buf)
    else:
        buf.copy_(leaf)


# ---------------------------------------------------------------------------
# the capture mechanism, shared by fused segments and whole fits
# ---------------------------------------------------------------------------

def free_bytes(device: torch.device) -> int:
    """What the card can still give: its free memory and the unused blocks
    of the allocator's default pool (a graph pool's unused blocks serve
    only the captures into it)."""
    free, _ = torch.cuda.mem_get_info(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return free + sum(seg["total_size"] - seg["allocated_size"]
                      for seg in torch.cuda.memory._snapshot()["segments"]
                      if seg["device"] == index and tuple(seg["segment_pool_id"]) == (0, 0))


def pool_reserve(pools) -> Dict[Any, int]:
    """The bytes each graph pool of `pools` holds reserved but unallocated:
    its graphs' scratch space, which nothing outside the pool can use while
    one of them lives."""
    out = {tuple(p): 0 for p in pools if p is not None}
    if not out or not torch.cuda.is_available():
        return out
    for seg in torch.cuda.memory._snapshot()["segments"]:
        pool = tuple(seg["segment_pool_id"])
        if pool in out:
            out[pool] += seg["total_size"] - seg["allocated_size"]
    return out


def allocated_blocks(pool=None, ptrs=()) -> Tuple[int, int]:
    """From the allocator's snapshot: the bytes of the blocks allocated in
    the graph pool `pool`, and of the allocated blocks that start at the
    addresses `ptrs`."""
    want = set(ptrs)
    in_pool = at_ptrs = 0
    for seg in torch.cuda.memory._snapshot()["segments"]:
        ours = pool is not None and tuple(seg["segment_pool_id"]) == tuple(pool)
        for block in seg["blocks"]:
            if block["state"] != "active_allocated":
                continue
            in_pool += block["size"] if ours else 0
            at_ptrs += block["size"] if block["address"] in want else 0
    return in_pool, at_ptrs


def capture_stream():
    """The calling thread's capture stream on the current card, made on
    first use together with the library state a capture on it needs (a
    matmul makes cuBLAS's workspace for the stream), outside every graph's
    pool."""
    index = torch.cuda.current_device()
    key = (threading.get_ident(), index)
    stream = _capture_streams.get(key)
    if stream is None:
        stream = torch.cuda.Stream(index)
        stream.wait_stream(torch.cuda.current_stream(index))
        with torch.cuda.stream(stream):
            a = torch.ones((8, 8), device=torch.device("cuda", index))
            torch.addmm(a[0], a, torch.mm(a, a))
        torch.cuda.current_stream(index).wait_stream(stream)
        _capture_streams[key] = stream
    return stream


class Captured:
    """One captured graph: the graph, the launches each replay adds to the
    sparse kernels' counts, the bytes the capture left allocated in its
    pool (`pool_bytes`, measured) and the bytes it keeps between replays
    (set by its owner). `stamp` orders the graphs of every cache by last
    use."""

    def __init__(self, graph, launches: Dict[Any, int], pool_bytes: int = 0):
        self.graph = graph
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.kept_bytes = 0
        self.stamp = next(_stamps)
        self.banked = False

    def replay(self) -> None:
        self.stamp = next(_stamps)
        if self.graph is not None:
            self.graph.replay()
            for kernel, n in self.launches.items():
                kernel.launches += n


def capture(pool, body: Callable[[], Any]) -> Tuple[Captured, Any]:
    """Capture `body()` into a new graph in `pool`, under `capture_lock`,
    in thread-local error mode and on the thread's `capture_stream`. The
    wrappers count launches on the host, so the capture's counted launches
    move from the count to each replay. Returns (Captured with the bytes
    the capture left allocated in the pool, body's outputs in the pool)."""
    from ..ops import sparsekernels

    graph = torch.cuda.CUDAGraph()
    before = sparsekernels.launch_counts()
    stream = capture_stream()
    with capture_lock:
        pool_before, _ = allocated_blocks(pool)
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = body()
        pool_bytes = allocated_blocks(pool)[0] - pool_before
    after = sparsekernels.launch_counts()
    launches = {k: after[k.__name__] - before[k.__name__] for k in sparsekernels.KERNELS}
    for kernel, n in launches.items():
        kernel.launches -= n
    return Captured(graph, launches, pool_bytes), out


class GraphCache:
    """Captured graphs by signature, least recently used first, and the
    memory pool they share. A cache's replays run one at a time on one
    stream and clone their outputs out at once, so a graph's temporaries
    may lie where another graph's were. `lock` makes each call (operands
    copied in, replay, outputs cloned out) one unit on the host, so two
    threads cannot interleave their copies into shared buffers."""

    def __init__(self):
        self.entries: "OrderedDict[Any, Captured]" = OrderedDict()
        self.pool = None
        self.lock = threading.RLock()
        #: a fused segment's constant buffers by constants signature
        self.operands: Dict[Any, Any] = {}
        _caches.add(self)

    def get(self, sig) -> Optional[Captured]:
        entry = self.entries.get(sig)
        if entry is not None:
            self.entries.move_to_end(sig)
        return entry

    def put(self, sig, entry: Captured) -> None:
        self.entries[sig] = entry
        self.entries.move_to_end(sig)

    def clear(self) -> None:
        """Drop every graph (their static buffers and pool blocks go)."""
        self.entries.clear()
        self.operands.clear()
        self.pool = None

    def ensure_pool(self):
        """The pool for the next capture: a new one while the cache holds
        no graph (a pool whose graphs all died is released by the
        allocator, and a capture into its handle fails)."""
        if self.pool is None or not self.entries:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def make_room(self, free_bytes: Optional[int], incoming: int = 0) -> None:
        """Before a capture: drop this cache's least recently used graphs
        while it holds `config.kernel_cache_size` or more, and then the
        least recently used graphs of every cache while all of them keep
        more bytes (their own and their pools' scratch, with the `incoming`
        capture's) than the card has free (`free_bytes`; None on the CPU).
        A dropped graph's blocks go back to its pool, and its static
        buffers are freed; a pool's reserve goes with its last graph."""
        from .. import config
        from . import metrics

        while self.entries and len(self.entries) >= config.kernel_cache_size:
            self.entries.popitem(last=False)
            metrics.inc_counter("jit.kernelCacheEvict")
        if free_bytes is None:
            return
        while True:
            live = [c for c in list(_caches) if c.entries]
            kept = [(getattr(e, "stamp", 0), c, s, e.kept_bytes) for c in live
                    for s, e in list(c.entries.items()) if e.kept_bytes > 0]
            scratch = sum(pool_reserve([c.pool for c in live]).values())
            if not kept or sum(k[3] for k in kept) + scratch + incoming <= free_bytes:
                return
            _, cache, sig, _ = min(kept, key=lambda k: k[0])
            cache.entries.pop(sig, None)
            metrics.inc_counter("jit.kernelCacheEvict")


def forget_graphs() -> None:
    """Drop the graphs of every cache: the state of a fresh process (the
    next call of each signature captures again)."""
    for cache in list(_caches):
        with cache.lock:
            cache.clear()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _account_new_kernel() -> None:
    from . import metrics

    metrics.inc_counter("jit.kernels")


def account_capture(seconds: float, kernel_id: str) -> None:
    """One capture a call waited for: `jit.traces` and the compile accounting."""
    from ..obs import tracing
    from . import metrics

    metrics.inc_counter("jit.traces")
    tracing.account_compile(seconds, kernel=kernel_id)


def kernel_id_of(fn: Callable, key: Tuple = ()) -> Optional[str]:
    """A process-restart-stable identity for a kernel, or None when a
    factory key has no stable token (that family skips the bank)."""
    base = f"{getattr(fn, '__module__', '?')}." \
           f"{getattr(fn, '__qualname__', getattr(fn, '__name__', '?'))}"
    if not key:
        return base
    from .. import compilebank

    tokens = [compilebank.static_token(k) for k in key]
    if any(t is None for t in tokens):
        return None
    return base + "[" + ",".join(tokens) + "]"


class _Program(Captured):
    """A wrapper's graph for one signature: its static input buffers (None
    where the graph reads a borrowed operand in place) and its outputs in
    the pool. `kept_bytes` is what the allocator holds for the graph
    (`static_blocks`, the static buffers' blocks, and the capture's
    `pool_bytes`), or on the CPU what those tensors hold by their sizes."""

    def __init__(self, captured: Captured, static_in: List[Optional[torch.Tensor]], outputs,
                 static_blocks: Optional[int] = None):
        super().__init__(captured.graph, captured.launches, captured.pool_bytes)
        self.static_in = static_in
        self.outputs = outputs
        if static_blocks is None:
            self.kept_bytes = (_nbytes(b for b in static_in if b is not None)
                               + _nbytes(flatten(outputs)[0]))
        else:
            self.kept_bytes = static_blocks + self.pool_bytes

    def run(self, leaves) -> Any:
        for buf, leaf in zip(self.static_in, leaves):
            if buf is not None:
                write_leaf(buf, leaf)
        self.replay()
        out_leaves, structure = flatten(self.outputs)
        return unflatten(structure, [t.clone() for t in out_leaves])


class _Kernel:
    """One wrapped function: its graphs by signature and its accounting."""

    def __init__(self, fn: Callable, kernel_id: Optional[str], static_argnames: Tuple[str, ...],
                 ledger: Optional[str], borrow: Tuple[str, ...] = ()):
        self.fn = fn
        self.kernel_id = kernel_id
        self.static_argnames = tuple(static_argnames)
        self.borrow = tuple(borrow)
        self.ledger = ledger
        self.params = inspect.signature(fn)
        self.cache = GraphCache()
        #: signature -> the addresses its borrowing graph reads (its home)
        self.homes: Dict[Any, Tuple[int, ...]] = {}
        self.counted = False
        self.warmed_bank = None
        if kernel_id is not None:
            _registry[kernel_id] = self

    # -- signatures ----------------------------------------------------------
    def split(self, args, kwargs):
        """(leaves, structure, statics, lendable) of a call: `lendable[i]`
        says whether leaf i belongs to an argument named in `borrow`."""
        bound = self.params.bind(*args, **kwargs)
        bound.apply_defaults()
        statics = {k: bound.arguments[k] for k in self.static_argnames if k in bound.arguments}
        dynamic = {k: v for k, v in bound.arguments.items() if k not in statics}
        leaves, structure = flatten(dynamic)
        lendable = []
        for name in sorted(dynamic, key=repr):  # flatten's order of a dict's leaves
            lendable += [name in self.borrow] * len(flatten(dynamic[name])[0])
        return leaves, structure, statics, lendable

    def signature(self, leaves, structure, statics) -> Tuple:
        from .. import compilebank

        tokens = {}
        for name, value in sorted(statics.items()):
            token = compilebank.static_token(value)
            tokens[name] = token if token is not None else value
        return (tuple(leaf_descriptor(x) for x in leaves), _structure_token(structure),
                tuple(sorted(tokens.items(), key=lambda kv: kv[0])))

    def call_with(self, structure, leaves, statics):
        dynamic = unflatten(structure, leaves)
        return self.fn(**dynamic, **statics)

    # -- calls ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        from .. import compilebank, config

        if config.whole_fit == "off":
            return self.fn(*(materialize(a) for a in args),
                           **{k: materialize(v) for k, v in kwargs.items()})
        if not self.counted:
            self.counted = True
            _account_new_kernel()
        leaves, structure, statics, lendable = self.split(args, kwargs)
        sig = self.signature(leaves, structure, statics)
        lent = [b and isinstance(x, torch.Tensor) and x.is_cuda for b, x in zip(lendable, leaves)]
        key = (sig, tuple(x.data_ptr() for x, o in zip(leaves, lent) if o))
        bank = compilebank.active_bank()
        if bank is not None and self.kernel_id is not None and self.warmed_bank is not bank:
            self.warmed_bank = bank
            bank.warm_load_kernel(self)
        device = leaves[0].device if leaves else torch.device("cpu")
        start_ns = time.perf_counter_ns()
        with self.cache.lock:
            entry = self.cache.get(key)
            if entry is None and key[1]:
                entry = self.cache.get((sig, ()))  # buffers for every operand
            away = entry is None and key[1] and (sig, self.homes.get(sig)) in self.cache.entries
            if away:  # the signature's graph reads its data elsewhere
                result = self.call_with(structure, [materialize(x) for x in leaves], statics)
            elif entry is not None:
                if bank is not None and entry.banked:
                    bank.count_hit()
                if device.type != "cuda":
                    entry.replay()
                    result = self.call_with(structure, self.eager_leaves(leaves), statics)
                else:
                    result = entry.run(leaves)
            else:
                if bank is not None:
                    bank.count_miss()
                result, entry = self.first_call(device, leaves, structure, statics, lent)
                self.cache.put(key, entry)
                if key[1]:
                    self.homes[sig] = key[1]
        from ..obs import timeline

        if timeline.enabled():  # the host's part of the call: copies in, launch or capture
            timeline.record_complete(timeline.LANE_DISPATCH, "dispatch.chunk", start_ns,
                                     time.perf_counter_ns() - start_ns,
                                     kernel=self.kernel_id or self.fn.__name__)
        if bank is not None and self.kernel_id is not None:
            bank.offer_signature(self.kernel_id, sig, leaves, statics)
        return result

    def eager_leaves(self, leaves) -> List[torch.Tensor]:
        """The leaves made, for an eager call on the CPU (ledgered under
        the wrapper's category, as the card's static buffers are)."""
        made = [materialize(x) for x in leaves]
        if self.ledger is not None:
            from ..obs import memledger

            memledger.track(made, self.ledger)
        return made

    def first_call(self, device, leaves, structure, statics, lent=None, count: bool = True):
        """The eager run of a new signature (its answer) and the capture
        of it. `lent[i]` marks a leaf the graph reads in place (no static
        buffer). On the CPU there is nothing to capture."""
        start = time.perf_counter()
        if device.type != "cuda":
            self.cache.make_room(None)
            result = self.call_with(structure, self.eager_leaves(leaves), statics)
            entry = Captured(None, {})
        else:
            lent = lent or [False] * len(leaves)
            owned = static_buffers([x for x, o in zip(leaves, lent) if not o])
            self.cache.make_room(free_bytes(device), _nbytes(owned))
            bufs = iter(owned)
            operands = [x if o else next(bufs) for x, o in zip(leaves, lent)]
            # the warm-up: real, counted launches on the graph's operands,
            # with the kernels built and the library handles made outside
            # the capture
            result = _unaliased(self.call_with(structure, operands, statics), owned)
            captured, outputs = capture(self.cache.ensure_pool(),
                                        lambda: self.call_with(structure, operands, statics))
            _, static_blocks = allocated_blocks(ptrs=[b.data_ptr() for b in owned])
            entry = _Program(captured, [None if o else b for b, o in zip(operands, lent)],
                             outputs, static_blocks)
            if self.ledger is not None:
                from ..obs import memledger

                memledger.track(owned, self.ledger)
        if count:
            account_capture(time.perf_counter() - start, self.kernel_id or self.fn.__name__)
        return result, entry

    def warm_load(self, device, leaves, structure, statics) -> None:
        """Capture one banked signature ahead of its first call (on the
        CPU: record it), with synthetic operands."""
        key = (self.signature(leaves, structure, statics), ())
        with self.cache.lock:
            if self.cache.get(key) is not None:
                return
            _, entry = self.first_call(device, leaves, structure, statics, count=False)
            entry.banked = True
            self.cache.put(key, entry)


def _unaliased(result, static_in: List[torch.Tensor]):
    """`result` with a copy of every tensor that lies in a static buffer (a
    function may hand an operand back), which the next call overwrites."""
    held = {t.untyped_storage().data_ptr() for t in static_in}
    leaves, structure = flatten(result)
    return unflatten(structure, [t.clone() if isinstance(t, torch.Tensor)
                                 and t.untyped_storage().data_ptr() in held else t
                                 for t in leaves])


def lazy_jit(fn: Callable = None, *, static_argnames: Tuple[str, ...] = (),
             ledger: Optional[str] = None, borrow: Tuple[str, ...] = ()) -> Callable:
    """`fn` as a program funnel: one captured graph per signature on the
    card (see the module docstring). `static_argnames` name the arguments
    that are part of the signature by value; `ledger` a memory-ledger
    category for the static input buffers; `borrow` the arguments whose
    tensors on the card the graph reads in place. Usable as a decorator
    factory (`lazy_jit(static_argnames=...)`)."""
    if fn is None:
        return lambda f: lazy_jit(f, static_argnames=static_argnames, ledger=ledger,
                                  borrow=borrow)
    kernel = _Kernel(fn, kernel_id_of(fn), static_argnames, ledger, borrow)

    def call(*args, **kwargs):
        return kernel(*args, **kwargs)

    call.__name__ = getattr(fn, "__name__", "lazy_jit")
    call.__qualname__ = getattr(fn, "__qualname__", call.__name__)
    call.__doc__ = fn.__doc__
    call.kernel = kernel
    call.__wrapped__ = fn
    return call


def keyed_jit(make_fn: Callable, *, static_argnames: Tuple[str, ...] = ()) -> Callable:
    """A factory cache: `keyed_jit(make)(key)` wraps `make(key)` once per
    distinct key (a kernel whose body depends on a static value), least
    recently used first out at `config.kernel_cache_size`."""
    cache: "OrderedDict[Tuple, Callable]" = OrderedDict()

    def get(*key):
        fn = cache.get(key)
        if fn is not None:
            cache.move_to_end(key)
            return fn
        from .. import config
        from . import metrics

        body = make_fn(*key)
        kernel = _Kernel(body, kernel_id_of(make_fn, key), static_argnames, None)
        _account_new_kernel()
        kernel.counted = True

        def call(*args, **kwargs):
            return kernel(*args, **kwargs)

        call.__name__ = getattr(make_fn, "__name__", "keyed_jit")
        call.kernel = kernel
        cache[key] = call
        limit = max(1, int(config.kernel_cache_size))
        while len(cache) > limit:
            cache.popitem(last=False)
            metrics.inc_counter("jit.kernelCacheEvict")
        metrics.set_gauge("jit.kernelCacheSize", float(len(cache)))
        return call

    return get


def registered(kernel_id: str) -> Optional[_Kernel]:
    """The wrapper registered under `kernel_id` (its module imported on
    demand), or None."""
    kernel = _registry.get(kernel_id)
    if kernel is None:
        import importlib

        module = kernel_id.split("[", 1)[0]
        while "." in module and kernel is None:
            module = module.rsplit(".", 1)[0]
            try:
                importlib.import_module(module)
            except ImportError:
                continue
            kernel = _registry.get(kernel_id)
    return kernel
