"""Collectives over a mesh of ranks, accounted.

Port of flink_ml_tpu/parallel/collectives.py. The JAX wrappers run inside
`shard_map` bodies, one program driving every device; here every rank runs
the body itself (parallel/mesh.py), so a wrapper is a torch.distributed
call over the mesh's process group, on this rank's tensors. The JAX
`shard_map_over` (`:406`) has no counterpart: there is no single program
to map.

- `payload_bytes` (`:73`) and `_account` (`:82-138`): every wrapper feeds
  the per-axis counters (`collective.axis.<axis>.*`), the payload
  histogram, `obs.tracing.account_collective` (`collective.<op>.calls/
  bytes/chunks`, `collective.sparse_ratio`, the timeline's `collective`
  lane) and the sanitizer's collective-sequence ledger
  (`analysis.sanitizer.record_collective`), under the op names of the JAX
  package (psum, pmean, pmax, pmin, all_gather, psum_scatter, ppermute,
  chunked, sparse_allreduce). The JAX `_account` fires once per compiled
  program, at trace time; the port's fires once per call, so a fit of E
  epochs counts E reductions where the JAX package counts one program's
  (ROADMAP C.29).
- `axis_wire_bytes` (`:140`), `axis_size` (`:157`), `axis_index` (`:402`);
  every wrapper takes `axis_name`: on a 2D mesh (mesh.create_mesh_2d) it
  runs over the axis's sub-group (`Mesh.axis_group`: this rank's data row
  for `model`, its model column for `data`), and the counters, the
  `collective.sparse_ratio.<axis>` gauge and the sanitizer's ledger keep
  the axes apart;
- `all_reduce_sum/mean/max/min` (`:168-192`), `all_gather` (`:194`),
  `reduce_scatter` (`:202`), `ppermute_ring` (`:207`);
- the chunked reduce `all_reduce_sum_chunked` (`:274`): leaves grouped by
  dtype, flattened, cut into `chunk_bytes` buckets (`_bucket_sizes`), each
  bucket reduced by reduce-scatter + all-gather (`_reduce_bucket_rs_ag`)
  or, with `ring`, by the ring exchange folded in replica order
  (`_reduce_bucket_ring`). With `async_op` the buckets' first stage is
  issued and a `Pending` returned, whose `result()` finishes them: the
  overlap schedule of parallel/overlap.py;
- the SparCML pair exchange `sparse_all_reduce_sum` (`:338`), with the
  routing rule `sparse_reduce_wins` (`:387`). Each rank's gathered pairs
  scatter into a dense partial (`scatter_pairs`; the JAX package's
  scatter there is `jnp` code, not a Pallas kernel) and the partials are
  folded in replica order, the association of the dense route. The
  scatter is `index_put_(accumulate=True)`, whose order of additions is
  fixed: every rank computes the sum itself, and the `sparse_grad`
  kernel's atomics gave each rank other last bits, so the ranks of a fit
  ended with different models (found on the card; ROADMAP C.30);
- `host_all_reduce_sum` (`:451`): the sum of host partials on this rank's
  device (the JAX package caches a jitted reducer; nothing compiles here).

The reduce order (ROADMAP C.26). The monolithic `all_reduce_sum` is the
backend's own all-reduce, the one NCCL users run. At two ranks every
reduce gives the same bits (a + b = b + a), so the chunked, ring and
sparse reduces and the overlap schedule equal the monolithic reduce bit
for bit. At three ranks or more the backend's ring associates by segment,
and bucketing changes the segments, so they agree within a stated
tolerance, not bit for bit (the JAX package's bit parity,
tests/test_collective_chunks.py, holds for XLA's replica-ordered psum).

Gloo on CUDA tensors (ROADMAP C.27). PyTorch's backend table lists only
all_reduce and broadcast for gloo on CUDA tensors. On the card
(`scripts/probe_distributed_backends.py`, torch 2.11, two gloo ranks on
one H100, one world per operation) gloo ran all_reduce (sum, max, async),
broadcast, all_gather, reduce_scatter and all_gather_object on CUDA
tensors and each held its definition; point-to-point (`batch_isend_irecv`,
which the ring exchange and `ppermute_ring` use) aborted the process
(`gloo::IoException`: writev, Bad address). So `GLOO_CUDA_OPS` holds the
first three, which gloo stages through the host itself, and the gloo
branch stages point-to-point on CUDA tensors through pinned host tensors
explicitly (`_issue`). The NCCL branch never stages, and CPU tensors are
never staged.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import sanitizer as _sanitizer
from ..obs import hist, tracing
from ..utils import metrics
from . import mesh as mesh_lib
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, default_mesh  # noqa: F401  (MODEL_AXIS re-export)

#: the collectives gloo runs on CUDA tensors by itself; the gloo branch stages
#: every other one through pinned host tensors (see the module docstring)
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter"})

# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def _iter_array_leaves(x):
    """Every array-like leaf of a nested tuple/list/dict structure, both
    leaves of a sparse (indices, values) pair included."""
    if isinstance(x, (tuple, list)):
        for item in x:
            yield from _iter_array_leaves(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _iter_array_leaves(item)
    elif hasattr(x, "shape") and hasattr(x, "dtype"):
        yield x


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.dtype(leaf.dtype).name


def payload_bytes(x) -> int:
    """Per-participant payload bytes: the sum over every array leaf."""
    return sum(int(np.prod(leaf.shape)) * _itemsize(leaf) for leaf in _iter_array_leaves(x))


def _account(op: str, x, axis_name: str, chunks: Optional[int] = None,
             dense_equiv_bytes: Optional[int] = None) -> None:
    """Record one collective call: op, per-participant payload bytes and
    chunk (bucket/leaf) count, into the registry, the payload histogram,
    the tracing funnel and the sanitizer's sequence ledger."""
    leaves = list(_iter_array_leaves(x))
    nbytes = sum(int(np.prod(leaf.shape)) * _itemsize(leaf) for leaf in leaves)
    if leaves:
        _sanitizer.record_collective(op, axis_name, tuple(leaves[0].shape), _dtype_name(leaves[0]))
    else:
        _sanitizer.record_collective(op, axis_name, (), "none")
    hist.record("collective.payloadBytes", nbytes)
    metrics.inc_counter(f"collective.axis.{axis_name}.calls")
    metrics.inc_counter(f"collective.axis.{axis_name}.bytes", int(nbytes))
    if dense_equiv_bytes:
        metrics.inc_counter(f"collective.axis.{axis_name}.sparse.bytes", int(nbytes))
        metrics.inc_counter(f"collective.axis.{axis_name}.sparse.dense_equiv_bytes",
                            int(dense_equiv_bytes))
        metrics.set_gauge(
            f"collective.sparse_ratio.{axis_name}",
            metrics.get_counter(f"collective.axis.{axis_name}.sparse.bytes")
            / max(metrics.get_counter(f"collective.axis.{axis_name}.sparse.dense_equiv_bytes"), 1))
    tracing.account_collective(op, nbytes, chunks if chunks is not None else len(leaves),
                               axis_name, dense_equiv_bytes=dense_equiv_bytes)


def axis_wire_bytes(snapshot_delta: Optional[dict] = None) -> Dict[str, int]:
    """Per-axis collective wire bytes from the (delta) metrics counters."""
    counters = (snapshot_delta.get("counters", {}) if snapshot_delta is not None
                else metrics.snapshot()["counters"])
    out: Dict[str, int] = {}
    for name, value in counters.items():
        parts = name.split(".")
        if len(parts) == 4 and parts[:2] == ["collective", "axis"] and parts[3] == "bytes":
            out[parts[2]] = int(value)
    return out


# ---------------------------------------------------------------------------
# the mesh axis and its process group
# ---------------------------------------------------------------------------

class _Axis(NamedTuple):
    """One mesh axis as this rank reduces over it: the participant count,
    the process group (None for an axis of one) and this rank's index."""

    n: int
    group: Any
    index: int


def _axis(mesh: Optional[Mesh], axis_name: str) -> _Axis:
    """`axis_name` of `mesh` (default: the default mesh): on a 2D mesh the
    sub-group of this rank's data row (`model`) or model column (`data`)."""
    mesh = mesh if mesh is not None else default_mesh()
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not an axis of {mesh}")
    n = int(mesh.shape[axis_name])
    return _Axis(n, mesh.axis_group(axis_name), mesh.axis_index(axis_name) if n > 1 else 0)


def axis_size(axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None) -> int:
    """The participant count of a mesh axis."""
    return _axis(mesh, axis_name).n


def axis_index(axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None) -> int:
    """This rank's index on a mesh axis."""
    return _axis(mesh, axis_name).index


def _staged(group, tensors: Sequence[torch.Tensor], op: str) -> bool:
    """Does `op` on these tensors go through pinned host copies: on gloo,
    for CUDA tensors, where gloo has no CUDA form of it."""
    import torch.distributed as dist

    return (any(t.is_cuda for t in tensors) and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class Pending:
    """An issued collective: `result()` waits for it (each backend wait
    bounded by the world's collective timeout) and returns its value."""

    def __init__(self, works: List, finish: Callable[[], Any]):
        self._works = [w for w in works if w is not None]
        self._finish = finish

    def result(self):
        timeout = datetime.timedelta(seconds=mesh_lib.collective_timeout_s())
        for work in self._works:
            if isinstance(work, Pending):
                work.result()
            else:
                work.wait(timeout)
        self._works = []
        return self._finish()


def _issue(fn, outputs: List[torch.Tensor], inputs: List[torch.Tensor], group, op: str,
           async_op: bool) -> Pending:
    """Run `fn(outputs, inputs, async_op)` (a torch.distributed call), on
    pinned host copies where `_staged` says so (an in-place operation names
    one tensor in both lists); the outputs are written back at `result()`."""
    if not _staged(group, outputs + inputs, op):
        return Pending([fn(outputs, inputs, async_op)], lambda: None)
    metrics.inc_counter(f"collective.staged.{op}")
    hosts = {id(t): _pinned(t) for t in inputs}
    for t in outputs:
        if id(t) not in hosts:
            hosts[id(t)] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    work = fn([hosts[id(t)] for t in outputs], [hosts[id(t)] for t in inputs], async_op)

    def back():
        for t in outputs:
            t.copy_(hosts[id(t)], non_blocking=True)
    return Pending([work], back)


def _global_rank(group, rank: int) -> int:
    import torch.distributed as dist

    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _all_reduce(t: torch.Tensor, op, group, async_op: bool = False):
    import torch.distributed as dist

    buf = t.clone(memory_format=torch.contiguous_format)
    pending = _issue(lambda outs, ins, a: dist.all_reduce(outs[0], op=op, group=group, async_op=a),
                     [buf], [buf], group, "all_reduce", async_op)
    return _finish(Pending([pending], lambda: buf), async_op)


def _finish(pending: Pending, async_op: bool):
    return pending if async_op else pending.result()


def _all_gather_flat(t: torch.Tensor, n: int, group, async_op: bool = False):
    """(n * m,) of every rank's (m,) flat tensor, in rank order."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    src = t.contiguous().reshape(-1)
    out = torch.empty((n * src.numel(),), dtype=src.dtype, device=src.device)
    pending = _issue(lambda outs, ins, a: fn(outs[0], ins[0], group=group, async_op=a),
                     [out], [src], group, "all_gather", async_op)
    return _finish(Pending([pending], lambda: out), async_op)


def _reduce_scatter_flat(t: torch.Tensor, n: int, group, async_op: bool = False):
    """This rank's (m / n,) block of the sum of every rank's (m,) tensor."""
    import torch.distributed as dist

    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    src = t.contiguous().reshape(-1)
    out = torch.empty((src.numel() // n,), dtype=src.dtype, device=src.device)
    pending = _issue(lambda outs, ins, a: fn(outs[0], ins[0], group=group, async_op=a),
                     [out], [src], group, "reduce_scatter", async_op)
    return _finish(Pending([pending], lambda: out), async_op)


def _exchange(t: torch.Tensor, ax: _Axis, shifts: Sequence[int], async_op: bool = False):
    """Send `t` to index + s and receive from index - s on the axis, for
    every shift s, all issued at once. Returns [the tensor received over
    each shift]."""
    import torch.distributed as dist

    group, rank, n = ax.group, ax.index, ax.n
    src = t.contiguous()
    recvs = [torch.empty_like(src) for _ in shifts]
    if not recvs:
        return Pending([], lambda: recvs) if async_op else recvs

    def run(outs, ins, a):
        ops = []
        for s, recv in zip(shifts, outs):
            ops.append(dist.P2POp(dist.isend, ins[0], _global_rank(group, (rank + s) % n), group))
            ops.append(dist.P2POp(dist.irecv, recv, _global_rank(group, (rank - s) % n), group))
        works = _Works(dist.batch_isend_irecv(ops))
        if a:
            return works
        works.wait(datetime.timedelta(seconds=mesh_lib.collective_timeout_s()))
        return None

    pending = _issue(run, recvs, [src], group, "p2p", async_op)
    return _finish(Pending([pending], lambda: recvs), async_op)


class _Works:
    """The works of one `batch_isend_irecv`, waited on together."""

    def __init__(self, works):
        self.works = works

    def wait(self, timeout):
        for work in self.works:
            work.wait(timeout)


def _tree_map(fn, x):
    if isinstance(x, tuple):
        return tuple(_tree_map(fn, item) for item in x)
    if isinstance(x, list):
        return [_tree_map(fn, item) for item in x]
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


# ---------------------------------------------------------------------------
# the accounted wrappers
# ---------------------------------------------------------------------------

def _reduce_op(name: str):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[name]


def all_reduce_sum(x, axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None):
    """MPI-style all-reduce-sum of a (nested) tensor structure: every rank
    gets the sum, as the backend's own all-reduce computes it (the JAX
    package's `lax.psum`; DataStreamUtils.allReduceSum of the reference)."""
    ax = _axis(mesh, axis_name)
    _account("psum", x, axis_name)
    if ax.group is None:
        return x
    return _tree_map(lambda t: _all_reduce(t, _reduce_op("sum"), ax.group), x)


def all_reduce_mean(x, axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None):
    """The all-reduce-sum over the participant count (`lax.pmean`)."""
    ax = _axis(mesh, axis_name)
    _account("pmean", x, axis_name)
    if ax.group is None:
        return x
    return _tree_map(lambda t: _all_reduce(t, _reduce_op("sum"), ax.group) / ax.n, x)


def all_reduce_max(x, axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None):
    ax = _axis(mesh, axis_name)
    _account("pmax", x, axis_name)
    if ax.group is None:
        return x
    return _tree_map(lambda t: _all_reduce(t, _reduce_op("max"), ax.group), x)


def all_reduce_min(x, axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None):
    ax = _axis(mesh, axis_name)
    _account("pmin", x, axis_name)
    if ax.group is None:
        return x
    return _tree_map(lambda t: _all_reduce(t, _reduce_op("min"), ax.group), x)


def all_gather(x, axis_name: str = DATA_AXIS, axis: int = 0, tiled: bool = True,
               mesh: Optional[Mesh] = None):
    """Every rank's tensor on every rank, in rank order: concatenated along
    `axis` when `tiled`, else stacked on a new `axis` (`lax.all_gather`)."""
    ax = _axis(mesh, axis_name)
    n = ax.n
    _account("all_gather", x, axis_name)

    def gather(t):
        if ax.group is None:
            return t if tiled else t.unsqueeze(axis)
        moved = torch.movedim(t, axis, 0)
        flat = _all_gather_flat(moved, n, ax.group)
        stacked = flat.reshape((n,) + tuple(moved.shape))
        if tiled:
            return torch.movedim(stacked.reshape((n * moved.shape[0],) + tuple(moved.shape[1:])),
                                 0, axis)
        return torch.movedim(stacked, 0, axis)
    return _tree_map(gather, x)


def reduce_scatter(x, axis_name: str = DATA_AXIS, scatter_dimension: int = 0,
                   mesh: Optional[Mesh] = None):
    """This rank's block of the sum along `scatter_dimension`, which must
    divide by the participant count (`lax.psum_scatter(tiled=True)`)."""
    ax = _axis(mesh, axis_name)
    n = ax.n
    _account("psum_scatter", x, axis_name)

    def scatter(t):
        if ax.group is None:
            return t
        if t.shape[scatter_dimension] % n:
            raise ValueError(f"reduce_scatter: dimension {scatter_dimension} of "
                             f"{tuple(t.shape)} does not divide over {n} ranks")
        moved = torch.movedim(t, scatter_dimension, 0)
        block = _reduce_scatter_flat(moved, n, ax.group)
        return torch.movedim(block.reshape((moved.shape[0] // n,) + tuple(moved.shape[1:])),
                             0, scatter_dimension)
    return _tree_map(scatter, x)


def ppermute_ring(x, axis_name: str = DATA_AXIS, shift: int = 1, mesh: Optional[Mesh] = None):
    """Ring shift: rank i's tensor goes to rank (i + shift) mod n."""
    ax = _axis(mesh, axis_name)
    _account("ppermute", x, axis_name)
    if ax.group is None:
        return x
    if shift % ax.n == 0:
        return _tree_map(lambda t: t.clone(), x)
    return _tree_map(lambda t: _exchange(t, ax, [shift])[0], x)


# ---------------------------------------------------------------------------
# bucketed / ring all-reduce (the chunked AllReduceImpl analogue)
# ---------------------------------------------------------------------------

def _reduce_bucket_rs_ag(vec: torch.Tensor, ax: _Axis, async_op: bool = False):
    """One bucket by reduce-scatter + all-gather: zero-padded to a multiple
    of n for the scatter, the padding sliced off after the gather. With
    `async_op` the reduce-scatter is issued now and the gather runs at
    `result()`."""
    m, n = vec.shape[0], ax.n
    pad = (-m) % n
    if pad:
        vec = torch.cat([vec, vec.new_zeros((pad,))])
    scattered = _reduce_scatter_flat(vec, n, ax.group, async_op=async_op)

    def gather(block):
        out = _all_gather_flat(block, n, ax.group)
        return out[:m] if pad else out
    if async_op:
        return Pending([scattered], lambda: gather(scattered.result()))
    return gather(scattered)


def _reduce_bucket_ring(vec: torch.Tensor, ax: _Axis, async_op: bool = False):
    """One bucket by the ring exchange: over the shifts 1..n-1 every rank's
    contribution reaches every other rank, and each rank folds the n
    contributions in replica order (0..n-1, left-associated), as the JAX
    ring folds its arrivals."""
    n = ax.n
    recvs = _exchange(vec, ax, list(range(1, n)), async_op=async_op)

    def fold(arrived):
        # arrived[s - 1] is the contribution of replica (index - s) mod n
        by_replica = {ax.index: vec}
        for s, t in enumerate(arrived, start=1):
            by_replica[(ax.index - s) % n] = t
        acc = by_replica[0]
        for r in range(1, n):
            acc = acc + by_replica[r]
        return acc
    if async_op:
        return Pending([recvs], lambda: fold(recvs.result()))
    return fold(recvs)


def _bucket_sizes(total: int, itemsize: int, chunk_bytes) -> List[int]:
    """Split `total` elements into size-targeted bucket lengths."""
    if not chunk_bytes or chunk_bytes <= 0:
        return [total] if total else []
    per = max(1, int(chunk_bytes) // max(1, itemsize))
    sizes = []
    off = 0
    while off < total:
        sizes.append(min(per, total - off))
        off += sizes[-1]
    return sizes


def _flatten(x) -> Tuple[List[torch.Tensor], Callable]:
    leaves: List[torch.Tensor] = []

    def collect(t):
        leaves.append(t)
        return len(leaves) - 1
    skeleton = _tree_map(collect, x)
    return leaves, lambda out: _tree_map(lambda i: out[i], skeleton)


def all_reduce_sum_chunked(x, axis_name: str = DATA_AXIS, chunk_bytes: Optional[int] = None,
                           ring: Optional[bool] = None, mesh: Optional[Mesh] = None,
                           async_op: bool = False):
    """Bucketed all-reduce-sum of a (nested) tensor structure.

    Leaves are grouped by dtype, flattened and split into `chunk_bytes`
    buckets (`config.collective_chunk_bytes` when None, default 4 MB), each
    reduced on its own: reduce-scatter + all-gather, or the ring exchange
    with `ring=True` (`config.collective_ring` when None). Chunking changes
    when bytes move; the per-element sum is the same set of additions, bit
    for bit the monolithic reduce at two ranks (module docstring, C.26).
    With `async_op` returns a `Pending` whose `result()` gives the sum."""
    from .. import config

    chunk_bytes = config.resolve_chunk_bytes(chunk_bytes)
    if ring is None:
        ring = config.collective_ring
    ax = _axis(mesh, axis_name)
    leaves, rebuild = _flatten(x)
    if not leaves or ax.group is None:
        _account("chunked", x, axis_name, chunks=len(leaves))
        return Pending([], lambda: x) if async_op else x

    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    reduce_bucket = _reduce_bucket_ring if ring else _reduce_bucket_rs_ag
    issued = []
    for dtype, idxs in by_dtype.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        sizes = _bucket_sizes(flat.shape[0], flat.element_size(), chunk_bytes)
        parts, off = [], 0
        for size in sizes:
            parts.append(reduce_bucket(flat[off:off + size], ax, async_op=async_op))
            off += size
        issued.append((idxs, parts))
    _account("chunked", x, axis_name, chunks=sum(len(parts) for _, parts in issued))

    def assemble():
        out = list(leaves)
        for idxs, parts in issued:
            done = [p.result() if isinstance(p, Pending) else p for p in parts]
            flat_red = done[0] if len(done) == 1 else torch.cat(done)
            off = 0
            for i in idxs:
                count = leaves[i].numel()
                out[i] = flat_red[off:off + count].reshape(leaves[i].shape)
                off += count
        return rebuild(out)
    return Pending([], assemble) if async_op else assemble()


# ---------------------------------------------------------------------------
# sparse index-value all-reduce (SparCML, arXiv:1802.08021)
# ---------------------------------------------------------------------------

def scatter_pairs(indices, values, dim: int):
    """One rank's (index, value) pairs as a dense (dim,) partial, the same
    bits on every rank and in every run: `index_put_(accumulate=True)`,
    which adds a column's values in their order (on the card through its
    sort-based kernel), where the `sparse_grad` kernel's atomics would give
    each rank its own last bits and the ranks' models would drift apart.
    An index < 0 or >= dim adds 0 to column 0 (dropped), as the plain
    gradient masks it."""
    flat_i, flat_v = indices.reshape(-1), values.reshape(-1)
    keep = (flat_i >= 0) & (flat_i < dim)
    out = flat_v.new_zeros((int(dim),))
    return out.index_put_((torch.where(keep, flat_i, 0).long(),),
                          torch.where(keep, flat_v, 0.0), accumulate=True)


def sparse_all_reduce_sum(indices, values, dim: int, axis_name: str = DATA_AXIS,
                          mesh: Optional[Mesh] = None, async_op: bool = False):
    """All-reduce a gradient carried as per-rank (index, value) pairs; returns
    the dense (dim,) sum of the densified operands, the same bits on every
    rank. `indices` (int32) and `values` are matching tensors of any shape;
    an index < 0 or >= dim is dropped.

    Wire bytes are the pairs, not the dim: one all-gather of each leaf.
    Every rank then scatters each rank's gathered pairs into a dense
    partial (`scatter_pairs`) and folds the partials in replica order, the
    association of the dense route. With `async_op` the gathers are issued
    and a `Pending` returned."""
    ax = _axis(mesh, axis_name)
    n = ax.n
    _account("sparse_allreduce", (indices, values), axis_name, chunks=1,
             dense_equiv_bytes=int(dim) * values.element_size())
    if ax.group is None:
        out = scatter_pairs(indices, values, dim)
        return Pending([], lambda: out) if async_op else out
    gi = _all_gather_flat(indices, n, ax.group, async_op=async_op)
    gv = _all_gather_flat(values, n, ax.group, async_op=async_op)

    def combine(flat_i, flat_v):
        gi_r, gv_r = flat_i.reshape(n, -1), flat_v.reshape(n, -1)
        acc = scatter_pairs(gi_r[0], gv_r[0], dim)
        for r in range(1, n):
            acc = acc + scatter_pairs(gi_r[r], gv_r[r], dim)
        return acc
    if async_op:
        return Pending([], lambda: combine(gi.result(), gv.result()))
    return combine(gi, gv)


def sparse_reduce_wins(nnz_local: int, dim: int, itemsize: int = 4,
                       threshold: Optional[float] = None) -> bool:
    """Use the index-value reduction when its per-rank pair bytes are at
    most `threshold` x the dense payload (`config.collective_sparse_threshold`
    when None)."""
    from .. import config

    if threshold is None:
        threshold = config.collective_sparse_threshold
    pair_bytes = int(nnz_local) * (4 + int(itemsize))
    return pair_bytes <= threshold * int(dim) * int(itemsize)


def host_all_reduce_sum(mesh: Mesh, xs):
    """Sum host partials into one tensor on this rank's device: one stacked
    upload and one device sum, in a `collective.host_all_reduce_sum` span
    with its calls and bytes counted."""
    from .prefetch import to_device

    with tracing.span("collective.host_all_reduce_sum", category="collective") as sp:
        stacked = np.stack([np.asarray(x) for x in xs])
        nbytes = int(stacked.size * stacked.itemsize)
        sp.set_attr("bytes", nbytes)
        sp.set_attr("chunks", len(xs))
        metrics.inc_counter("collective.host_all_reduce_sum.calls")
        metrics.inc_counter("collective.host_all_reduce_sum.bytes", nbytes)
        return torch.sum(to_device(stacked, mesh.device), dim=0)
