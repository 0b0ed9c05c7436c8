"""Pipeline / PipelineModel: stages in sequence, and the transform fusion planner.

Port of flink_ml_tpu/pipeline.py (the reference's builder/Pipeline.java:
79-107 and PipelineModel.java:63-68). `Pipeline.fit` fits each Estimator
on the data as the stages before it transformed it, and transforms only up
to the last Estimator. `PipelineModel.transform` runs a fusion planner:
consecutive stages that implement the transform-kernel protocol
(api.AlgoOperator) form maximal segments, and a segment whose input
columns are tensors runs as one unit, the columns passing from kernel to
kernel on their device. Stages without a kernel break segments. The
segments' validation guards come back in one packed readback at the
pipeline's exit, or before a stage outside a segment runs.

On the card each segment is one captured CUDA graph per input signature
(`_CapturedSegment`): the first call of a signature runs the kernels
eagerly (which builds the CUDA kernels and the library handles outside
the capture) and then captures them into static buffers; every later call
copies the feed in, replays, and clones the outputs out of the graph's
pool. A segment's graphs share one memory pool, and it keeps at most
`config.kernel_cache_size` of them, and no more bytes in them than the
card has free (`_GraphCache`). A swap-capable stage's constants are
operands of its graphs: copied into buffers of the graph's own before a
replay. `PipelineModel.constants_as_operands()` (what a model store
calls) makes every stage's constants operands and lets the segment share
its graphs with every segment of the same architecture (stage classes and
params, where each stage's kernel reads only its params and constants:
`graph_shareable`), so that dropping a model's constants frees them and
bringing them back captures nothing. Captures run one at a time under
`capture_lock`, in `capture_error_mode="thread_local"`, so CUDA work of
another thread (a trainer's canary and uploads) cannot invalidate them.
On the CPU a segment calls its kernels in turn. The plan is the JAX
package's: a segment is vetoed as a whole when
a column is host data, or is a SparseBatch that a stage's kernel does not
take, so the BASELINE pipeline (OneHotEncoder feeds VectorAssembler
sparse columns) and the text pipeline (HashingTF feeds IDF) run eagerly
in both packages.
`config.pipeline_fusion = "off"` runs every stage eagerly.

Save and load keep the reference's layout: the pipeline's metadata with
`numStages`, and each stage under `stages/{index}`.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from .api import AlgoOperator, Estimator, KernelContext, Model, Stage
from .table import SparseBatch, Table
from .utils import metrics, read_write

#: guards waiting for a drain: (messages, packed bool vector) per segment run
Pending = List[Tuple[Tuple[str, ...], torch.Tensor]]

#: held by every capture, and by CUDA work on other threads that must not
#: run inside one (a lifecycle's canary and publication)
capture_lock = threading.RLock()


def _transform_one(stage: Stage, table: Table) -> Table:
    outputs = stage.transform(table)  # type: ignore[attr-defined]
    if len(outputs) != 1:
        raise ValueError(f"Stage {type(stage).__name__} must produce exactly 1 output table")
    return outputs[0]


# ---------------------------------------------------------------------------
# the fusion planner
# ---------------------------------------------------------------------------

class _DensePlaceholder:
    """A dense column produced earlier in a segment: only its dtype is known
    before the segment runs (the dtype the producing kernel emits for its
    inputs, which Bucketizer's `kernel_ready` reads)."""

    __slots__ = ("dtype",)

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype


_SPARSE = object()  # a SparseBatch produced earlier in a segment


def _column_kind(col) -> str:
    """'dense' (a tensor, on any device), 'sparse' (a tensor SparseBatch) or
    'host'."""
    if isinstance(col, SparseBatch):
        return "sparse" if isinstance(col.indices, torch.Tensor) else "host"
    return "dense" if isinstance(col, torch.Tensor) else "host"


def _stage_is_fusable(stage: Stage) -> bool:
    return (
        isinstance(stage, AlgoOperator)
        and stage.supports_fusion()
        and type(stage).transform_kernel is not AlgoOperator.transform_kernel
    )


def feed_device(cols: Dict[str, Any]) -> torch.device:
    """The device of a segment's (or a stage's) input tensors."""
    for col in cols.values():
        t = col.indices if isinstance(col, SparseBatch) else col
        if isinstance(t, torch.Tensor):
            return t.device
    return config.device()


def _leaves(col) -> List[torch.Tensor]:
    return [col.indices, col.values] if isinstance(col, SparseBatch) else [col]


def _tree_leaves(node) -> List[torch.Tensor]:
    if isinstance(node, dict):
        return [t for v in node.values() for t in _tree_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in _tree_leaves(v)]
    return _leaves(node)


def _clone(col):
    if isinstance(col, SparseBatch):
        return SparseBatch(col.size, col.indices.clone(), col.values.clone())
    return col.clone()


def _clone_tree(node):
    if isinstance(node, dict):
        return {k: _clone_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_clone_tree(v) for v in node)
    return _clone(node)


def _signature(feed: Dict[str, Any], consts_list) -> tuple:
    """What a captured graph is specialised to: each feed column's kind,
    shape and dtype (and a SparseBatch's width), and each constant's shape
    and dtype."""
    cols = tuple(
        (name, type(col).__name__, col.size if isinstance(col, SparseBatch) else None,
         tuple((tuple(t.shape), t.dtype, t.stride()) for t in _leaves(col)))
        for name, col in sorted(feed.items())
    )
    consts = tuple(tuple((tuple(t.shape), t.dtype) for t in _tree_leaves(c)) for c in consts_list)
    return cols, consts


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _first_ref(tree):
    """A weak reference to a constants tree's first tensor (None for a tree
    without tensors): which tree a static buffer holds, without keeping it
    alive."""
    leaves = _tree_leaves(tree)
    return weakref.ref(leaves[0]) if leaves else None


def _holds(ref, tree) -> bool:
    leaves = _tree_leaves(tree)
    return not leaves or (ref is not None and ref() is leaves[0])


class _Operands:
    """The static buffers of the constants a graph reads as operands (a
    stage's entry is its constants themselves where they are not operands),
    and which constants they hold. A tree is never written in place (a new
    publication or a page-in is a new upload), so its first tensor's
    identity names its values."""

    def __init__(self, consts_list, swap: List[bool]):
        self.static = [_clone_tree(c) if op else c for c, op in zip(consts_list, swap)]
        self.held = [_first_ref(c) if op else None for c, op in zip(consts_list, swap)]
        self.nbytes = _bytes([t for c, op in zip(self.static, swap) if op for t in _tree_leaves(c)])

    def load(self, consts_list, swap: List[bool]) -> None:
        """Copy each operand stage's constants in, where the buffers hold
        others; on the caller's stream, so a batch in flight keeps the
        version it was dispatched with."""
        for i, consts in enumerate(consts_list):
            if swap[i] and not _holds(self.held[i], consts):
                for static, leaf in zip(_tree_leaves(self.static[i]), _tree_leaves(consts)):
                    static.copy_(leaf)
                self.held[i] = _first_ref(consts)


class _CapturedSegment:
    """One CUDA graph of a segment for one input signature. It holds every
    tensor the graph reads or writes: the static feed, the constants (in
    `operands`), the static outputs and (through the graph) the memory pool
    that the segment's graphs share."""

    def __init__(self, segment: "FusedSegment", consts_list, feed: Dict[str, Any],
                 cache: "_GraphCache"):
        from .ops import sparsekernels

        stages = segment.stages
        self.static_feed = {name: _clone(col) for name, col in feed.items()}
        # a swap-capable stage's constants (every stage's, in operand mode)
        # are copied into buffers of the graph's own before a replay; a
        # static stage's new constants come with a new plan, so the graph
        # reads the ones it was captured with
        self.swap = [segment.operands or bool(getattr(s, "swap_capable", False)) for s in stages]
        shared = cache.shared_operands(consts_list, self.swap) if segment.operands else None
        self.operands = shared or _Operands(consts_list, self.swap)
        self.graph = torch.cuda.CUDAGraph()
        before = sparsekernels.launch_counts()
        with capture_lock, torch.cuda.graph(self.graph, pool=cache.pool,
                                            capture_error_mode="thread_local"):
            cols, ctx = segment.run_kernels(self.operands.static, self.static_feed)
            self.guard_vec = ctx.packed(feed_device(feed))
        after = sparsekernels.launch_counts()
        # capture launches nothing: its counted launches move to each replay
        self.launches = {k: after[k.__name__] - before[k.__name__] for k in sparsekernels.KERNELS}
        for kernel, n in self.launches.items():
            kernel.launches -= n
        self.messages = tuple(ctx.guards)
        self.outputs = {n: v for n, v in cols.items() if self.static_feed.get(n) is not v}
        # what this graph alone keeps between replays: outside the pool its
        # static feed and (unless the cache shares them) its constant
        # buffers, inside it its outputs; the pool's temporaries are shared
        # with the segment's other graphs
        self.static_bytes = _bytes(_tree_leaves(self.static_feed)) + (
            0 if shared else self.operands.nbytes)
        self.kept_bytes = self.static_bytes + _bytes(_tree_leaves(self.outputs) + [self.guard_vec])
        metrics.inc_counter("jit.traces")

    def replay(self, consts_list, feed: Dict[str, Any]):
        for name, col in feed.items():
            for static, leaf in zip(_leaves(self.static_feed[name]), _leaves(col)):
                static.copy_(leaf)
        self.operands.load(consts_list, self.swap)
        self.graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n
        # the next replay overwrites the pool: the outputs leave it now
        out = {name: _clone(col) for name, col in self.outputs.items()}
        return out, self.messages, self.guard_vec.clone()


def _free_bytes(device: torch.device) -> int:
    """What the card can still give: its free memory and the blocks
    PyTorch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


class _GraphCache:
    """A segment's captured graphs by input signature, least recently used
    first, and the memory pool they share. Replays of a segment run one at
    a time on one stream and their outputs are cloned out at once, so a
    graph's temporaries may lie where another graph's were. `lock` makes
    each call (feed and constants copied in, replay, outputs cloned out)
    one unit on the host, so two threads serving tenants of one
    architecture cannot interleave their copies into shared buffers."""

    def __init__(self):
        self.entries: "OrderedDict[tuple, _CapturedSegment]" = OrderedDict()
        self.pool = None
        self.lock = threading.Lock()
        #: operand mode: constant buffers by constants signature, which every
        #: graph of that signature reads
        self.operands: Dict[tuple, _Operands] = {}

    def shared_operands(self, consts_list, swap: List[bool]) -> _Operands:
        key = _signature({}, consts_list)[1]
        entry = self.operands.get(key)
        if entry is None:
            entry = self.operands[key] = _Operands(consts_list, swap)
        return entry

    def get(self, sig: tuple) -> Optional[_CapturedSegment]:
        entry = self.entries.get(sig)
        if entry is not None:
            self.entries.move_to_end(sig)
        return entry

    def make_room(self, free_bytes: int) -> None:
        """Before a capture: drop the least recently used graphs while there
        are `config.kernel_cache_size` of them or more, or while they keep
        more bytes than the card has free (`free_bytes`), so that batches
        of many distinct shapes cannot fill the card. A dropped graph's
        blocks go back to the shared pool, where the capture reuses them."""
        while self.entries and (
            len(self.entries) >= config.kernel_cache_size
            or sum(e.kept_bytes for e in self.entries.values()) > free_bytes
        ):
            self.entries.popitem(last=False)
            metrics.inc_counter("jit.kernelCacheEvict")


#: the graph caches of operand-mode segments, by architecture
_SHARED_GRAPHS: Dict[tuple, _GraphCache] = {}


def _architecture(stages: Sequence[AlgoOperator]) -> Optional[tuple]:
    """What an operand-mode segment's graphs depend on besides their inputs'
    signature: each stage's class and params, where every stage's kernel
    reads only its params and its constants (`graph_shareable`); else None
    (the segment keeps graphs of its own)."""
    key = []
    for stage in stages:
        if not getattr(stage, "graph_shareable", False):
            return None
        params = tuple(sorted((p.name, repr(v)) for p, v in stage.get_param_map().items()))
        key.append((type(stage), params))
    return tuple(key)


class FusedSegment:
    """A maximal run of fusable stages, run as one unit. In operand mode
    every stage's constants are operands of its graphs, which it shares
    with the segments of its architecture."""

    def __init__(self, indexed_stages: Sequence[Tuple[int, Stage]], operands: bool = False):
        self.indices = [i for i, _ in indexed_stages]
        self.stages: List[AlgoOperator] = [s for _, s in indexed_stages]
        self.operands = operands
        arch = _architecture(self.stages) if operands else None
        self.graphs = _GraphCache() if arch is None else _SHARED_GRAPHS.setdefault(arch, _GraphCache())

    @property
    def start(self) -> int:
        return self.indices[0]

    def ready_feed(self, table: Table) -> Optional[Dict[str, Any]]:
        """The columns to feed the segment, or None when it cannot run fused
        on this table (host columns, a SparseBatch a stage's kernel does not
        take, or a stage's `kernel_ready` veto)."""
        produced: Dict[str, Any] = {}
        feed: Dict[str, Any] = {}
        for stage in self.stages:
            view: Dict[str, Any] = {}
            for name in stage.kernel_input_cols():
                if name in produced:
                    col = produced[name]
                    kind = "sparse" if col is _SPARSE else "dense"
                elif name in table:
                    col = table.column(name)
                    kind = _column_kind(col)
                    if kind == "host":
                        return None
                    feed[name] = col
                else:
                    return None
                if kind == "sparse" and not stage.kernel_supports_sparse:
                    return None
                view[name] = col
            if not stage.kernel_ready(view):
                return None
            if stage.kernel_emits_sparse:
                produced.update((name, _SPARSE) for name in stage.kernel_output_cols())
            else:
                dense_view = {n: c for n, c in view.items() if c is not _SPARSE}
                for name, dtype in stage.kernel_output_dtypes(dense_view).items():
                    produced[name] = _DensePlaceholder(dtype)
        return feed

    def run_kernels(self, consts_list, cols: Dict[str, Any]) -> Tuple[Dict[str, Any], KernelContext]:
        """The stages' kernels in turn; returns the columns and the guards."""
        ctx = KernelContext()
        for stage, consts in zip(self.stages, consts_list):
            cols = stage.transform_kernel(consts, dict(cols), ctx)
        return cols, ctx

    def execute(self, table: Table, feed: Dict[str, Any], pending: Pending) -> Table:
        # each stage's constants are read once here: the batch keeps the
        # version it was dispatched with, however many swaps land meanwhile
        device = feed_device(feed)
        consts_list = [stage.device_constants(device) for stage in self.stages]
        if device.type == "cuda":
            if device.index in (None, torch.cuda.current_device()):
                out, messages, guard_vec = self._run_captured(consts_list, feed)
            else:
                with torch.cuda.device(device):
                    out, messages, guard_vec = self._run_captured(consts_list, feed)
        else:
            cols, ctx = self.run_kernels(consts_list, feed)
            out = {n: v for n, v in cols.items() if feed.get(n) is not v}
            messages, guard_vec = tuple(ctx.guards), ctx.packed(device)
        if messages:
            pending.append((messages, guard_vec))
        return table.with_columns(out)

    def _run_captured(self, consts_list, feed: Dict[str, Any]):
        with self.graphs.lock:
            return self._replay_or_capture(consts_list, feed)

    def _replay_or_capture(self, consts_list, feed: Dict[str, Any]):
        sig = _signature(feed, consts_list)
        entry = self.graphs.get(sig)
        if entry is not None:
            return entry.replay(consts_list, feed)
        # the first call of a signature runs eagerly (real, counted
        # launches; nvcc builds and library handles made outside capture),
        # then captures the same kernels for the calls after it
        cols, ctx = self.run_kernels(consts_list, feed)
        out = {n: v for n, v in cols.items() if feed.get(n) is not v}
        result = (out, tuple(ctx.guards), ctx.packed(feed_device(feed)))
        device = feed_device(feed)
        self.graphs.make_room(_free_bytes(device))
        if self.graphs.pool is None:
            self.graphs.pool = torch.cuda.graph_pool_handle()
        self.graphs.entries[sig] = _CapturedSegment(self, consts_list, feed, self.graphs)
        return result


class _FusionPlan:
    """A stage list cut into fused segments and eager stages."""

    def __init__(self, stages: Sequence[Stage], operands: bool = False):
        self.runs: List[Tuple[Any, ...]] = []  # ("fused", seg) | ("eager", i, stage)
        buf: List[Tuple[int, Stage]] = []
        for i, stage in enumerate(stages):
            if _stage_is_fusable(stage):
                buf.append((i, stage))
            else:
                if buf:
                    self.runs.append(("fused", FusedSegment(buf, operands)))
                    buf = []
                self.runs.append(("eager", i, stage))
        if buf:
            self.runs.append(("fused", FusedSegment(buf, operands)))
        self.has_fusable = any(kind == "fused" for kind, *_ in self.runs)


def _drain_guards(pending: Pending) -> None:
    """ONE packed readback of every pending guard vector; raises the first
    registered message whose guard fired. Accounted as one transform host
    sync, the only one a fused transform pays."""
    if not pending:
        return
    from .utils.packing import packed_device_get

    vectors = packed_device_get(*[v for _, v in pending], sync_kind="transform")
    entries = list(pending)
    pending.clear()
    for (messages, _), values in zip(entries, vectors):
        for message, value in zip(messages, np.asarray(values)):
            if bool(value):
                raise ValueError(message)


class _StageList(Stage):
    """The stage list and its save/load in the `stages/{index}` layout."""

    def __init__(self, stages: Sequence[Stage] = ()):
        self._stages: List[Stage] = list(stages)

    @property
    def stages(self) -> List[Stage]:
        return self._stages

    def save(self, path: str) -> None:
        read_write.save_metadata(self, path, {"numStages": len(self._stages)})
        for i, stage in enumerate(self._stages):
            stage.save(read_write.get_path_for_pipeline_stage(i, len(self._stages), path))

    def _load_extra(self, path: str) -> None:
        metadata = read_write.load_metadata(path)
        num_stages = int(metadata.get("numStages", metadata.get("num_stages", 0)))
        self._stages = [
            read_write.load_stage(read_write.resolve_pipeline_stage_path(i, num_stages, path))
            for i in range(num_stages)
        ]


class PipelineModel(_StageList, Model):
    """Model produced by Pipeline.fit (builder/PipelineModel.java)."""

    fusable = False
    fusable_reason = "composite stage: fusion runs across its member stages"

    def _fusion_plan(self) -> _FusionPlan:
        """The cached plan, rebuilt when the stage list, a stage's params or
        a static stage's model arrays change (a captured graph reads the
        constants it was captured with). A swap-capable stage leaves its
        arrays and publication counter out of the token: a swap is new
        values in the same buffers, not a new graph."""
        token = tuple(
            (
                id(stage),
                stage.__dict__.get("_params_version", 0),
                (stage.model_data_version,) + tuple(id(a) for a in stage._constant_sources())
                if isinstance(stage, AlgoOperator) and not getattr(stage, "swap_capable", False)
                else (),
            )
            for stage in self._stages
        )
        operands = self.__dict__.get("_constants_as_operands", False)
        token += (operands,)
        cached = self.__dict__.get("_plan_cache")
        if cached is not None and cached[0] == token:
            return cached[1]
        plan = _FusionPlan(self._stages, operands)
        self.__dict__["_plan_cache"] = (token, plan)
        return plan

    def constants_as_operands(self) -> None:
        """From now on every fused segment takes its stages' constants as
        operands of its captured graphs, copied in before a replay, and
        shares its graphs with the segments of its architecture: so the
        constants can be dropped (a model store's page-out frees them) and
        uploaded again (a page-in) without a capture."""
        self.__dict__["_constants_as_operands"] = True

    def _transform_fused(self, table: Table, pending: Pending) -> Table:
        """Run the plan: each device-ready segment fused, the others and
        the stages outside segments eagerly, with the pending guards
        drained before any eager stage."""
        plan = self._fusion_plan()
        fused_segments = fused_stages = 0
        for run in plan.runs:
            if run[0] == "fused":
                seg: FusedSegment = run[1]
                feed = seg.ready_feed(table)
                if feed is not None:
                    table = seg.execute(table, feed, pending)
                    fused_segments += 1
                    fused_stages += len(seg.stages)
                    continue
                _drain_guards(pending)
                for stage in seg.stages:
                    table = _transform_one(stage, table)
            else:
                _drain_guards(pending)
                table = _transform_one(run[2], table)
        metrics.set_gauge("pipeline.fused_segments", fused_segments)
        metrics.set_gauge("pipeline.fused_stages", fused_stages)
        return table

    def _run(self, table: Table, pending: Pending) -> Table:
        if config.pipeline_fusion == "off":
            for stage in self._stages:
                table = _transform_one(stage, table)
            return table
        return self._transform_fused(table, pending)

    def transform(self, *inputs: Table) -> List[Table]:
        if len(inputs) != 1:
            raise ValueError("PipelineModel.transform expects exactly 1 input table")
        pending: Pending = []
        with metrics.timed("pipeline.transform"):
            table = self._run(inputs[0], pending)
            _drain_guards(pending)
        return [table]

    def transform_deferred(self, table: Table) -> Tuple[Table, Pending]:
        """The transform without its exit drain: the output table (its
        columns possibly still being computed on the card) and the pending
        (messages, guard vector) entries, which a later `_drain_guards`
        reads back and raises."""
        pending: Pending = []
        with metrics.timed("pipeline.transform"):
            table = self._run(table, pending)
        return table, pending


class Pipeline(_StageList, Estimator):
    """Sequential Estimator (builder/Pipeline.java:79-107)."""

    checkpointable = False
    checkpoint_reason = (
        "composite stage: each contained estimator snapshots its own "
        "fit through config.iteration_checkpoint_dir; the pipeline itself holds no training state"
    )

    def fit(self, *inputs: Table) -> PipelineModel:
        if len(inputs) != 1:
            raise ValueError("Pipeline.fit expects exactly 1 input table")
        table = inputs[0]
        last_estimator_idx = max(
            (i for i, stage in enumerate(self._stages) if isinstance(stage, Estimator)),
            default=-1,
        )
        model_stages: List[Stage] = []
        with metrics.timed("pipeline.fit"):
            for i, stage in enumerate(self._stages):
                model = stage.fit(table) if isinstance(stage, Estimator) else stage
                model_stages.append(model)
                if i < last_estimator_idx:
                    if not isinstance(model, AlgoOperator):
                        raise TypeError(
                            f"Intermediate stage {type(stage).__name__} cannot transform data"
                        )
                    table = _transform_one(model, table)
        return PipelineModel(model_stages)
