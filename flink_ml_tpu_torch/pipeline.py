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
(`_CapturedSegment`), through the program funnel's one capture mechanism
(utils/lazyjit.py): the first call of a signature runs the kernels
eagerly (which builds the CUDA kernels and the library handles outside
the capture) and then captures them into static buffers; every later call
copies the feed in, replays, and clones the outputs out of the graph's
pool. A segment's graphs share one memory pool, at most
`config.kernel_cache_size` of them are kept, and no more bytes in all the
funnel's graphs than the card has free (`lazyjit.GraphCache.make_room`).
A swap-capable stage's constants are
operands of its graphs: copied into buffers of the graph's own before a
replay. `PipelineModel.constants_as_operands()` (what a model store
calls) makes every stage's constants operands and lets the segment share
its graphs with every segment of the same architecture (stage classes and
params, where each stage's kernel reads only its params and constants:
`graph_shareable`), so that dropping a model's constants frees them and
bringing them back captures nothing. Captures run one at a time under
`capture_lock`, in `capture_error_mode="thread_local"`, so CUDA work of
another thread (a trainer's canary and uploads) cannot invalidate them.
With the program bank on (compilebank.py), a segment's signatures are
banked under `bank_kernel_id()` with its guard messages, and a fresh
process captures them at the segment's first call (`_warm_load`).
Spans: `pipeline.stage` (each stage slot of `Pipeline.fit`, each eager
transform), `pipeline.segment` (each fused segment).
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

import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compilebank, config
from .api import AlgoOperator, Estimator, KernelContext, Model, Stage
from .obs import tracing
from .table import SparseBatch, Table
from .utils import lazyjit, metrics, read_write

#: guards waiting for a drain: (messages, packed bool vector) per segment run
Pending = List[Tuple[Tuple[str, ...], torch.Tensor]]

#: held by every capture, and by CUDA work on other threads that must not
#: run inside one (a lifecycle's canary and publication): the program
#: funnel's one lock
capture_lock = lazyjit.capture_lock


def _transform_one(stage: Stage, table: Table) -> Table:
    outputs = stage.transform(table)  # type: ignore[attr-defined]
    if len(outputs) != 1:
        raise ValueError(f"Stage {type(stage).__name__} must produce exactly 1 output table")
    return outputs[0]


def _run_eager(index: int, stage: Stage, table: Table) -> Table:
    with tracing.span("pipeline.stage", index=index, stage=type(stage).__name__,
                      op="transform"):
        return _transform_one(stage, table)


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


class _CapturedSegment(lazyjit.Captured):
    """One CUDA graph of a segment for one input signature. It holds every
    tensor the graph reads or writes: the static feed, the constants (in
    `operands`), the static outputs and (through the graph) the memory pool
    that the segment's graphs share."""

    def __init__(self, segment: "FusedSegment", consts_list, feed: Dict[str, Any],
                 cache: "lazyjit.GraphCache"):
        stages = segment.stages
        self.static_feed = {name: _clone(col) for name, col in feed.items()}
        # a swap-capable stage's constants (every stage's, in operand mode)
        # are copied into buffers of the graph's own before a replay; a
        # static stage's new constants come with a new plan, so the graph
        # reads the ones it was captured with
        self.swap = [segment.operands or bool(getattr(s, "swap_capable", False)) for s in stages]
        shared = cache.shared_operands(consts_list, self.swap) if segment.operands else None
        self.operands = shared or _Operands(consts_list, self.swap)

        def body():
            cols, ctx = segment.run_kernels(self.operands.static, self.static_feed)
            return cols, ctx.packed(feed_device(feed)), tuple(ctx.guards)

        captured, (cols, self.guard_vec, self.messages) = lazyjit.capture(cache.ensure_pool(),
                                                                          body)
        super().__init__(captured.graph, captured.launches, captured.pool_bytes)
        self.outputs = {n: v for n, v in cols.items() if self.static_feed.get(n) is not v}
        # what this graph alone keeps between replays: outside the pool its
        # static feed and (unless the cache shares them) its constant
        # buffers, inside it what the capture left allocated there (its
        # outputs, measured: lazyjit.capture); the pool's temporaries are
        # shared with the segment's other graphs
        self.static_bytes = _bytes(_tree_leaves(self.static_feed)) + (
            0 if shared else self.operands.nbytes)
        self.kept_bytes = self.static_bytes + self.pool_bytes

    def run(self, consts_list, feed: Dict[str, Any]):
        for name, col in feed.items():
            for static, leaf in zip(_leaves(self.static_feed[name]), _leaves(col)):
                static.copy_(leaf)
        self.operands.load(consts_list, self.swap)
        self.replay()
        # the next replay overwrites the pool: the outputs leave it now
        out = {name: _clone(col) for name, col in self.outputs.items()}
        return out, self.messages, self.guard_vec.clone()


class _GraphCache(lazyjit.GraphCache):
    """A segment's graphs (lazyjit.GraphCache), and in operand mode the
    constant buffers that every graph of a constants signature reads."""

    def shared_operands(self, consts_list, swap: List[bool]) -> _Operands:
        key = _signature({}, consts_list)[1]
        entry = self.operands.get(key)
        if entry is None:
            entry = self.operands[key] = _Operands(consts_list, swap)
        return entry


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
        self.names = ",".join(type(s).__name__ for s in self.stages)
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

    def bank_kernel_id(self) -> Optional[str]:
        """The segment's process-restart-stable identity in the program
        bank: its stage classes and their param values (the constants'
        shapes are in the call signature). None when a param value has no
        stable token: that segment skips the bank."""
        parts = []
        for stage in self.stages:
            tokens = []
            for param, value in sorted(stage.get_param_map().items(), key=lambda kv: kv[0].name):
                token = compilebank.static_token(value)
                if token is None:
                    return None
                tokens.append(f"{param.name}={token}")
            cls = type(stage)
            parts.append(f"{cls.__module__}.{cls.__qualname__}({','.join(tokens)})")
        return "pipeline.FusedSegment[" + ";".join(parts) + "]"

    def _replay_or_capture(self, consts_list, feed: Dict[str, Any]):
        sig = _signature(feed, consts_list)
        bank = compilebank.active_bank()
        kernel_id = self.bank_kernel_id() if bank is not None else None
        if kernel_id is not None and self.graphs.__dict__.get("warmed_bank") is not bank:
            self.graphs.warmed_bank = bank
            self._warm_load(bank, kernel_id, consts_list, feed_device(feed))
        entry = self.graphs.get(sig)
        if entry is not None:
            if bank is not None and entry.banked:
                bank.count_hit()
                tracing.event("bank.hit", kernel=kernel_id, category="cache")
            return entry.run(consts_list, feed)
        if bank is not None:
            bank.count_miss()
        # the first call of a signature runs eagerly (real, counted
        # launches; nvcc builds and library handles made outside capture),
        # then captures the same kernels for the calls after it
        start = time.perf_counter()
        cols, ctx = self.run_kernels(consts_list, feed)
        out = {n: v for n, v in cols.items() if feed.get(n) is not v}
        result = (out, tuple(ctx.guards), ctx.packed(feed_device(feed)))
        entry = self._capture(consts_list, feed)
        lazyjit.account_capture(time.perf_counter() - start, kernel_id or "pipeline.FusedSegment")
        if kernel_id is not None:
            bank.offer(compilebank.signature_digest(kernel_id, sig), {
                "kernel": kernel_id, "segment": True,
                "leaves": [_leaf_json(t) for col in feed.values() for t in _leaves(col)],
                "feed": [_feed_json(name, col) for name, col in sorted(feed.items())],
                "extras": {"guards": list(entry.messages)}})
        return result

    def _capture(self, consts_list, feed: Dict[str, Any]) -> _CapturedSegment:
        device = feed_device(feed)
        self.graphs.make_room(lazyjit.free_bytes(device), _bytes(_tree_leaves(feed)))
        entry = _CapturedSegment(self, consts_list, feed, self.graphs)
        self.graphs.put(_signature(feed, consts_list), entry)
        return entry

    def _warm_load(self, bank, kernel_id: str, consts_list, device: torch.device) -> None:
        """Capture every banked signature of this segment whose constants
        match the live ones, on a synthetic feed (zeros of the banked
        shapes), ahead of its first call. The banked guard messages must be
        the captured ones."""

        def load(entry):
            feed = {f["name"]: _synthetic_col(f, device) for f in entry["feed"]}
            sig = _signature(feed, consts_list)
            if self.graphs.get(sig) is not None:
                return
            if compilebank.signature_digest(kernel_id, sig) not in \
                    {s for s, _ in bank.entries_for(kernel_id)}:
                raise ValueError("its constants' shapes differ from the served model's")
            self.run_kernels(consts_list, feed)  # the warm-up
            captured = self._capture(consts_list, feed)
            captured.banked = True
            guards = (entry.get("extras") or {}).get("guards")
            if guards is not None and list(captured.messages) != list(guards):
                raise ValueError(f"captured guards {captured.messages} are not the banked {guards}")

        bank.warm_load_segment(kernel_id, load)


def _leaf_json(t: torch.Tensor) -> Dict[str, Any]:
    return compilebank.leaf_json(lazyjit.leaf_descriptor(t))


def _feed_json(name: str, col) -> Dict[str, Any]:
    return {"name": name, "kind": type(col).__name__,
            "size": col.size if isinstance(col, SparseBatch) else None,
            "leaves": [_leaf_json(t) for t in _leaves(col)]}


def _synthetic_col(desc: Dict[str, Any], device: torch.device):
    leaves = [compilebank.synthetic_leaf(d, device) for d in desc["leaves"]]
    if desc["kind"] == "SparseBatch":
        return SparseBatch(desc["size"], leaves[0], leaves[1])
    return leaves[0]


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
                    with tracing.span("pipeline.segment", index=seg.start, stages=seg.names,
                                      numStages=len(seg.stages), op="transform", fused=True):
                        table = seg.execute(table, feed, pending)
                    fused_segments += 1
                    fused_stages += len(seg.stages)
                    continue
                _drain_guards(pending)
                for i, stage in zip(seg.indices, seg.stages):
                    table = _run_eager(i, stage, table)
            else:
                _drain_guards(pending)
                table = _run_eager(run[1], run[2], table)
        metrics.set_gauge("pipeline.fused_segments", fused_segments)
        metrics.set_gauge("pipeline.fused_stages", fused_stages)
        return table

    def _run(self, table: Table, pending: Pending) -> Table:
        if config.pipeline_fusion == "off":
            for i, stage in enumerate(self._stages):
                table = _run_eager(i, stage, table)
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
                # one span a stage slot: the stage's fit and its transform
                # of the training data for the stages after it
                with tracing.span("pipeline.stage", index=i, stage=type(stage).__name__,
                                  op="fit"):
                    model = stage.fit(table) if isinstance(stage, Estimator) else stage
                    model_stages.append(model)
                    if i < last_estimator_idx:
                        if not isinstance(model, AlgoOperator):
                            raise TypeError(
                                f"Intermediate stage {type(stage).__name__} cannot transform data"
                            )
                        table = _transform_one(model, table)
        return PipelineModel(model_stages)
