"""The five-interface Stage contract and the transform-kernel protocol.

Port of flink_ml_tpu/api.py (the reference's api/Stage.java,
AlgoOperator.java, Transformer.java, Model.java, Estimator.java) without
the tracing hook (ROADMAP A.14). Save/load keeps the reference's directory
layout: `{path}/metadata` JSON plus model data under `{path}/data`.

The transform-kernel protocol (`:117-252` there) lets the fusion planner
(pipeline.py) run consecutive stages as one fused segment: a stage whose
transform of tensor columns is a pure per-batch computation sets
`fusable = True` and implements `transform_kernel`. Its eager transform
runs the same kernel (`_transform_with_kernel`), so the fused and eager
results are equal by construction; host columns are staged to the device
first and the outputs come back as host arrays. Only where a host
column's result differs from the kernel's (a float64 output, numpy's op
order, a SparseBatch layout, rows dropped by 'skip') does a stage keep a
branch of its own, and its module docstring says so: Binarizer,
Bucketizer, MinMaxScalerModel, ElementwiseProduct and IDFModel for
SparseBatches, VectorAssembler for 'skip', OnlineLogisticRegressionModel.
"""

from __future__ import annotations

import abc
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .param import WithParams
from .table import SparseBatch, Table


class KernelContext:
    """Collector of deferred validation guards.

    A transform kernel may not branch on a value it computed (on the card
    that is a host sync, and inside a captured graph it cannot run at all),
    so it registers a 0-d bool tensor and its message here instead. The
    caller reads every guard back in one packed transfer and raises the
    message of the first one that fired."""

    def __init__(self):
        self.guards: Dict[str, torch.Tensor] = {}

    def guard(self, pred: torch.Tensor, message: str) -> None:
        """Register `pred` (a 0-d bool tensor, True == invalid) to raise
        ValueError(message) at the next guard drain."""
        prev = self.guards.get(message)
        self.guards[message] = pred if prev is None else prev | pred

    def packed(self, device: torch.device) -> torch.Tensor:
        """The guards as one bool vector, in registration order."""
        if not self.guards:
            return torch.zeros((0,), dtype=torch.bool, device=device)
        return torch.stack([g.reshape(()).to(torch.bool) for g in self.guards.values()])


def as_kernel_matrix(col: torch.Tensor) -> torch.Tensor:
    """`as_dense_matrix`'s tensor rule for kernel code: a 1-D column becomes
    an (n, 1) view, everything else passes through."""
    return col if col.ndim > 1 else col[:, None]


def column_dtype(col) -> torch.dtype:
    """The dtype of a kernel input: a tensor's, a SparseBatch's values', or
    a placeholder's (pipeline._DensePlaceholder)."""
    return col.values.dtype if isinstance(col, SparseBatch) else col.dtype


def _map_leaves(node, fn):
    """`node` (dicts, lists, tuples) with every leaf replaced by fn(leaf).
    A module function, not a recursive closure: a closure that refers to
    itself is a reference cycle, which would keep what it captured (the
    uploaded tensors) alive until the garbage collector runs."""
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_leaves(v, fn) for v in node)
    return fn(node)


class HostConstants:
    """A constants tree (dicts, lists, tuples of host arrays and scalars)
    packed once into one host buffer: each leaf in its host dtype at an
    offset aligned to `ALIGN` bytes, the buffer page-locked once it is
    uploaded to a card. `upload` puts the tree on a device with one
    asynchronous copy on the current stream, ledgered under `model`
    (obs/memledger.py) while the uploaded tensors live: dropping them frees
    them at once. A stage keeps its HostConstants across uploads, so paging
    a model in costs one host-to-device copy."""

    #: the offset alignment of each leaf in the buffer
    ALIGN = 256

    def __init__(self, tree):
        leaves: List[np.ndarray] = []

        def index(node):
            leaves.append(np.ascontiguousarray(np.asarray(node)))
            return len(leaves) - 1

        self.layout = _map_leaves(tree, index)
        self.specs = []  # per leaf: (offset, nbytes, torch dtype, shape)
        offset = 0
        for a in leaves:
            self.specs.append((offset, a.nbytes, torch.from_numpy(a).dtype, a.shape))
            offset += -(-a.nbytes // self.ALIGN) * self.ALIGN
        self.nbytes = offset
        self.buffer = torch.zeros(offset, dtype=torch.uint8)
        for a, (off, nbytes, _, _) in zip(leaves, self.specs):
            self.buffer[off:off + nbytes] = torch.from_numpy(a.reshape(-1).view(np.uint8))

    def upload(self, device: torch.device):
        """The tree as tensors on `device`, accounted (`h2d.*`) and ledgered."""
        import time

        from .obs import memledger
        from .parallel import prefetch

        if not self.specs:
            return self.layout
        if device.type == "cuda" and not self.buffer.is_pinned():
            self.buffer = self.buffer.pin_memory()
        memledger.admit(self.nbytes, "model")
        t0 = time.perf_counter()
        try:
            out = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        except torch.cuda.OutOfMemoryError as e:
            raise memledger.wrap_oom(e) from e
        out.copy_(self.buffer, non_blocking=True)
        prefetch.account_h2d(sum(spec[1] for spec in self.specs), arrays=len(self.specs),
                             seconds=time.perf_counter() - t0)
        tensors = [out[off:off + nbytes].view(dtype).view(shape)
                   for off, nbytes, dtype, shape in self.specs]
        return memledger.track(_map_leaves(self.layout, tensors.__getitem__), "model")


def upload_constants(tree, device: torch.device):
    """A tree of host arrays and scalars as tensors on `device`, in the
    host dtypes, through one copy (`HostConstants`)."""
    return HostConstants(tree).upload(torch.device(device))


class Stage(WithParams, abc.ABC):
    """Base class for all pipeline nodes; persistable with params (Stage.java:43)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _instrument_model_publication(cls)

    def save(self, path: str) -> None:
        from .utils import read_write

        read_write.save_metadata(self, path)
        self._save_extra(path)

    def _save_extra(self, path: str) -> None:
        """Hook for subclasses to persist model data under `{path}/data`."""

    @classmethod
    def load(cls, path: str) -> "Stage":
        from .utils import read_write

        stage = read_write.instantiate_with_params(read_write.load_metadata(path))
        if not isinstance(stage, cls):
            raise TypeError(f"Loaded stage {type(stage).__name__} is not a {cls.__name__}")
        stage._load_extra(path)
        return stage

    def _load_extra(self, path: str) -> None:
        """Hook for subclasses to restore model data from `{path}/data`."""


def _instrument_model_publication(cls) -> None:
    """Route every concrete `set_model_data` through an explicit constants
    invalidation: the wrapper bumps `model_data_version` after each
    publication, so the device-constant cache and the fusion plan never
    serve a stale upload even when a freed array's `id()` is reused."""
    fn = getattr(cls, "set_model_data", None)  # a mixin's too (_linear.CoefficientModelData)
    if fn is None or not callable(fn) or getattr(fn, "_publish_instrumented", False):
        return

    @functools.wraps(fn)
    def wrapped(self, *inputs):
        result = fn(self, *inputs)
        bump = getattr(self, "bump_model_data_version", None)
        if bump is not None:
            bump()
        return result

    wrapped._publish_instrumented = True
    cls.set_model_data = wrapped


class AlgoOperator(Stage):
    """A stage that transforms N input tables into M output tables (AlgoOperator.java:31).

    Transform-kernel protocol: a fusable stage implements

    - `transform_kernel(consts, cols, ctx)`: a column dict to a column dict
      of tensors (or tensor SparseBatches). `consts` is `device_constants()`;
      params are read from `self`, and a param change gives a new fusion
      plan. The kernel must not synchronize with the host or copy host
      data to the card (no `.item()`, `.tolist()`, boolean-mask indexing,
      `torch.as_tensor` of numpy): every tensor it needs besides the
      columns comes from `consts`, and data-dependent validation goes
      through `ctx.guard`. On the card it runs inside a CUDA graph capture.
    - `_kernel_constants()`: host constants, uploaded once per state by
      `device_constants()`; `_constant_sources()`: the arrays whose
      identity keys that cache.

    Stages whose transform is host-resident set `fusable = False` with a
    non-empty `fusable_reason`.
    """

    #: True requires transform_kernel; False requires fusable_reason
    fusable: bool = False
    fusable_reason: str = ""
    #: the kernel takes SparseBatch input columns
    kernel_supports_sparse: bool = False
    #: the kernel's output columns are SparseBatches
    kernel_emits_sparse: bool = False
    #: the kernel reads nothing of the stage but its params and `consts`
    #: (no model data held in Python), so stages of one class and params
    #: may share captured graphs that take their constants as operands
    #: (PipelineModel.constants_as_operands)
    graph_shareable: bool = False

    @abc.abstractmethod
    def transform(self, *inputs: Table) -> List[Table]:
        ...

    def supports_fusion(self) -> bool:
        """Param-level fusion gate: override when some params make the
        transform impure (handleInvalid='skip' drops rows)."""
        return self.fusable

    def transform_kernel(self, consts, cols: Dict[str, Any], ctx: KernelContext) -> Dict[str, Any]:
        raise NotImplementedError(f"{type(self).__name__} does not expose a transform kernel")

    def kernel_input_cols(self) -> List[str]:
        """Columns the kernel reads, from the stage's column params."""
        cols: List[str] = []
        for getter in ("get_input_col", "get_features_col"):
            if hasattr(self, getter):
                value = getattr(self, getter)()
                if value:
                    cols.append(value)
        if hasattr(self, "get_input_cols"):
            cols.extend(self.get_input_cols() or ())
        return cols

    def kernel_output_cols(self) -> List[str]:
        """Columns the kernel writes, from the stage's column params."""
        cols: List[str] = []
        for getter in ("get_output_col", "get_prediction_col", "get_raw_prediction_col"):
            if hasattr(self, getter):
                value = getattr(self, getter)()
                if value:
                    cols.append(value)
        if hasattr(self, "get_output_cols"):
            cols.extend(self.get_output_cols() or ())
        return cols

    def kernel_output_dtypes(self, cols: Dict[str, Any]) -> Dict[str, torch.dtype]:
        """The dtype of each dense column the kernel writes, given its input
        columns (tensors, or placeholders of columns produced earlier in a
        segment): by default the promoted dtype of the inputs. Stages that
        emit a fixed dtype override it."""
        dtypes = [column_dtype(c) for c in cols.values()]
        dtype = functools.reduce(torch.promote_types, dtypes) if dtypes else torch.float32
        return {name: dtype for name in self.kernel_output_cols()}

    def kernel_ready(self, cols: Dict[str, Any]) -> bool:
        """Runtime veto: `cols` maps the kernel's input names to the columns
        (or placeholders of columns produced earlier in the segment)."""
        return True

    def kernel_takes(self, table: Table) -> bool:
        """Whether the eager transform of `table` runs the kernel: every
        input column is there and is a tensor the kernel takes (dense, or a
        SparseBatch where `kernel_supports_sparse`)."""
        if not self.supports_fusion():
            return False
        for name in self.kernel_input_cols():
            if name not in table:
                return False
            col = table.column(name)
            if isinstance(col, SparseBatch):
                if not (self.kernel_supports_sparse and isinstance(col.indices, torch.Tensor)):
                    return False
            elif not isinstance(col, torch.Tensor):
                return False
        return True

    def _transform_with_kernel(self, table: Table, stage=None) -> Table:
        """The eager transform through this stage's kernel, its guards
        drained at once (one accounted host sync when it registers any).
        `stage`, for a table whose columns the kernel does not take as they
        are (`kernel_takes`), maps each input column to one it takes: a
        host column staged to `config.device()`, a tensor SparseBatch
        densified on its device. The outputs of a transform of host input
        come back as host arrays (`_outputs_on_host`, `_host_outputs`)."""
        from .pipeline import _drain_guards, feed_device

        cols = {name: table.column(name) for name in self.kernel_input_cols()}
        on_host = self._outputs_on_host(cols)
        if stage is not None and not self.kernel_takes(table):
            cols = {name: stage(col) for name, col in cols.items()}
        device = feed_device(cols)
        ctx = KernelContext()
        out = self.transform_kernel(self.device_constants(device), dict(cols), ctx)
        if ctx.guards:
            _drain_guards([(tuple(ctx.guards), ctx.packed(device))])
        out = {n: v for n, v in out.items() if cols.get(n) is not v}
        return table.with_columns(self._host_outputs(out) if on_host else out)

    def _outputs_on_host(self, cols: Dict[str, Any]) -> bool:
        """Whether a transform of these input columns returns host arrays:
        when any of them is a host column (device in, device out)."""
        from .pipeline import _column_kind

        return any(_column_kind(col) == "host" for col in cols.values())

    def _host_outputs(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """The kernel's output columns as host arrays, each in its dtype."""
        def host(col):
            if isinstance(col, SparseBatch):
                return SparseBatch(col.size, col.indices.cpu().numpy(), col.values.cpu().numpy())
            return col.cpu().numpy()

        return {name: host(col) for name, col in out.items()}

    # -- device constants ----------------------------------------------------
    def _kernel_constants(self) -> Dict[str, Any]:
        """Host constants the kernel needs (model arrays, derived scales,
        index vectors). Values the eager path derives in host float64 are
        derived here."""
        return {}

    def _constant_sources(self) -> tuple:
        """Raw arrays whose object identity versions the constant cache."""
        return ()

    @property
    def model_data_version(self) -> int:
        """Monotone publication counter, bumped by every `set_model_data`
        and by a swap-capable model's publications."""
        return self.__dict__.get("_model_data_version", 0)

    def bump_model_data_version(self) -> None:
        """Explicit constants invalidation for a model-data change."""
        self.__dict__["_model_data_version"] = self.model_data_version + 1
        self.__dict__.pop("_device_consts", None)
        self.__dict__.pop("_host_consts", None)

    def device_constants(self, device: Optional[torch.device] = None):
        """`_kernel_constants()` on `device` (default `config.device()`):
        derived and packed on the host once per (params, model data) state
        (`HostConstants`), uploaded at most once per (state, device)."""
        if device is None:
            from . import config

            device = config.device()
        state = (
            self.__dict__.get("_params_version", 0),
            self.model_data_version,
            tuple(id(a) for a in self._constant_sources()),
        )
        token = state + (torch.device(device),)
        cached = self.__dict__.get("_device_consts")
        if cached is not None and cached[0] == token:
            return cached[1]
        host = self.__dict__.get("_host_consts")
        if host is None or host[0] != state:
            host = self.__dict__["_host_consts"] = (state, HostConstants(self._kernel_constants()))
        consts = host[1].upload(torch.device(device))
        self.__dict__["_device_consts"] = (token, consts)
        return consts

    def invalidate_device_constants(self) -> None:
        """Drop the device copy of the constants (the packed host copy stays,
        so the next `device_constants` is one upload)."""
        self.__dict__.pop("_device_consts", None)


class Transformer(AlgoOperator):
    """Marker: a one-in-one-out record-wise AlgoOperator (Transformer.java:31)."""


class Model(Transformer):
    """A Transformer with explicit model data tables (Model.java:31-50).

    Swap protocol: a model whose serving arrays may be replaced while a
    captured segment is live sets `swap_capable = True` and implements the
    three hooks below. The fusion planner then keeps its plan and its
    captured graphs across publications, and copies the new constants into
    the graph's buffers before the next replay. A publication is one
    reference assignment of an immutable (version, arrays) record, so a
    reader never sees new arrays with an old version."""

    #: the model's constants are swappable inputs of a captured segment
    swap_capable: bool = False

    def set_model_data(self, *inputs: Table) -> "Model":
        raise NotImplementedError(f"{type(self).__name__} does not support set_model_data")

    def get_model_data(self) -> List[Table]:
        raise NotImplementedError(f"{type(self).__name__} does not support get_model_data")

    def model_arrays(self) -> tuple:
        """The published serving arrays, from one record read."""
        raise NotImplementedError(f"{type(self).__name__} is not swap-capable")

    def publish_model_arrays(self, arrays: tuple, version: int) -> None:
        """Publish `(version, arrays)` as the serving model in one swap."""
        raise NotImplementedError(f"{type(self).__name__} is not swap-capable")

    def kernel_constants_for(self, arrays: tuple, version: int = 0):
        """`_kernel_constants()` of a candidate arrays tuple (not the
        published one)."""
        raise NotImplementedError(f"{type(self).__name__} is not swap-capable")


class Estimator(Stage):
    """A stage that fits a Model from training tables (Estimator.java:30).

    Checkpoint contract (JAX `api.py:303-315`): every concrete estimator
    declares `checkpointable`. True means its iterative fit snapshots
    through the JobSnapshot API (ckpt/): `run_sgd`/`optimize_stream`,
    `iterate_unbounded`, or `save_job_snapshot`/`load_job_snapshot`
    directly, so a preempted fit resumes from its last epoch boundary
    under `config.iteration_checkpoint_dir`. False comes with a non-empty
    `checkpoint_reason` saying why the fit holds no resumable state."""

    checkpointable: Optional[bool] = None
    checkpoint_reason: str = ""

    @abc.abstractmethod
    def fit(self, *inputs: Table) -> Model:
        ...
