"""Micro-batch serving: bounded in-flight, overload-graceful fused inference.

Port of flink_ml_tpu/serving.py. It drives a fused `PipelineModel`
transform plan (pipeline.py: on the card one captured CUDA graph a
segment and batch signature) over a stream of mini-batches, with:

1. **Bucket padding**: a captured graph is specialised to its input
   shapes, so each batch is padded up to the smallest configured bucket
   (default: powers of two from 8) by repeating its last row (a pad row
   can fire no guard the real rows would not). Captures are bounded by the
   number of buckets.
2. **One accounted upload a batch**: the padded batch's host columns go to
   the card in one copy through the server's `DeviceStager` (pinned ring of
   `in_flight + 2` slots, each reused only after its copy has landed; the
   copy on the dispatching thread's stream, ahead of the replay that reads
   it; floating columns staged as float32, as the JAX package's uploads
   canonicalize them). The window ledgers each batch's upload under
   `serving` from dispatch to retirement.
3. **Bounded in-flight window**: batch i's transform is dispatched with
   its guard drain deferred (`PipelineModel.transform_deferred`), and its
   one readback is started at once (`_Readback`: the guard vectors, and
   the output columns of a push result that is sliced on the host, packed
   into one byte buffer and copied to pinned memory on the dispatch's
   stream). The (output, readback) pair parks in a `flow.BoundedChannel`
   of capacity `in_flight`; the host waits on a batch's readback only when
   the batch leaves the window, so batch i+1's upload and dispatch overlap
   batch i's compute. That wait is the batch's one transform host sync
   (`iteration.host_sync.transform`), whatever the pipeline's depth. (The
   JAX package pays no sync for a guard-free batch that stays on the
   device; the port waits on every batch, so that the window bounds the
   work the card has queued.)
4. **Admission control and deadlines** (`submit`/`results`, the push API):
   a `reject`-policy admission channel in front of the dispatch worker
   (`ServerOverloaded` with the live depth once `admission` requests
   wait), per-tenant quota gates, requests shed as `"expired"` before
   dispatch when their deadline passed, delivered as `"late"` after it.
5. **Transient-fault resilience**: batch dispatch runs under
   `flow.with_retries` (the `serving.batch` fault site) and a
   `flow.StragglerWatchdog`; a data or guard error comes back per request
   (status `"error"`), while a failure of the server itself (a kernel that
   does not build or launch, a refused capture) ends the stream and
   `results()` raises it. `health()` returns a `ServerHealth` snapshot.
6. **Model hot-swap and the model store**: an attached
   `lifecycle.ModelLifecycle` receives every retired batch's guard outcome
   (a run of guard errors rolls traffic back). With `batching="continuous"`
   requests coalesce into per-tenant forming batches that flush on a full
   bucket (`form_rows`) or on the forming budget
   (`config.serving_form_budget_ms`); `"fixed"` flushes on a full bucket
   only. A `data.modelstore.ModelStore` routes each tenant to its own
   model, paged under an LRU byte budget; its models serve their
   constants as operands of graphs shared by their architecture, so a
   page-in captures nothing. Results are equal bit for bit across the
   three modes: the kernels reduce each row in a fixed order whatever the
   batch, and pad rows copy real rows.

Capture: `warmup` drives every (tenant x bucket) program once ahead of
traffic, so each graph is captured before the first request; captures
run under `pipeline.capture_lock` in `capture_error_mode="thread_local"`,
and a lifecycle's promotion and canary take the same lock, so a trainer
thread's uploads and kernels can neither land inside a capture nor
invalidate one. A capture or a kernel build that fails raises.

Pull-loop (`serve`) results are yielded in order, device-resident and
sliced on the device. Push-loop results retire in dispatch order (the
submission order within a tenant); a padded or coalesced batch's rows come
back as host arrays sliced on the host, a solo unpadded one stays on the
device. A batch's guard failure raises when that batch is yielded, at most
`in_flight` batches late, never reordered or dropped; an abandoned
`serve` releases its window (`serving.cancelled`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config, flow
from .ckpt import faults
from .obs import hist, memledger, timeline, tracing
from .parallel.prefetch import DeviceStager, next_bucket, pad_rows, slice_rows
from .pipeline import Pending, PipelineModel
from .table import SparseBatch, Table
from .utils import metrics

__all__ = [
    "MicroBatchServer",
    "ServerHealth",
    "ServerOverloaded",
    "ServeResult",
    "serve_stream",
]

BATCHING_MODES = ("request", "fixed", "continuous")


class ServerOverloaded(flow.ChannelRejected):
    """`submit` fast-fail: the admission queue (or the tenant's quota gate,
    `channel` = `serving.tenant.<name>`) is full; carries the live depth
    and capacity."""


@dataclass
class ServeResult:
    """One retired request of the push API. `status` is `"ok"`, `"late"`
    (finished past its deadline), `"expired"` (the deadline passed before
    dispatch; `table` is None) or `"error"` (`error` holds the exception)."""

    seq: int
    status: str
    table: Optional[Table] = None
    error: Optional[BaseException] = None
    tenant: Optional[str] = None


@dataclass
class ServerHealth:
    """A point-in-time snapshot of the server: every overload decision it
    made, its latencies and its memory."""

    inFlight: int  # window capacity
    windowDepth: int  # transformed-but-undrained batches now
    admissionCapacity: int
    admissionDepth: int  # submitted-but-undispatched requests now
    submitted: int
    rejected: int  # submits refused at the door (ServerOverloaded)
    completed: int  # results delivered (any status)
    expired: int  # shed before dispatch: the deadline had passed
    late: int  # delivered after their deadline
    errors: int  # per-request failures delivered as status "error"
    retries: int  # transient-fault retries paid by batch dispatch
    cancelled: int  # in-flight batches released by an early serve() exit
    bucketsSeen: int
    emaBatchMs: float  # dispatch trailing-mean latency (watchdog EMA)
    stragglers: int
    hbmLiveBytes: int = 0  # ledgered device bytes (obs/memledger.py)
    hbmPeakBytes: int = 0
    #: per-stage latency percentiles (obs/hist.py); a stage with no
    #: observation maps to None
    stageLatencyMs: Dict[str, Optional[Dict[str, float]]] = None
    #: {tenant: {admitted, rejected, depth, capacity}} of the quota gates
    tenantAdmission: Dict[str, Dict[str, int]] = None
    #: the attached ModelStore's stats, or None
    modelStore: Optional[Dict[str, int]] = None

    #: the stage histograms, in ms: queue wait (submit -> dequeue), forming
    #: wait (dequeue -> the coalesced batch's flush), batch formation (pad
    #: + upload), dispatch (the fused plan's launch and the readback's
    #: start), readback (the wait on the batch), and the deadline margin
    #: left at delivery
    STAGES = (
        ("queueWait", "serving.queueWaitMs"),
        ("formWait", "serving.formWaitMs"),
        ("batchForm", "serving.batchFormMs"),
        ("dispatch", "serving.dispatchMs"),
        ("readback", "serving.readbackMs"),
        ("deadlineMargin", "serving.deadlineMarginMs"),
    )


def _per_request(error: BaseException) -> bool:
    """Whether a dispatch or retirement failure belongs to its requests
    (status "error", the stream goes on): a data or guard error, a
    transient fault past its retries, a budget refusal. Any other
    RuntimeError (a kernel that failed to build or launch, a capture the
    card refused, a missing card) is the server's: it ends the stream and
    `results()` raises it."""
    return not isinstance(error, RuntimeError) or isinstance(
        error, (flow.TransientError, memledger.HbmBudgetExceeded))


def _tensor_leaves(col) -> List[torch.Tensor]:
    if isinstance(col, SparseBatch):
        return [col.indices, col.values] if isinstance(col.indices, torch.Tensor) else []
    return [col] if isinstance(col, torch.Tensor) else []


class _Readback:
    """A batch's one readback, started when it is dispatched: its guard
    vectors and the output columns `names`, packed as bytes into one buffer
    and copied to pinned host memory on the current stream without
    blocking. `wait` synchronizes on that copy (the batch's one host sync,
    after its own work only), raises the first guard that fired in
    registration order, and returns the host columns. `source` is the
    request batch as it came (unpadded), whose columns a push result
    passes through."""

    def __init__(self, pending: Pending, out: Table, names: List[str], source: Table):
        self.messages = [messages for messages, _ in pending]
        self.names = names
        self.source = source
        self.sparse = {n: out.column(n).size for n in names if isinstance(out.column(n), SparseBatch)}
        leaves = [v for _, v in pending] + [t for n in names for t in _tensor_leaves(out.column(n))]
        self.specs = [(t.dtype, tuple(t.shape), t.numel() * t.element_size()) for t in leaves]
        devices = [t.device for n in out.column_names for t in _tensor_leaves(out.column(n))]
        self.device = leaves[0].device if leaves else (devices[0] if devices else None)
        self.host = self.event = self.ledger = None
        if leaves:
            flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in leaves])
            if flat.is_cuda:
                self.host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
                self.host.copy_(flat, non_blocking=True)
            else:
                self.host = flat
        if self.device is not None and self.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if self.event is not None:
            # tpulint: disable=host-sync-leak -- a served batch's one readback
            self.event.synchronize()
        if self.device is None:
            return {}
        tracing.account_host_sync("transform")
        if self.host is None:
            return {}
        tracing.account_readback(self.host.numel(), time.perf_counter() - t0, len(self.specs))
        raw = self.host.numpy()
        arrays, offset = [], 0
        for dtype, shape, nbytes in self.specs:
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            arrays.append(np.array(raw[offset:offset + nbytes].view(np_dtype).reshape(shape)))
            offset += nbytes
        for messages, values in zip(self.messages, arrays):
            for message, value in zip(messages, values):
                if bool(value):
                    raise ValueError(message)
        it = iter(arrays[len(self.messages):])
        cols: Dict[str, Any] = {}
        for name in self.names:
            if name in self.sparse:
                cols[name] = SparseBatch(self.sparse[name], next(it), next(it))
            else:
                cols[name] = next(it)
        return cols


class _Forming:
    """One tenant's forming batch: requests coalescing toward a bucket.
    `flush_at` is the earliest member's forming deadline (`inf` under fixed
    batching)."""

    __slots__ = ("tenant", "sig", "reqs", "rows", "flush_at")

    def __init__(self, tenant, sig):
        self.tenant = tenant
        self.sig = sig
        self.reqs: List[Tuple[int, Table, Optional[float], float]] = []
        self.rows = 0
        self.flush_at = float("inf")

    def add(self, seq: int, batch: Table, deadline: Optional[float], flush_at: float) -> None:
        self.reqs.append((seq, batch, deadline, time.monotonic()))
        self.rows += batch.num_rows
        self.flush_at = min(self.flush_at, flush_at)


class MicroBatchServer:
    """Drives fused transform plans over a batch stream.

    `in_flight` bounds the transformed-but-undrained window (default
    `config.serving_in_flight`); `buckets` pins the padded batch shapes
    (else powers of two). `device_input=True` uploads each padded batch's
    numeric host columns before dispatch. `admission` bounds the push API's
    queue (`config.serving_admission`); `deadline_ms` is the default
    per-request deadline; `retries` the dispatch's transient-retry budget
    (`config.transient_retries`). `batching` is `"request"` (each submit
    alone), `"continuous"` or `"fixed"`; `form_rows` the forming target
    (default the largest bucket, else 64); `form_budget_ms` the forming
    budget. `store` (a ModelStore) routes `tenant=` submits to their own
    models; quotas come from the store or `tenant_quotas`.

    The server computes on `config.device()`, and raises as it does when
    there is no card and the CPU was not asked for."""

    def __init__(
        self,
        model: Optional[PipelineModel] = None,
        in_flight: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
        device_input: bool = True,
        admission: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        retries: Optional[int] = None,
        lifecycle=None,
        batching: str = "request",
        form_rows: Optional[int] = None,
        form_budget_ms: Optional[float] = None,
        store=None,
        tenant_quotas: Optional[Dict[str, int]] = None,
    ):
        if model is None and store is None:
            raise TypeError("MicroBatchServer needs a model, a ModelStore, or both")
        if model is not None and not isinstance(model, PipelineModel):
            raise TypeError(f"MicroBatchServer serves a PipelineModel, got {type(model).__name__}")
        if batching not in BATCHING_MODES:
            raise ValueError(f"unknown batching mode {batching!r} (one of {BATCHING_MODES})")
        self.device = config.device()
        self.model = model
        self.store = store
        self.batching = batching
        self.in_flight = max(1, int(in_flight if in_flight is not None else config.serving_in_flight))
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.form_rows = max(1, int(form_rows if form_rows is not None
                                    else (self.buckets[-1] if self.buckets else 64)))
        self.form_budget_ms = (form_budget_ms if form_budget_ms is not None
                               else config.serving_form_budget_ms)
        self.device_input = device_input
        self.admission = max(1, int(admission if admission is not None else config.serving_admission))
        self.deadline_ms = deadline_ms if deadline_ms is not None else config.serving_deadline_ms
        self.retries = retries
        self.lifecycle = lifecycle
        self.watchdog = flow.StragglerWatchdog("serving.batch")
        # the window's batches, the one being staged and the one dispatched;
        # uploads go on the dispatching thread's stream, ahead of the replay
        self._stager = DeviceStager(self.device, torch.float32, slots=self.in_flight + 2,
                                    side_stream=False)
        self._stage_lock = threading.Lock()
        self._tenant_quotas = dict(tenant_quotas) if tenant_quotas else {}
        self._tenant_gates: Dict[str, flow.BoundedChannel] = {}
        self._buckets_seen: set = set()
        self._counts: Dict[str, int] = {"completed": 0, "expired": 0, "late": 0, "errors": 0,
                                        "retries": 0, "cancelled": 0}
        self._window: Optional[flow.BoundedChannel] = None  # the latest serve window
        self._requests: Optional[flow.BoundedChannel] = None
        self._out: Optional[flow.BoundedChannel] = None
        self._worker = None
        self._start_lock = threading.Lock()
        self._seq = 0

    # -- batch staging -------------------------------------------------------
    def _stage_batch(self, batch: Table) -> Tuple[Table, int, int]:
        """Pad `batch` to its bucket and upload its numeric host columns in
        one accounted copy. Returns (the staged table, rows before padding,
        bytes uploaded: the window ledgers them under `serving` until the
        batch retires)."""
        n = batch.num_rows
        bucket = next_bucket(n, self.buckets)
        self._buckets_seen.add(bucket)
        cols: Dict[str, Any] = {}
        uploads: Dict[str, Any] = {}
        for name in batch.column_names:
            col = batch.column(name)
            if self.device_input and self._uploadable(col):
                uploads[name] = col
            else:
                cols[name] = pad_rows(col, n, bucket)

        def padded(a):  # the rows and the pad as row pieces the upload copies in turn
            if bucket == n:
                return a
            return [a, torch.from_numpy(a[n - 1:]).expand((bucket - n,) + a.shape[1:])]

        nbytes = 0
        if uploads:
            tree = tuple((padded(c.indices), padded(c.values)) if isinstance(c, SparseBatch)
                         else padded(c) for c in uploads.values())
            with self._stage_lock:
                staged = self._stager(tree)
            nbytes = staged.nbytes
            for (name, col), leaf in zip(uploads.items(), staged.wait()):
                cols[name] = SparseBatch(col.size, *leaf) if isinstance(col, SparseBatch) else leaf
        return Table({name: cols[name] for name in batch.column_names}), n, nbytes

    @staticmethod
    def _uploadable(col) -> bool:
        if isinstance(col, SparseBatch):
            return isinstance(col.indices, np.ndarray)
        return isinstance(col, np.ndarray) and col.dtype != object and col.dtype.kind not in ("U", "S")

    def _model_for(self, tenant: Optional[str]) -> PipelineModel:
        """A request's model: its tenant's store entry (paged in on the
        spot) or the server-wide default."""
        if self.store is not None and tenant is not None:
            return self.store.acquire(tenant)
        if self.model is None:
            raise TypeError("MicroBatchServer has no default model: submit with tenant= "
                            "or construct with model=")
        return self.model

    def _dispatch(self, batch: Table, index: int, model: Optional[PipelineModel] = None,
                  push: bool = False, coalesced: bool = False):
        """Stage, dispatch and start the readback of one batch, under the
        transient-retry budget and the straggler watchdog (the
        `serving.batch` fault site sits inside the retried unit). A push
        result that will be sliced on the host (padded or coalesced) reads
        its output columns back with its guards. Returns (out, readback, n)."""
        served = model if model is not None else self._model_for(None)

        def attempt():
            faults.tick("serving.batch")
            t0 = time.perf_counter()
            staged, n, nbytes = self._stage_batch(batch)
            t1 = time.perf_counter()
            out, pending = served.transform_deferred(staged)
            # a push result sliced on the host (padded or coalesced) reads
            # back the columns the transform produced; the others are the
            # request's own
            names = [c for c in out.column_names
                     if _tensor_leaves(out.column(c))
                     and (c not in staged or out.column(c) is not staged.column(c))] \
                if push and (coalesced or n != out.num_rows) else []
            readback = _Readback(pending, out, names, batch)
            if nbytes:
                readback.ledger = memledger.register("serving", nbytes, site="serving.window")
            t2 = time.perf_counter()
            hist.record("serving.batchFormMs", (t1 - t0) * 1000.0)
            hist.record("serving.dispatchMs", (t2 - t1) * 1000.0)
            if timeline.enabled():
                timeline.record_complete(timeline.LANE_SERVING, "serving.batchForm", int(t0 * 1e9),
                                         int((t1 - t0) * 1e9), index=index)
                timeline.record_complete(timeline.LANE_SERVING, "serving.dispatch", int(t1 * 1e9),
                                         int((t2 - t1) * 1e9), index=index)
            return out, readback, n

        with tracing.span("serving.batch", index=index, op="dispatch"):
            with self.watchdog.observe():
                return flow.with_retries(attempt, site="serving.batch", retries=self.retries,
                                         on_retry=lambda e, a: self._count("retries"))

    def _count(self, key: str, n: int = 1) -> None:
        self._counts[key] = self._counts.get(key, 0) + n

    # -- warmup: every graph captured ahead of traffic -----------------------
    @staticmethod
    def _example_rows(example: Table, rows: int) -> Table:
        """`example` cut or padded (repeating its last row) to `rows` rows."""
        n = example.num_rows
        return Table({name: slice_rows(col, rows) if n >= rows else pad_rows(col, n, rows)
                      for name, col in ((c, example.column(c)) for c in example.column_names)})

    def warmup(self, example: Table, tenants: Optional[Sequence[Optional[str]]] = None,
               buckets: Optional[Sequence[int]] = None) -> Dict[str, float]:
        """Drive every (tenant x bucket) serving program once ahead of
        traffic, so each captured graph exists before the first request.
        `example` is a schema template (one real batch). Tenants page in
        through the store first. With the program bank on
        (`config.program_bank_dir`, compilebank.py), a fresh process's
        warmup captures the banked signatures as warm loads and the new
        ones back-fill the bank. Returns {"programs", "warmupMs",
        "captures", "bankHits", "bankMisses", "bankLoads"}; a guard
        tripped by the synthetic rows is swallowed."""
        if buckets is None:
            buckets = self.buckets or [next_bucket(self.form_rows, None)]
        buckets = sorted({int(b) for b in buckets})
        if tenants is None:
            tenants = list(self.store.keys()) if self.store is not None else [None]
        if self.store is not None:
            self.store.prefetch([t for t in tenants if t is not None], wait=True)
        t0 = time.perf_counter()
        counted = ("jit.traces", "bank.hits", "bank.misses", "jit.bankLoads")
        before = {k: metrics.get_counter(k) for k in counted}
        programs = 0
        for tenant in tenants:
            model = self._model_for(tenant)
            for bucket in buckets:
                try:
                    out, readback, n = self._dispatch(self._example_rows(example, bucket), index=-1,
                                                      model=model)
                    self._finish(out, readback, n)
                except ValueError:
                    pass  # a guard fired on the synthetic rows; the program exists
                programs += 1
        wall_ms = (time.perf_counter() - t0) * 1000.0
        metrics.record_time("serving.warmup", wall_ms / 1000.0)
        delta = {k: float(metrics.get_counter(k) - before[k]) for k in counted}
        return {"programs": float(programs), "warmupMs": wall_ms,
                "captures": delta["jit.traces"], "bankHits": delta["bank.hits"],
                "bankMisses": delta["bank.misses"], "bankLoads": delta["jit.bankLoads"]}

    def _finish(self, out: Table, readback: _Readback, n: int) -> Table:
        """Retire one batch: wait on its readback (its one host sync), then
        cut the padding off. The guard outcome feeds the lifecycle."""
        t0 = time.perf_counter()
        memledger.release(readback.ledger)
        try:
            host = readback.wait()
        except Exception as e:
            if self.lifecycle is not None:
                self.lifecycle.record_guard_error(e)
            raise
        finally:
            dt = time.perf_counter() - t0
            hist.record("serving.readbackMs", dt * 1000.0)
            if timeline.enabled():
                timeline.record_complete(timeline.LANE_SERVING, "serving.readback", int(t0 * 1e9),
                                         int(dt * 1e9))
        if self.lifecycle is not None:
            self.lifecycle.record_serve_ok()
        if host:
            out = out.with_columns(host)
        if out.num_rows == n:
            return out
        return Table({name: slice_rows(out.column(name), n) for name in out.column_names})

    def _release(self, window: flow.BoundedChannel) -> None:
        """Early-exit cleanup: drop every batch still in flight (its staged
        buffers and readback go with their references)."""
        leaked = window.cancel()
        for entry in leaked:
            memledger.release(next(e for e in entry if isinstance(e, _Readback)).ledger)
        if leaked:
            metrics.inc_counter("serving.cancelled", len(leaked))
            self._count("cancelled", len(leaked))
        metrics.set_gauge("serving.buckets", len(self._buckets_seen))

    # -- the pull loop -------------------------------------------------------
    def serve(self, stream: Iterable[Table]) -> Iterator[Table]:
        """Transform every batch of `stream`, yielding output Tables in
        input order (device-resident columns, sliced on the device). An
        item may also be a `(tenant, Table)` pair, dispatched against that
        tenant's store model (the JAX package's pull loop serves its default
        model only)."""
        window = flow.BoundedChannel(self.in_flight, policy=flow.BLOCK, name="serving.window")
        self._window = window
        num_batches = 0
        metrics.set_gauge("serving.in_flight", self.in_flight)
        try:
            for item in stream:
                tenant, batch = item if isinstance(item, tuple) else (None, item)
                entry = self._dispatch(batch, num_batches, model=self._model_for(tenant))
                if not window.offer(entry):  # window full: retire the oldest
                    # offer() just returned False, so get() cannot block
                    yield self._finish(*window.get())
                    window.offer(entry)
                num_batches += 1
                metrics.inc_counter("serving.batches")
                metrics.inc_counter("serving.records", entry[2])
                metrics.set_gauge("serving.buckets", len(self._buckets_seen))
            while len(window):
                yield self._finish(*window.get())
        finally:
            self._release(window)

    # -- the push loop: admission control and deadlines ----------------------
    def start(self) -> None:
        """Bring up the dispatch worker and its channels (idempotent;
        `submit` starts it)."""
        if self._worker is not None:
            return
        with self._start_lock:
            if self._worker is not None:
                return
            self._requests = flow.BoundedChannel(self.admission, policy=flow.REJECT,
                                                 name="serving.admit")
            # sized so a retired batch never blocks the worker while the
            # admission queue and the window are full
            self._out = flow.BoundedChannel(self.admission + self.in_flight + 1,
                                            policy=flow.BLOCK, name="serving.results")
            metrics.set_gauge("serving.in_flight", self.in_flight)
            self._worker = flow.spawn(self._run, name="serving.dispatch")

    def _quota_gate(self, tenant: Optional[str]) -> Optional[flow.BoundedChannel]:
        """The tenant's reject-policy gate (from `tenant_quotas` or the
        store), or None. An admitted request holds one credit until it
        leaves the queue and forming pipeline."""
        if tenant is None:
            return None
        gate = self._tenant_gates.get(tenant)
        if gate is None:
            quota = self._tenant_quotas.get(tenant)
            if quota is None and self.store is not None and tenant in self.store:
                quota = self.store.quota(tenant)
            if quota is None:
                return None
            gate = flow.BoundedChannel(max(1, int(quota)), policy=flow.REJECT,
                                       name=f"serving.tenant.{tenant}")
            self._tenant_gates[tenant] = gate
        return gate

    def _quota_release(self, tenant: Optional[str]) -> None:
        gate = self._tenant_gates.get(tenant) if tenant is not None else None
        if gate is None:
            return
        try:
            gate.get(timeout=0)
        except (TimeoutError, flow.ChannelClosed):
            pass

    def submit(self, batch: Table, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> int:
        """Admit one batch and return its sequence number; raises
        `ServerOverloaded` when `admission` requests wait or `tenant`'s
        quota gate is full."""
        if self._worker is None:
            self.start()
        if self.store is not None and tenant is not None and tenant not in self.store:
            raise KeyError(f"tenant {tenant!r} is not registered in the model store")
        ms = deadline_ms if deadline_ms is not None else self.deadline_ms
        deadline = None if ms is None else time.monotonic() + ms / 1000.0
        seq = self._seq
        gate = self._quota_gate(tenant)
        if gate is not None:
            try:
                gate.put(seq)
            except flow.ChannelRejected as e:
                metrics.inc_counter("serving.rejected")
                metrics.inc_counter(f"serving.rejected.tenant.{tenant}")
                raise ServerOverloaded(e.channel, e.depth, e.capacity) from None
        try:
            self._requests.put((seq, tenant, batch, deadline, time.monotonic()))
        except flow.ChannelRejected as e:
            if gate is not None:  # refund the tenant's credit
                self._quota_release(tenant)
            metrics.inc_counter("serving.rejected")
            raise ServerOverloaded(e.channel, e.depth, e.capacity) from None
        self._seq += 1
        metrics.inc_counter("serving.batches")
        metrics.inc_counter("serving.records", batch.num_rows)
        return seq

    def close(self) -> None:
        """No more submits; the worker drains what was admitted (flushing
        partial forming batches) and closes the results stream."""
        if self._requests is not None:
            self._requests.close()

    def results(self) -> Iterator[ServeResult]:
        """Retired requests, FIFO per tenant; ends once `close()` was called
        and every admitted request retired."""
        if self._worker is None:
            self.start()
        yield from self._out

    def health(self) -> ServerHealth:
        """A `ServerHealth` snapshot."""
        stage_latency: Dict[str, Optional[Dict[str, float]]] = {}
        for label, hist_name in ServerHealth.STAGES:
            p = hist.percentiles(hist_name)
            stage_latency[label] = None if p is None else {
                k: p[k] for k in ("count", "p50", "p90", "p99", "p999")}
        tenants = {tenant: {"admitted": gate.stats.puts, "rejected": gate.stats.rejected,
                            "depth": len(gate), "capacity": gate.capacity}
                   for tenant, gate in self._tenant_gates.items()}
        rejected = self._requests.stats.rejected if self._requests is not None else 0
        rejected += sum(g.stats.rejected for g in self._tenant_gates.values())
        return ServerHealth(
            inFlight=self.in_flight,
            windowDepth=len(self._window) if self._window is not None else 0,
            admissionCapacity=self.admission,
            admissionDepth=len(self._requests) if self._requests is not None else 0,
            submitted=self._requests.stats.puts if self._requests is not None else 0,
            rejected=rejected,
            completed=self._counts["completed"],
            expired=self._counts["expired"],
            late=self._counts["late"],
            errors=self._counts["errors"],
            retries=self._counts["retries"],
            cancelled=self._counts["cancelled"],
            bucketsSeen=len(self._buckets_seen),
            emaBatchMs=self.watchdog.trailing_mean_s * 1000.0,
            stragglers=metrics.get_counter("flow.straggler.serving.batch", 0),
            hbmLiveBytes=memledger.live_bytes(),
            hbmPeakBytes=memledger.peak_bytes(),
            stageLatencyMs=stage_latency,
            tenantAdmission=tenants,
            modelStore=self.store.stats if self.store is not None else None,
        )

    def _run(self) -> None:
        """The dispatch worker: admission queue -> (forming) -> window ->
        results. A worker failure closes the results channel with the
        error, so consumers re-raise instead of hanging."""
        window = flow.BoundedChannel(self.in_flight, policy=flow.BLOCK, name="serving.window")
        self._window = window
        try:
            if self.batching == "request":
                self._run_per_request(window)
            else:
                self._run_forming(window)
            while len(window):
                self._retire(window.get())
            self._out.close()
        except BaseException as e:  # worker death must not strand consumers
            self._out.close(error=e)
        finally:
            self._release(window)

    def _expire(self, seq: int, tenant: Optional[str]) -> None:
        metrics.inc_counter("serving.deadlineMiss")
        metrics.inc_counter("serving.deadlineMiss.expired")
        self._count("expired")
        self._emit(ServeResult(seq, "expired", tenant=tenant))

    def _park(self, window: flow.BoundedChannel, entry) -> None:
        if not window.offer(entry):
            # offer() just returned False, so get() cannot block
            self._retire(window.get())
            window.offer(entry)

    def _run_per_request(self, window: flow.BoundedChannel) -> None:
        """Every submitted batch dispatches alone."""
        for seq, tenant, batch, deadline, submitted in self._requests:
            hist.record("serving.queueWaitMs", (time.monotonic() - submitted) * 1000.0)
            self._quota_release(tenant)
            if deadline is not None and time.monotonic() > deadline:
                self._expire(seq, tenant)  # shed before paying staging and compute
                continue
            try:
                model = self._model_for(tenant)
                out, readback, n = self._dispatch(batch, seq, model=model, push=True)
            except Exception as e:  # a per-request failure: the stream survives
                if not _per_request(e):
                    raise
                self._count("errors")
                self._emit(ServeResult(seq, "error", error=e, tenant=tenant))
                continue
            self._park(window, (((seq, deadline, 0, n, tenant),), out, readback, n))

    # -- continuous batching: the forming buffer -----------------------------
    def _run_forming(self, window: flow.BoundedChannel) -> None:
        """Admit requests into per-tenant forming batches. A batch flushes
        on a full bucket (`form_rows`), its forming budget (continuous), an
        incompatible next request (the older batch first), or close."""
        forming: Dict[Optional[str], _Forming] = {}
        while True:
            timeout = None
            if forming:
                soonest = min(g.flush_at for g in forming.values())
                if soonest != float("inf"):
                    timeout = max(0.0, soonest - time.monotonic())
            if timeout is None and len(window):
                # nothing due but batches in flight: poll, and when the
                # queue is empty retire one now rather than at the next
                # arrival
                timeout = 0.0
            try:
                req = self._requests.get(timeout=timeout)
            except TimeoutError:
                self._flush_due(forming, window)
                if timeout == 0.0 and len(window):
                    self._retire(window.get())
                continue
            except flow.ChannelClosed:
                break
            self._admit_forming(req, forming, window)
            self._flush_due(forming, window)
        for tenant in list(forming):  # close(): partial batches still dispatch
            self._flush_group(forming.pop(tenant), window)

    def _form_flush_at(self, deadline: Optional[float]) -> float:
        """A request's forming deadline: when its deadline margin reaches
        the forming budget, and never later than the budget after its
        admission into forming; never under fixed batching."""
        if self.batching == "fixed":
            return float("inf")
        budget = self.form_budget_ms / 1000.0
        now = time.monotonic()
        flush_at = now + budget
        if deadline is not None and deadline - budget > now:
            flush_at = min(flush_at, deadline - budget)
        return flush_at

    @staticmethod
    def _batch_sig(batch: Table) -> Optional[tuple]:
        """Two batches may share a forming batch iff their column names,
        kinds, dtypes and trailing shapes match; None (host columns of
        another kind, or tensors): the request dispatches alone."""
        sig = []
        for name in batch.column_names:
            col = batch.column(name)
            if isinstance(col, SparseBatch):
                if not isinstance(col.indices, np.ndarray):
                    return None
                sig.append(("sparse", name, col.size, col.indices.shape[1:], str(col.values.dtype)))
            elif isinstance(col, np.ndarray) and col.dtype != object:
                sig.append(("np", name, col.shape[1:], str(col.dtype)))
            else:
                return None
        return tuple(sig)

    @staticmethod
    def _concat_batches(batches: List[Table]) -> Table:
        """The host concatenation of signature-compatible batches."""
        cols: Dict[str, Any] = {}
        for name in batches[0].column_names:
            vals = [b.column(name) for b in batches]
            first = vals[0]
            if isinstance(first, SparseBatch):
                cols[name] = SparseBatch(first.size,
                                         np.concatenate([v.indices for v in vals], axis=0),
                                         np.concatenate([v.values for v in vals], axis=0))
            else:
                cols[name] = np.concatenate(vals, axis=0)
        return Table(cols)

    def _admit_forming(self, req: tuple, forming: Dict[Optional[str], _Forming],
                       window: flow.BoundedChannel) -> None:
        seq, tenant, batch, deadline, submitted = req
        now = time.monotonic()
        hist.record("serving.queueWaitMs", (now - submitted) * 1000.0)
        if deadline is not None and now > deadline:
            self._quota_release(tenant)
            self._expire(seq, tenant)
            return
        sig = self._batch_sig(batch)
        group = forming.get(tenant)
        n = batch.num_rows
        if group is not None and (sig is None or group.sig != sig or group.rows + n > self.form_rows):
            # incompatible or over the target: the older batch first
            self._flush_group(forming.pop(tenant), window)
            group = None
        if sig is None:  # not coalescable: dispatch alone, now
            solo = _Forming(tenant, None)
            solo.add(seq, batch, deadline, flush_at=0.0)
            self._flush_group(solo, window)
            return
        if group is None:
            group = forming[tenant] = _Forming(tenant, sig)
        group.add(seq, batch, deadline, self._form_flush_at(deadline))
        if group.rows >= self.form_rows:  # bucket full: go now
            self._flush_group(forming.pop(tenant), window)

    def _flush_due(self, forming: Dict[Optional[str], _Forming], window: flow.BoundedChannel) -> None:
        now = time.monotonic()
        for tenant in [t for t, g in forming.items() if g.flush_at <= now]:
            self._flush_group(forming.pop(tenant), window)

    def _flush_group(self, group: _Forming, window: flow.BoundedChannel) -> None:
        """Dispatch one forming batch: its members concatenated, one fused
        dispatch, one window entry with each member's row span."""
        now = time.monotonic()
        live: List[Tuple[int, Table, Optional[float]]] = []
        for seq, batch, deadline, admitted in group.reqs:
            self._quota_release(group.tenant)
            if deadline is not None and now > deadline:  # expired while forming
                self._expire(seq, group.tenant)
                continue
            hist.record("serving.formWaitMs", (now - admitted) * 1000.0)
            live.append((seq, batch, deadline))
        if not live:
            return
        merged = live[0][1] if len(live) == 1 else self._concat_batches([b for _, b, _ in live])
        parts: List[Tuple[int, Optional[float], int, int, Optional[str]]] = []
        offset = 0
        for seq, batch, deadline in live:
            parts.append((seq, deadline, offset, offset + batch.num_rows, group.tenant))
            offset += batch.num_rows
        try:
            model = self._model_for(group.tenant)
            out, readback, n = self._dispatch(merged, live[0][0], model=model, push=True,
                                              coalesced=len(live) > 1)
        except Exception as e:  # the whole forming batch fails per request
            if not _per_request(e):
                raise
            for seq, _, _ in live:
                self._count("errors")
                self._emit(ServeResult(seq, "error", error=e, tenant=group.tenant))
            return
        if len(live) > 1:
            metrics.inc_counter("serving.coalesced", len(live))
        self._park(window, (tuple(parts), out, readback, n))

    @staticmethod
    def _slice_span(col, start: int, stop: int):
        if isinstance(col, SparseBatch):
            return SparseBatch(col.size, col.indices[start:stop], col.values[start:stop])
        return col[start:stop]

    def _retire(self, entry) -> None:
        """Retire one window entry: its readback, then each member request
        gets its row span, its deadline verdict and its result. A padded
        or coalesced batch is sliced on the host: its produced columns came
        back with the readback, and the others are the requests' own
        (slicing on the card would allocate a tensor a span)."""
        parts, out, readback, n = entry
        padded = out.num_rows
        try:
            table = self._finish(out, readback, padded)
        except Exception as e:  # a deferred guard error: per request, in order
            if not _per_request(e):
                raise
            for seq, _deadline, _start, _stop, tenant in parts:
                self._count("errors")
                self._emit(ServeResult(seq, "error", error=e, tenant=tenant))
            return
        sliced = len(parts) > 1 or n != padded
        if sliced:
            produced = set(readback.names)
            table = Table({name: slice_rows(table.column(name), n) if name in produced
                           else readback.source.column(name) for name in table.column_names})
        now = time.monotonic()
        for seq, deadline, start, stop, tenant in parts:
            sub = table if not sliced else Table(
                {name: self._slice_span(table.column(name), start, stop)
                 for name in table.column_names})
            status = "ok"
            if deadline is not None:
                margin_ms = (deadline - now) * 1000.0
                if margin_ms < 0:  # finished late: the compute was paid
                    metrics.inc_counter("serving.deadlineMiss")
                    metrics.inc_counter("serving.deadlineMiss.late")
                    hist.record("serving.lateByMs", -margin_ms)
                    self._count("late")
                    status = "late"
                else:
                    hist.record("serving.deadlineMarginMs", margin_ms)
            self._emit(ServeResult(seq, status, table=sub, tenant=tenant))

    def _emit(self, result: ServeResult) -> None:
        self._count("completed")
        try:
            self._out.put(result)
        except flow.ChannelClosed:  # the consumer cancelled results()
            pass


def serve_stream(model: PipelineModel, stream: Iterable[Table], in_flight: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None) -> List[Table]:
    """Serve the whole stream and collect the outputs."""
    return list(MicroBatchServer(model, in_flight=in_flight, buckets=buckets).serve(stream))
