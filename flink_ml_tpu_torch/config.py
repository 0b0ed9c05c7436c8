"""Device selection and the knobs of the port.

The port runs on the CUDA card unless the caller asks for the CPU. With no
card and no explicit request it raises: nothing falls back to the CPU
quietly. Host (numpy) columns are staged to `device()`; torch tensor
columns stay on the device they already live on.

The stream, online, fleet, fusion, flow-control, serving, model-store,
lifecycle, checkpoint, snapshot and supervisor knobs keep the JAX
package's names, defaults and environment variables
(flink_ml_tpu/config.py), as do the program funnel's (`whole_fit`,
`kernel_cache_size`) and the program bank's (`program_bank_dir`), and the
1D collective knobs of the data axis (`collective_chunk_bytes` with
`resolve_chunk_bytes`, `collective_sparse_threshold`, `collective_ring`,
`collective_overlap` with `collective_overlap_mode`, and the scoped
`collective_sparse_threshold_mode`; parallel/
collectives.py, parallel/overlap.py), and the 2D ones: `sparse_2d` with
`sparse_2d_mode` and `FLINK_ML_TPU_SPARSE_2D` (a feature-sharded sparse fit
on a mesh with a `model` axis takes the 2D programs, or "off" the
replicated reference), and `fleet_shard_threshold`, the scoped override of
`fleet_shard_state_bytes` (fleet.py's regime). The stream fit's staging
knobs `device_cache_bytes` and `input_prefetch_depth` read
`FLINK_ML_TPU_DEVICE_CACHE_BYTES` and `FLINK_ML_TPU_INPUT_PREFETCH_DEPTH`
as the JAX package reads them.

Two of the JAX package's environment variables are not read, as what they
choose does not exist here: `FLINK_ML_TPU_USE_PALLAS_SPARSE` picks Pallas
over XLA for the sparse products, and the port runs its CUDA kernels on
the card always; `FLINK_ML_TPU_COMPILATION_CACHE_DIR` turns on XLA's
persistent compilation cache, and the port compiles no XLA programs (its
program bank, `program_bank_dir`, stands alone: compilebank.py).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch

_override: Optional[torch.device] = None

#: host memory the spillable data cache of a stream fit may hold before
#: it spills segments to a file (native/datacache.py)
datacache_memory_budget_bytes: int = 64 << 20
#: where that file goes; None is the temporary directory
datacache_spill_dir: Optional[str] = None
#: device memory the epoch cache of a stream fit may hold (data/
#: devicecache.py); None is unbounded, 0 re-stages every batch
device_cache_bytes: Optional[int] = None
#: batches the staging worker runs ahead of the training loop
#: (parallel/prefetch.py)
input_prefetch_depth: int = 2
#: what the online estimators' ingest does when the stream outruns the
#: training step (flow.py): "block" is lossless backpressure, every batch
#: folded; "shed_oldest" bounds memory and model staleness (consumed lag <
#: the window); "sample" bounds memory only (the window keeps a prefix)
online_overload_policy: str = "block"
#: where the iterative fits (SGD, stream SGD, out-of-core KMeans, the
#: online estimators, the fleet) snapshot their state at epoch boundaries
#: and resume from; None is no checkpointing (ckpt/snapshot.py)
iteration_checkpoint_dir: Optional[str] = None
#: epochs (global batches for the online estimators) between two snapshots
iteration_checkpoint_interval: int = 1

# -- sharded snapshots (ckpt/coordinator.py) --------------------------------
#: simulated hosts of the sharded snapshot: each writes only its own slices
#: of every leaf and a manifest commits the cut; None is the single file
snapshot_hosts: Optional[int] = None
#: committed cuts kept per job key (>= 1; >= 2 keeps a fallback)
snapshot_retained: int = 2
#: seconds one host's shard write may take, retries included, before the
#: cut is aborted (the previous cut stays restorable); None is no deadline
snapshot_host_deadline_s: Optional[float] = None
#: a sharded stream-SGD snapshot also carries the stream cache's contents,
#: written once per job key, so a resume does not read the stream again
snapshot_cache_contents: bool = True

# -- the supervisor (parallel/supervisor.py) --------------------------------
#: no dispatch/drain/commit progress for hang_factor x the trailing chunk
#: wall is a CollectiveHang
hang_factor: float = 8.0
#: the floor under that deadline, seconds
hang_min_deadline_s: float = 1.0
#: a simulated host whose heartbeat is older than this is a HostFailure
host_heartbeat_timeout_s: float = 1.0
#: the supervisor's poll cadence, seconds
supervisor_poll_interval_s: float = 0.02
#: recoveries the supervisor may spend on one fit
recovery_budget: int = 2

#: a fleet whose member state (coeff and grad, N x d x 8 bytes; KMeans
#: N x k x d x 8) exceeds this shards its member axis over the data shards
#: when they divide the fleet (fleet.py); None never decides so by itself
fleet_shard_state_bytes: Optional[int] = 256 << 20


def fleet_shard_threshold(nbytes: Optional[int]):
    """Scoped override of `fleet_shard_state_bytes` (None = never auto)."""
    return _scoped("fleet_shard_state_bytes", nbytes)

#: "auto": PipelineModel.transform runs maximal runs of fusable stages as
#: one fused segment when their input columns are tensors (on the card,
#: one captured CUDA graph a segment); "off": always the eager per-stage
#: path, the reference of the fused-vs-eager parity tests (pipeline.py)
pipeline_fusion: str = "auto"
#: captured CUDA graphs a program funnel (a fused segment, a whole fit:
#: utils/lazyjit.py) keeps, one per input signature, and keyed_jit's
#: wrappers, least recently used first out
kernel_cache_size: int = 256
#: "auto": the whole fits run through the program funnel (one captured CUDA
#: graph per signature on the card, replayed by later fits of the same
#: shapes); "off": every fit launches op by op (utils/lazyjit.py)
whole_fit: str = "auto"
#: where the program bank keeps the signatures a process captured, so the
#: next process captures them ahead of its first calls (compilebank.py);
#: None is off
program_bank_dir: Optional[str] = None

#: device memory the ledgered uploads may hold (obs/memledger.py): an
#: upload past it raises HbmBudgetExceeded before it allocates; None is off
hbm_budget_bytes: Optional[int] = None

# -- flow control (flow.py) -----------------------------------------------
#: retries of a transiently failing call (serving batch dispatch): extra
#: attempts after the first, 0 fails fast; only flow.TRANSIENT_ERRORS retry
transient_retries: int = 2
#: attempt k sleeps min(retry_max_delay_s, retry_base_delay_s * 2**(k-1)),
#: with full jitter
retry_base_delay_s: float = 0.005
retry_max_delay_s: float = 0.25
#: a stage execution above this multiple of its trailing mean is flagged
#: (flow.StragglerWatchdog, `flow.straggler.*`)
straggler_factor: float = 4.0
#: consecutive flags after which the watchdog raises PersistentStraggler;
#: 0 is off (counters only)
straggler_escalate: int = 0

# -- serving (serving.py), the model store and the lifecycle ----------------
#: transformed-but-undrained batches a MicroBatchServer keeps in flight
serving_in_flight: int = 2
#: requests the push API's admission queue holds before submit() raises
#: ServerOverloaded
serving_admission: int = 16
#: default per-request deadline (None: none)
serving_deadline_ms: Optional[float] = None
#: the longest a request waits in a forming batch (continuous batching)
serving_form_budget_ms: float = 5.0
#: device bytes a ModelStore keeps resident (LRU paging); None is unbounded
model_store_bytes: Optional[int] = None
#: promoted versions a ModelLifecycle retains for rollback (>= 2)
model_versions_retained: int = 4
#: the promotion gate's canary tolerance against the outgoing version
lifecycle_canary_rtol: float = 0.5
#: serve outcomes in the health window, and the guard-error rate over a full
#: window that rolls traffic back
lifecycle_health_window: int = 16
lifecycle_error_rate_trigger: float = 0.5

OVERLOAD_POLICIES = ("block", "shed_oldest", "sample")


@contextmanager
def pipeline_fusion_mode(mode: str):
    """Scoped override of `pipeline_fusion` ("auto" | "off")."""
    global pipeline_fusion
    if mode not in ("auto", "off"):
        raise ValueError(f"Unknown pipeline_fusion mode {mode!r}")
    prev = pipeline_fusion
    pipeline_fusion = mode
    try:
        yield
    finally:
        pipeline_fusion = prev


@contextmanager
def whole_fit_mode(mode: str):
    """Scoped override of `whole_fit` ("auto" | "off")."""
    global whole_fit
    if mode not in ("auto", "off"):
        raise ValueError(f"Unknown whole_fit mode {mode!r}")
    prev = whole_fit
    whole_fit = mode
    try:
        yield
    finally:
        whole_fit = prev


@contextmanager
def program_bank_mode(path: Optional[str]):
    """Scoped override of `program_bank_dir` (None = bank off). The active
    ProgramBank is reset on entry and exit, so the scope sees a bank
    freshly loaded from `path`."""
    global program_bank_dir
    prev = program_bank_dir
    program_bank_dir = path
    from . import compilebank

    compilebank.reset_active_bank()
    try:
        yield
    finally:
        program_bank_dir = prev
        compilebank.reset_active_bank()


@contextmanager
def kernel_cache_limit(size: int):
    """Scoped override of `kernel_cache_size` (>= 1)."""
    global kernel_cache_size
    prev = kernel_cache_size
    kernel_cache_size = max(1, int(size))
    try:
        yield
    finally:
        kernel_cache_size = prev


@contextmanager
def _scoped(name: str, value):
    """Set the module knob `name` to `value` for the block."""
    module = globals()
    prev = module[name]
    module[name] = value
    try:
        yield
    finally:
        module[name] = prev


def device_cache_budget(budget_bytes: Optional[int]):
    """Scoped override of `device_cache_bytes` (None = unbounded, 0 = off)."""
    return _scoped("device_cache_bytes", budget_bytes)


def hbm_budget_mode(budget_bytes: Optional[int]):
    """Scoped override of `hbm_budget_bytes` (None: admission off)."""
    return _scoped("hbm_budget_bytes", None if budget_bytes is None else max(0, int(budget_bytes)))


def transient_retry_mode(retries: int):
    """Scoped override of `transient_retries` (0 disables retries)."""
    return _scoped("transient_retries", max(0, int(retries)))


def straggler_escalation_mode(consecutive: int):
    """Scoped override of `straggler_escalate` (0 disables escalation)."""
    return _scoped("straggler_escalate", max(0, int(consecutive)))


def online_overload_mode(policy: str):
    """Scoped override of `online_overload_policy`."""
    if policy not in ("block", "shed_oldest", "sample", "reject"):
        raise ValueError(f"Unknown overload policy {policy!r}")
    return _scoped("online_overload_policy", policy)


def serving_form_budget(budget_ms: float):
    """Scoped override of `serving_form_budget_ms`."""
    return _scoped("serving_form_budget_ms", max(0.0, float(budget_ms)))


def model_store_budget(budget_bytes: Optional[int]):
    """Scoped override of `model_store_bytes` (None: unbounded)."""
    return _scoped("model_store_bytes", None if budget_bytes is None else max(0, int(budget_bytes)))


def model_retention_mode(retained: int):
    """Scoped override of `model_versions_retained`."""
    return _scoped("model_versions_retained", max(2, int(retained)))


def set_iteration_checkpoint_dir(path: Optional[str], interval: int = 1) -> None:
    global iteration_checkpoint_dir, iteration_checkpoint_interval
    iteration_checkpoint_dir = path
    iteration_checkpoint_interval = interval


@contextmanager
def iteration_checkpointing(path: str, interval: int = 1):
    """Scoped checkpoint and resume of the iterative fits."""
    global iteration_checkpoint_dir, iteration_checkpoint_interval
    prev = (iteration_checkpoint_dir, iteration_checkpoint_interval)
    iteration_checkpoint_dir, iteration_checkpoint_interval = path, interval
    try:
        yield
    finally:
        iteration_checkpoint_dir, iteration_checkpoint_interval = prev


def snapshot_hosts_mode(hosts: Optional[int]):
    """Scoped override of `snapshot_hosts` (None: the single-file path)."""
    if hosts is not None and int(hosts) < 1:
        raise ValueError(f"snapshot_hosts must be >= 1, got {hosts!r}")
    return _scoped("snapshot_hosts", None if hosts is None else int(hosts))


def snapshot_retention_mode(retained: int):
    """Scoped override of `snapshot_retained` (>= 1)."""
    return _scoped("snapshot_retained", max(1, int(retained)))


def recovery_budget_mode(budget: int):
    """Scoped override of `recovery_budget` (0: detect, never resume)."""
    return _scoped("recovery_budget", max(0, int(budget)))


# -- collectives over a mesh of ranks (parallel/collectives.py, overlap.py) ---
#: bucket size of `all_reduce_sum_chunked`: a gradient is cut into buckets of
#: about this many bytes, each reduced on its own; None or <= 0 is one bucket
collective_chunk_bytes: Optional[int] = 4 << 20
#: the sparse gradient rides the index-value pair exchange when its pair
#: bytes are at most this fraction of the dense payload (dim * itemsize)
collective_sparse_threshold: float = 0.5
#: reduce each bucket by the ring exchange (folded in replica order) rather
#: than reduce-scatter + all-gather
collective_ring: bool = False
#: the SGD and Lloyd loops on a mesh carry the unreduced gradient and reduce
#: it at the top of the next epoch, issued asynchronously (carry-delayed apply)
collective_overlap: bool = False


#: "auto": a feature-sharded sparse fit (`SGD(shard_features=True)`, or a
#: sparse estimator fit on a default mesh with a `model` axis) runs the 2D
#: programs of parallel/overlap.py (coefficient and optimizer carry as
#: model-axis slices, gradients reduced over `data` only); "off": the
#: replicated-coefficient reference fit on the same mesh
sparse_2d: str = "auto"


def sparse_2d_mode(mode: str):
    """Scoped override of `sparse_2d` ("auto" | "off")."""
    if mode not in ("auto", "off"):
        raise ValueError(f"sparse_2d must be 'auto' or 'off', got {mode!r}")
    return _scoped("sparse_2d", mode)


def collective_overlap_mode(enabled: bool = True):
    """Scoped override of `collective_overlap`."""
    return _scoped("collective_overlap", bool(enabled))


def collective_sparse_threshold_mode(threshold: float):
    """Scoped override of `collective_sparse_threshold`."""
    return _scoped("collective_sparse_threshold", float(threshold))


def resolve_chunk_bytes(chunk_bytes: Optional[int] = None) -> Optional[int]:
    """The effective bucket size: an explicit argument, else
    `collective_chunk_bytes`. None or <= 0 is unchunked (one bucket)."""
    v = chunk_bytes if chunk_bytes is not None else collective_chunk_bytes
    if v is None or v <= 0:
        return None
    return int(v)


_env = os.environ.get
if _env("FLINK_ML_TPU_COLLECTIVE_OVERLAP") in ("1", "true", "on"):
    collective_overlap = True
if _env("FLINK_ML_TPU_SPARSE_2D") in ("auto", "off"):
    sparse_2d = _env("FLINK_ML_TPU_SPARSE_2D")
if _env("FLINK_ML_TPU_COLLECTIVE_CHUNK_BYTES"):
    collective_chunk_bytes = int(_env("FLINK_ML_TPU_COLLECTIVE_CHUNK_BYTES"))
if _env("FLINK_ML_TPU_DEVICE_CACHE_BYTES"):
    device_cache_bytes = int(_env("FLINK_ML_TPU_DEVICE_CACHE_BYTES"))
if _env("FLINK_ML_TPU_INPUT_PREFETCH_DEPTH"):
    input_prefetch_depth = int(_env("FLINK_ML_TPU_INPUT_PREFETCH_DEPTH"))
if _env("FLINK_ML_TPU_HBM_BUDGET_BYTES"):
    hbm_budget_bytes = max(0, int(_env("FLINK_ML_TPU_HBM_BUDGET_BYTES")))
if _env("FLINK_ML_TPU_TRANSIENT_RETRIES"):
    transient_retries = max(0, int(_env("FLINK_ML_TPU_TRANSIENT_RETRIES")))
if _env("FLINK_ML_TPU_ONLINE_OVERLOAD_POLICY") in OVERLOAD_POLICIES:
    online_overload_policy = _env("FLINK_ML_TPU_ONLINE_OVERLOAD_POLICY")
if _env("FLINK_ML_TPU_SERVING_FORM_BUDGET_MS"):
    serving_form_budget_ms = max(0.0, float(_env("FLINK_ML_TPU_SERVING_FORM_BUDGET_MS")))
if _env("FLINK_ML_TPU_MODEL_STORE_BYTES"):
    model_store_bytes = max(0, int(_env("FLINK_ML_TPU_MODEL_STORE_BYTES")))
if _env("FLINK_ML_TPU_MODEL_VERSIONS_RETAINED"):
    model_versions_retained = max(2, int(_env("FLINK_ML_TPU_MODEL_VERSIONS_RETAINED")))
if _env("FLINK_ML_TPU_LIFECYCLE_CANARY_RTOL"):
    lifecycle_canary_rtol = float(_env("FLINK_ML_TPU_LIFECYCLE_CANARY_RTOL"))
if _env("FLINK_ML_TPU_SNAPSHOT_HOSTS"):
    snapshot_hosts = max(1, int(_env("FLINK_ML_TPU_SNAPSHOT_HOSTS")))
if _env("FLINK_ML_TPU_SNAPSHOT_RETAINED"):
    snapshot_retained = max(1, int(_env("FLINK_ML_TPU_SNAPSHOT_RETAINED")))
if _env("FLINK_ML_TPU_SNAPSHOT_HOST_DEADLINE_S"):
    snapshot_host_deadline_s = float(_env("FLINK_ML_TPU_SNAPSHOT_HOST_DEADLINE_S"))
if _env("FLINK_ML_TPU_RECOVERY_BUDGET"):
    recovery_budget = max(0, int(_env("FLINK_ML_TPU_RECOVERY_BUDGET")))
if _env("FLINK_ML_TPU_HOST_HEARTBEAT_TIMEOUT_S"):
    host_heartbeat_timeout_s = float(_env("FLINK_ML_TPU_HOST_HEARTBEAT_TIMEOUT_S"))
if _env("FLINK_ML_TPU_HANG_FACTOR"):
    hang_factor = float(_env("FLINK_ML_TPU_HANG_FACTOR"))
if os.environ.get("FLINK_ML_TPU_PIPELINE_FUSION") in ("auto", "off"):
    pipeline_fusion = os.environ["FLINK_ML_TPU_PIPELINE_FUSION"]
if os.environ.get("FLINK_ML_TPU_KERNEL_CACHE_SIZE"):
    kernel_cache_size = max(1, int(os.environ["FLINK_ML_TPU_KERNEL_CACHE_SIZE"]))
if os.environ.get("FLINK_ML_TPU_WHOLE_FIT") in ("auto", "off"):
    whole_fit = os.environ["FLINK_ML_TPU_WHOLE_FIT"]
if os.environ.get("FLINK_ML_TPU_PROGRAM_BANK_DIR"):
    program_bank_dir = os.environ["FLINK_ML_TPU_PROGRAM_BANK_DIR"]


def check_overload_policy(policy: str) -> None:
    """Accept an ingest overload policy: "block", "shed_oldest" or "sample"."""
    if policy not in OVERLOAD_POLICIES:
        raise ValueError(f"unknown overload policy {policy!r}; one of {OVERLOAD_POLICIES}")


def device() -> torch.device:
    """The device host inputs are staged to: the scoped `use_device`
    choice, else the current CUDA device. Raises when neither exists."""
    if _override is not None:
        return _override
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flink_ml_tpu_torch needs a CUDA device; none is available. "
            "Run under config.use_device('cpu') to compute on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


@contextmanager
def use_device(dev: Union[str, torch.device]) -> Iterator[torch.device]:
    """Scoped device choice, e.g. `with use_device("cpu"): ...`."""
    global _override
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("use_device('cuda') but no CUDA device is available")
    prev = _override
    _override = dev
    try:
        yield dev
    finally:
        _override = prev
