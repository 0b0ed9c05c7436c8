"""Device selection and the knobs of the port.

The port runs on the CUDA card unless the caller asks for the CPU. With no
card and no explicit request it raises: nothing falls back to the CPU
quietly. Host (numpy) columns are staged to `device()`; torch tensor
columns stay on the device they already live on.

The stream, online, fleet and fusion knobs keep the JAX package's names,
defaults and environment variables (flink_ml_tpu/config.py). Its other
TPU knobs (whole-fit, collectives, serving, compile bank) have no
counterpart here yet.
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
#: training step: "block" (lossless backpressure) is the only policy ported
online_overload_policy: str = "block"
#: checkpointed iteration is not ported (ROADMAP A.13); set, it raises
iteration_checkpoint_dir: Optional[str] = None

#: a fleet whose member state (coeff and grad, N x d x 8 bytes; KMeans
#: N x k x d x 8) exceeds this would shard its member axis over the data
#: shards; None never decides so by itself. One device is one data shard,
#: so a fleet here is always replicated (fleet.py)
fleet_shard_state_bytes: Optional[int] = 256 << 20

#: "auto": PipelineModel.transform runs maximal runs of fusable stages as
#: one fused segment when their input columns are tensors (on the card,
#: one captured CUDA graph a segment); "off": always the eager per-stage
#: path, the reference of the fused-vs-eager parity tests (pipeline.py)
pipeline_fusion: str = "auto"
#: captured CUDA graphs a fused segment keeps, one per input signature,
#: least recently used first out
kernel_cache_size: int = 256

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
def kernel_cache_limit(size: int):
    """Scoped override of `kernel_cache_size` (>= 1)."""
    global kernel_cache_size
    prev = kernel_cache_size
    kernel_cache_size = max(1, int(size))
    try:
        yield
    finally:
        kernel_cache_size = prev


if os.environ.get("FLINK_ML_TPU_PIPELINE_FUSION") in ("auto", "off"):
    pipeline_fusion = os.environ["FLINK_ML_TPU_PIPELINE_FUSION"]
if os.environ.get("FLINK_ML_TPU_KERNEL_CACHE_SIZE"):
    kernel_cache_size = max(1, int(os.environ["FLINK_ML_TPU_KERNEL_CACHE_SIZE"]))


def check_overload_policy(policy: str) -> None:
    """Accept "block"; the JAX package's lossy policies need its flow
    control layer, which lands with serving."""
    if policy not in OVERLOAD_POLICIES:
        raise ValueError(f"unknown overload policy {policy!r}; one of {OVERLOAD_POLICIES}")
    if policy != "block":
        raise NotImplementedError(
            f"overload policy {policy!r} is not ported yet (ROADMAP A.12, with flow.py)"
        )


def check_no_checkpoint(checkpoint_dir: Optional[str] = None) -> None:
    """Raise for a checkpoint directory, given or from the config."""
    if checkpoint_dir is not None or iteration_checkpoint_dir is not None:
        raise NotImplementedError("checkpointed training is not ported yet (ROADMAP A.13)")


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
