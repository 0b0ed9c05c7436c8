"""Kernels of the sparse padded-CSR path: hand-written CUDA on the card,
plain PyTorch on the CPU.

Port of flink_ml_tpu/ops/sparsekernels.py, whose two Pallas kernels carry
the sparse SGD forward pass, its gradient and sparse inference:

- `sparse_row_dots(indices, values, coeff)` -> (B,): the masked per-row
  gather-dot, `out[i] = sum_j [idx >= 0] * vals[i,j] * coeff[min(idx, d-1)]`;
- `sparse_grad(indices, values, multiplier, coeff)` -> (d,): the gradient
  segment sum of `vals[i,j] * multiplier[i]` at column `idx[i,j]`, with
  padding and indices >= d dropped. `coeff` gives the output's width and
  dtype only.

The tensor's device decides the route, there is no switch: a CUDA tensor
goes to the kernel in `csrc/sparse_kernels.cu` (built at first use by
`cuda_build`), a CPU tensor to the plain version beside it. The plain
versions are public (`sparse_row_dots_plain`, `sparse_grad_plain`) so tests
and `chip_smoke.py` can hold a kernel against them on the same inputs.
Each wrapper counts its kernel launches in a plain integer attribute,
`sparse_row_dots.launches` and `sparse_grad.launches`.

Index convention (the JAX package's, pinned by the tests): PyTorch
indexing wraps -1 to the last element, so every gather and scatter masks
first. Padding contributes 0; an index >= d is clamped in the dot and
dropped in the gradient, so such a weight is read but never updated.

The gradient kernel adds with atomics, so its order of additions changes
from run to run: it agrees with the plain version to a tolerance, not
bit for bit.

How a batch is cut into blocks is decided here, by `_launch_plan`, a pure
function of the batch's shape, and passed to the kernels: the CPU tests
check it without a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from . import cuda_build

_SOURCE = "sparse_kernels"

#: the row dot: warps a block, one row each
ROW_WARPS = 8
#: the gradient: threads a block, one slot each
GRAD_THREADS = 256


class LaunchPlan(NamedTuple):
    """How one launch cuts a (rows, nnz) batch into blocks: block b takes
    the rows [b * threads / 32, (b + 1) * threads / 32) in the row dot (a
    warp a row), the slots [b * threads, (b + 1) * threads) of the
    row-major batch in the gradient (a thread a slot)."""

    threads: int  # a block
    grid: int  # blocks


@functools.lru_cache(maxsize=256)
def _launch_plan(rows: int, nnz: int, grad: bool = False) -> LaunchPlan:
    """The launch of the row dot (or, with `grad`, the gradient) for a
    (rows, nnz) batch: a warp per row, ROW_WARPS rows a block; or a thread
    per slot, GRAD_THREADS slots a block. The grid covers the batch.
    Cached, so the epochs of a fit, whose batches share a shape, compute it
    once."""
    if grad:
        return LaunchPlan(GRAD_THREADS, -(-rows * nnz // GRAD_THREADS))
    return LaunchPlan(32 * ROW_WARPS, -(-rows // ROW_WARPS))


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load(_SOURCE)
    for fn in (lib.fmt_sparse_row_dots, lib.fmt_sparse_grad):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernels now rather than at the first launch."""
    _kernels()


def _launch(name, entry, indices, values, vector, out, d):
    """Launch the C entry point `entry` on the batch with its plan, on the
    current stream of the batch's device; raise if the launch failed."""
    rows, nnz = indices.shape
    plan = _launch_plan(rows, nnz, entry == "fmt_sparse_grad")
    device = indices.device
    with torch.cuda.device(device):
        err = getattr(_kernels(), entry)(
            indices.data_ptr(), values.data_ptr(), vector.data_ptr(), out.data_ptr(),
            rows, nnz, d, plan.threads, plan.grid,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _check_batch(name, indices, values, vector, vector_len, coeff):
    if indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {indices.dtype}")
    for label, t in (("values", values), ("vector", vector), ("coeff", coeff)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
    if indices.ndim != 2 or tuple(values.shape) != tuple(indices.shape):
        raise ValueError(
            f"{name}: indices and values must be matching (B, nnz), got "
            f"{tuple(indices.shape)} and {tuple(values.shape)}"
        )
    if vector.ndim != 1 or vector.shape[0] != vector_len:
        raise ValueError(f"{name}: expected a ({vector_len},) vector, got {tuple(vector.shape)}")
    if coeff.ndim != 1 or coeff.shape[0] < 1:
        raise ValueError(f"{name}: coeff must be a non-empty (d,) vector")
    devices = {t.device for t in (indices, values, vector, coeff)}
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must be on one device, got {devices}")
    for t in (indices, values, vector):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def sparse_row_dots_plain(indices, values, coeff):
    """The plain PyTorch row dot: mask padding, clamp indices >= d."""
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).clamp(max=coeff.shape[0] - 1).long()
    vals = torch.where(valid, values, 0.0).to(coeff.dtype)
    return torch.sum(vals * coeff[safe], dim=1)


def sparse_grad_plain(indices, values, multiplier, coeff):
    """The plain PyTorch gradient segment sum: padding and indices >= d
    contribute 0 (masked to column 0 with a zero value)."""
    keep = (indices >= 0) & (indices < coeff.shape[0])
    safe = torch.where(keep, indices, 0).long().reshape(-1)
    contrib = torch.where(keep, values.to(coeff.dtype) * multiplier[:, None], 0.0)
    return torch.zeros_like(coeff).index_add_(0, safe, contrib.reshape(-1))


def sparse_row_dots(indices, values, coeff):
    """Masked per-row dot of padded-CSR rows with `coeff` -> (B,) float32.
    CUDA tensors run the hand-written kernel; CPU tensors the plain version."""
    rows = indices.shape[0] if indices.ndim == 2 else -1
    coeff_len = coeff.shape[0] if coeff.ndim == 1 else -1
    device = _check_batch("sparse_row_dots", indices, values, coeff, coeff_len, coeff)
    if device.type == "cpu":
        return sparse_row_dots_plain(indices, values, coeff)
    out = torch.empty((rows,), dtype=torch.float32, device=device)
    if indices.numel() == 0:
        return out.zero_()
    _launch("sparse_row_dots", "fmt_sparse_row_dots", indices, values, coeff, out,
            coeff.shape[0])
    sparse_row_dots.launches += 1
    return out


def sparse_grad(indices, values, multiplier, coeff):
    """Gradient segment sum of padded-CSR rows scaled by `multiplier` ->
    (d,) float32. CUDA tensors run the hand-written kernel; CPU tensors
    the plain version."""
    rows = indices.shape[0] if indices.ndim == 2 else -1
    device = _check_batch("sparse_grad", indices, values, multiplier, rows, coeff)
    if device.type == "cpu":
        return sparse_grad_plain(indices, values, multiplier, coeff)
    grad = torch.zeros(coeff.shape, dtype=torch.float32, device=device)
    if indices.numel() == 0:
        return grad
    _launch("sparse_grad", "fmt_sparse_grad", indices, values, multiplier, grad, coeff.shape[0])
    sparse_grad.launches += 1
    return grad


sparse_row_dots.launches = 0
sparse_grad.launches = 0
KERNELS = (sparse_row_dots, sparse_grad)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
