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

A fleet fit (fleet.py) trains N models on one shared batch; the JAX
package reaches the two Pallas kernels there through `jax.vmap`, which
batches `coeff` and `multiplier` over a leading member axis and leaves the
batch unbatched. Their member-batched forms here take that axis
explicitly and read each (idx, val) slot once for all N members:

- `fleet_row_dots(indices, values, coeff[N, d])` -> (N, B), row m the row
  dot of member m;
- `fleet_grad(indices, values, multiplier[N, B], coeff[N, d])` -> (N, d),
  row m the gradient of member m.

Per member each computes what the solo form computes, with the same
masking, clamp and drop. `coeff` may be laid out member-major (a
contiguous (N, d)) or member-minor (the transpose of a contiguous (d, N)),
where one slot's N coefficients are neighbours; `fleet_grad` returns its
gradient in the layout of `coeff`.

The tensor's device decides the route, there is no switch: a CUDA tensor
goes to the kernel in `csrc/sparse_kernels.cu` (built at first use by
`cuda_build`), a CPU tensor to the plain version beside it. The plain
versions are public (`sparse_row_dots_plain`, `sparse_grad_plain`) so tests
and `chip_smoke.py` can hold a kernel against them on the same inputs.
Each wrapper counts its kernel launches in a plain integer attribute,
`sparse_row_dots.launches`, `sparse_grad.launches`,
`fleet_row_dots.launches` and `fleet_grad.launches`.

Index convention (the JAX package's, pinned by the tests): PyTorch
indexing wraps -1 to the last element, so every gather and scatter masks
first. Padding contributes 0; an index >= d is clamped in the dot and
dropped in the gradient, so such a weight is read but never updated.

The gradient kernels add with atomics (the solo one through a table of
columns in shared memory, flushed with atomics), so their order of
additions changes from run to run: they agree with the plain version to a
tolerance, not bit for bit.

How a batch is cut into blocks is decided here and passed to the kernels:
`_launch_plan` (the row dots and `fleet_grad`, a pure function of the
batch's shape), `_grad_plan` (`sparse_grad`'s persistent grid, chunks,
table and shared memory, a pure function of the shape and the card's SM
count) and `_float4_members` (whether `fleet_row_dots` loads a slot's
members as float4s). The CPU tests check them without a card.
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
#: fleet_grad (and the first gradient, csrc/designs.cu): threads a block, one slot each
GRAD_THREADS = 256

# sparse_grad's plan (csrc/sparse_kernels.cu): a persistent grid of
# TABLE_BLOCKS_PER_SM blocks of TABLE_THREADS on each SM, each walking
# chunks of at most TABLE_MAX_CHUNK slots (at least TABLE_MIN_CHUNK, so a
# small batch takes fewer blocks) through the kernel's shared-memory ring,
# into a table of 4 * chunk entries (TABLE_MIN to TABLE_MAX), which it
# flushes once a quarter of it is claimed: with a chunk's new columns on
# top the table stays at most half full.
TABLE_THREADS = 512
TABLE_BLOCKS_PER_SM = 2
TABLE_MAX_CHUNK = 2048
TABLE_MIN_CHUNK = 256
TABLE_MIN, TABLE_MAX = 1024, 8192
#: what `sparse_grad_walk` counts (csrc/sparse_kernels.cu `WalkStat`)
WALK_STATS = ("mid_walk_flushes", "overflows", "direct_chunks")


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


class GradPlan(NamedTuple):
    """sparse_grad's launch (the order of the C entry's arguments): `grid`
    blocks of `threads`; block b walks the chunks b, b + grid, ... of
    `chunk` slots of the row-major batch through the kernel's ring,
    adding into a table of `table` entries that it flushes once `flush_at`
    are claimed; `row_cap` multipliers a ring stage (the most rows a chunk
    can span). The kernel's entry lays out its shared memory from these
    and refuses a plan that passes a block's 227 KB."""

    threads: int
    grid: int
    chunk: int
    table: int
    flush_at: int
    row_cap: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=256)
def _grad_plan(rows: int, nnz: int, sms: int) -> GradPlan:
    """sparse_grad's launch for a (rows, nnz) batch on a card of `sms`
    SMs: TABLE_BLOCKS_PER_SM blocks an SM (fewer if the batch has fewer
    chunks of TABLE_MIN_CHUNK slots), each walking the same number of
    chunks, give or take one."""
    slots = max(rows * nnz, 1)
    blocks = max(1, min(sms * TABLE_BLOCKS_PER_SM, -(-slots // TABLE_MIN_CHUNK)))
    per_block = -(-slots // blocks)
    walks = -(-per_block // TABLE_MAX_CHUNK)
    chunk = _round_up(-(-per_block // walks), 32)
    table = min(TABLE_MAX, max(TABLE_MIN, 1 << (4 * chunk - 1).bit_length()))
    row_cap = (nnz + chunk - 2) // max(nnz, 1) + 1
    grid = min(blocks, -(-slots // chunk))
    return GradPlan(TABLE_THREADS, grid, chunk, table, table // 4, row_cap)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _float4_members(members: int, member_stride: int, column_stride: int, data_ptr: int) -> bool:
    """Whether fleet_row_dots loads a slot's members as float4s: coeff
    member-minor (member stride 1, column stride N), N a multiple of 4 and
    its base 16-byte aligned, so every column's tile of 4 or 8 members is
    whole aligned float4s."""
    return (member_stride == 1 and column_stride == members and members % 4 == 0
            and data_ptr % 16 == 0)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load(_SOURCE)
    batch = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    fleet = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    entries = [
        (lib.fmt_sparse_row_dots, batch + [ctypes.c_int] * 2),
        (lib.fmt_sparse_grad, batch + [ctypes.c_void_p] + [ctypes.c_int] * len(GradPlan._fields)),
        (lib.fmt_fleet_row_dots, batch + fleet + [ctypes.c_int] * 3),  # vec4, threads, grid
        (lib.fmt_fleet_grad, batch + fleet + [ctypes.c_int] * 2),
    ]
    for fn, args in entries:
        fn.argtypes = args + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernels now rather than at the first launch."""
    _kernels()


def _launch(name, entry, indices, values, vector, out, d, extra=(), plan=None):
    """Launch the C entry point `entry` on the batch with `plan` (by
    default `_launch_plan`'s), on the current stream of the batch's device;
    raise if the launch failed. `extra` are the entry's arguments between
    the batch's and the plan's (the fleet kernels' members and strides, the
    gradient's counters)."""
    rows, nnz = indices.shape
    plan = plan or _launch_plan(rows, nnz, entry.endswith("_grad"))
    device = indices.device
    with torch.cuda.device(device):
        err = getattr(_kernels(), entry)(
            indices.data_ptr(), values.data_ptr(), vector.data_ptr(), out.data_ptr(),
            rows, nnz, d, *extra, *plan, torch.cuda.current_stream(device).cuda_stream,
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


def _dot_operands(indices, values, d, dtype):
    """The row dot's masking: padding reads column 0 with a zero value, an
    index >= d reads column d - 1."""
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).clamp(max=d - 1).long()
    return safe, torch.where(valid, values, 0.0).to(dtype)


def _grad_operands(indices, d):
    """The gradient's masking: padding and indices >= d are kept out (sent
    to column 0 with a zero contribution). Returns (keep, flat columns)."""
    keep = (indices >= 0) & (indices < d)
    return keep, torch.where(keep, indices, 0).long().reshape(-1)


def sparse_row_dots_plain(indices, values, coeff):
    """The plain PyTorch row dot: mask padding, clamp indices >= d."""
    safe, vals = _dot_operands(indices, values, coeff.shape[0], coeff.dtype)
    return torch.sum(vals * coeff[safe], dim=1)


def sparse_grad_plain(indices, values, multiplier, coeff):
    """The plain PyTorch gradient segment sum: padding and indices >= d
    contribute 0 (masked to column 0 with a zero value)."""
    keep, safe = _grad_operands(indices, coeff.shape[0])
    contrib = torch.where(keep, values.to(coeff.dtype) * multiplier[:, None], 0.0)
    return torch.zeros_like(coeff).index_add_(0, safe, contrib.reshape(-1))


def fleet_row_dots_plain(indices, values, coeff):
    """The plain PyTorch member-batched row dot: (N, d) coefficients ->
    (N, B), each row the solo plain row dot of its member, with the same
    masking and the same sum over a row's slots."""
    safe, vals = _dot_operands(indices, values, coeff.shape[1], coeff.dtype)
    return torch.sum(vals * coeff[:, safe], dim=2)


def fleet_grad_plain(indices, values, multiplier, coeff):
    """The plain PyTorch member-batched gradient: (N, B) multipliers ->
    (N, d), each row the solo plain gradient of its member, its slots added
    in the same order."""
    keep, safe = _grad_operands(indices, coeff.shape[1])
    contrib = torch.where(keep, values.to(coeff.dtype) * multiplier[:, :, None], 0.0)
    grad = torch.zeros(coeff.shape, dtype=coeff.dtype, device=coeff.device)
    return grad.index_add_(1, safe, contrib.reshape(coeff.shape[0], -1))


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
    _launch_grad(indices, values, multiplier, grad)
    sparse_grad.launches += 1
    return grad


def _launch_grad(indices, values, multiplier, grad, stats=None):
    """sparse_grad's kernel into the zeroed `grad`, with its plan for the
    batch's card; `stats`, if given, the address of WALK_STATS' zeroed
    int32 counters."""
    plan = _grad_plan(*indices.shape, _sm_count(indices.device.index))
    _launch("sparse_grad", "fmt_sparse_grad", indices, values, multiplier, grad, grad.shape[0],
            (stats,), plan)


def sparse_grad_walk(indices, values, multiplier, coeff):
    """sparse_grad's kernel with its walk counted, to check on the card
    which of its paths a batch runs: returns the gradient and, summed over
    the blocks, WALK_STATS: the table flushes with chunks still to come,
    the slots that found no table entry within reach, and the chunks added
    with direct REDs. CUDA tensors only; not counted in
    `sparse_grad.launches`."""
    rows = indices.shape[0] if indices.ndim == 2 else -1
    device = _check_batch("sparse_grad_walk", indices, values, multiplier, rows, coeff)
    if device.type != "cuda":
        raise ValueError("sparse_grad_walk: the walk's counters exist only in the CUDA kernel")
    grad = torch.zeros(coeff.shape, dtype=torch.float32, device=device)
    stats = torch.zeros(len(WALK_STATS), dtype=torch.int32, device=device)
    if indices.numel() != 0:
        _launch_grad(indices, values, multiplier, grad, stats.data_ptr())
    return grad, dict(zip(WALK_STATS, stats.tolist()))


def _check_fleet(name, indices, values, coeff, multiplier=None):
    """The fleet kernels' operands: a batch as the solo kernels take it, an
    (N, d) float32 coeff laid out member-major or member-minor, and for the
    gradient an (N, B) contiguous float32 multiplier. Returns the device."""
    extra = () if multiplier is None else (("multiplier", multiplier),)
    if indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {indices.dtype}")
    for label, t in (("values", values), ("coeff", coeff), *extra):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
    if indices.ndim != 2 or tuple(values.shape) != tuple(indices.shape):
        raise ValueError(
            f"{name}: indices and values must be matching (B, nnz), got "
            f"{tuple(indices.shape)} and {tuple(values.shape)}"
        )
    if coeff.ndim != 2 or coeff.shape[0] < 1 or coeff.shape[1] < 1:
        raise ValueError(f"{name}: coeff must be a non-empty (N, d) matrix, got {tuple(coeff.shape)}")
    if not (coeff.is_contiguous() or coeff.T.is_contiguous()):
        raise ValueError(f"{name}: coeff must be a contiguous (N, d) or the transpose of a "
                         "contiguous (d, N)")
    if multiplier is not None and tuple(multiplier.shape) != (coeff.shape[0], indices.shape[0]):
        raise ValueError(f"{name}: expected a {(coeff.shape[0], indices.shape[0])} multiplier, "
                         f"got {tuple(multiplier.shape)}")
    devices = {t.device for t in (indices, values, coeff, *(t for _, t in extra))}
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must be on one device, got {devices}")
    for t in (indices, values, *(t for _, t in extra)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def _fleet_strides(t):
    """(member stride, column stride) of an (N, d) operand in elements:
    (d, 1) member-major, (1, N) member-minor."""
    return (t.shape[1], 1) if t.is_contiguous() else (1, t.shape[0])


def fleet_row_dots(indices, values, coeff):
    """Masked per-row dots of padded-CSR rows with each member's row of
    `coeff` (N, d) -> (N, B) float32. CUDA tensors run the hand-written
    kernel; CPU tensors the plain version."""
    device = _check_fleet("fleet_row_dots", indices, values, coeff)
    if device.type == "cpu":
        return fleet_row_dots_plain(indices, values, coeff)
    members = coeff.shape[0]
    out = torch.empty((members, indices.shape[0]), dtype=torch.float32, device=device)
    if indices.numel() == 0:
        return out.zero_()
    strides = _fleet_strides(coeff)
    vec4 = _float4_members(members, *strides, coeff.data_ptr())
    _launch("fleet_row_dots", "fmt_fleet_row_dots", indices, values, coeff, out,
            coeff.shape[1], (members, *strides, int(vec4)))
    fleet_row_dots.launches += 1
    return out


def fleet_grad(indices, values, multiplier, coeff):
    """Gradient segment sums of padded-CSR rows, one per member, scaled by
    that member's row of `multiplier` (N, B) -> (N, d) float32 in the
    layout of `coeff`. CUDA tensors run the hand-written kernel; CPU
    tensors the plain version."""
    device = _check_fleet("fleet_grad", indices, values, coeff, multiplier)
    if device.type == "cpu":
        grad = fleet_grad_plain(indices, values, multiplier, coeff)
        return grad if coeff.is_contiguous() else grad.T.contiguous().T
    members, d = coeff.shape
    if coeff.is_contiguous():
        grad = torch.zeros((members, d), dtype=torch.float32, device=device)
    else:
        grad = torch.zeros((d, members), dtype=torch.float32, device=device).T
    if indices.numel() == 0:
        return grad
    _launch("fleet_grad", "fmt_fleet_grad", indices, values, multiplier, grad, d,
            (members, *_fleet_strides(grad)))
    fleet_grad.launches += 1
    return grad


sparse_row_dots.launches = 0
sparse_grad.launches = 0
fleet_row_dots.launches = 0
fleet_grad.launches = 0
KERNELS = (sparse_row_dots, sparse_grad, fleet_row_dots, fleet_grad)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
