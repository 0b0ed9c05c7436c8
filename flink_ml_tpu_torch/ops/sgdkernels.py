"""The SGD engine's epoch kernels: hand-written CUDA on the card, plain
PyTorch on the CPU.

One epoch of the linear models' mini-batch SGD (ops/optimizer.py) applies
the previous gradient, computes the batch's row dots and gradient, and
between those runs a run of small elementwise ops: the update and its
proximal step over the d coefficients, the loss's pointwise form over the
batch's rows, the loss and weight sums, the criteria and the tol mask.
The JAX package leaves them to XLA's fusion and ports no kernel for them;
PyTorch runs each op as its own kernel, about 40 launches an epoch. Two
kernels (`csrc/sgd_epoch.cu`, built at first use by `cuda_build`) take
their place:

- `sgd_update(coeff, grad, wsum, hyper, criteria=None)` -> the new
  coefficient: `coeff - (1 / max(wsum, 1e-30) * lr) * grad`, the proximal
  step where reg > 0, kept where wsum <= 0, and, given the body's criteria,
  kept where the epoch is dead (criteria <= tol);
- `sgd_pointwise(form, pointwise, dot, y, w, tail=None)` ->
  `Pointwise(mult, lsum, wsum, tail)`: the per-row multiplier of the
  pointwise form `form` (the three forms of ops/losses.py, FORMS) and the
  loss and weight sums; given the body's `EpochTail`, also the epoch's
  tail under the tol mask (`EpochOut`).

The tensor's device decides the route, as in `sparsekernels`: a CUDA
tensor goes to the kernel (float32 or float64; anything else raises), a
CPU tensor to the plain version beside it, which is the op sequence the
kernel replaces (`sgd_update_plain`, `sgd_pointwise_plain`, public so
tests and `chip_smoke.py` can hold a kernel against them on the card).
The update kernel rounds as the op sequence does and equals it bit for
bit; the multiplier equals it within the math library's rounding of exp
and log1p. The kernel's sums are taken in a fixed order (`_point_plan`:
each thread its rows in turn, a tree over a block, the same tree over the
blocks), so they repeat from run to run; the plain version sums with
`torch.sum`, so on the CPU a fit is the op sequence bit for bit and the
routes that sum with `torch.sum` (the fleet, the 2D loss, the overlapped
loop) stay equal to it. The kernel's sums differ from `torch.sum`'s by
rounding only.

Each wrapper counts its kernel launches in a plain integer attribute,
`sgd_update.launches` and `sgd_pointwise.launches`; a captured graph's
replays count theirs (utils/lazyjit.py `capture`).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import cuda_build

_SOURCE = "sgd_epoch"
#: the sources a fit's epoch runs, built side by side at the first launch
_FIT_SOURCES = (_SOURCE, "sparse_kernels")

#: the rows of the fit's hyperparameter vector (ops/optimizer.py `sgd_hyper`)
HYPER_LR, HYPER_REG, HYPER_EN, HYPER_TOL, HYPER_L1, HYPER_L2 = range(6)
#: the pointwise forms, in the order of the kernel's template argument
FORMS = ("logistic", "hinge", "least_square")
#: the dtypes the kernels take, by their entries' code
DTYPES = {torch.float32: 0, torch.float64: 1}

#: the update: threads a block, the most blocks of its grid-stride walk,
#: and the bytes of a pack it loads and stores where aligned
UPDATE_THREADS = 256
UPDATE_MAX_BLOCKS = 4096
UPDATE_PACK_BYTES = 16
#: the pointwise pass: threads a block, and the most blocks (one partial
#: each for a thread of the last block)
POINT_THREADS = 256
POINT_MAX_BLOCKS = POINT_THREADS
#: the kernel's ticket counters, one a stream
TICKET_SLOTS = 1024


class EpochTail(NamedTuple):
    """The single-card body's state that the pointwise pass reads to write
    the epoch's tail: the hyperparameters (tol) and the state's weight
    sum, epoch and criteria."""

    hyper: torch.Tensor
    wsum: torch.Tensor
    epoch: torch.Tensor
    criteria: torch.Tensor


class EpochOut(NamedTuple):
    """The epoch's tail under the tol mask `live` (criteria > tol): where
    live the new weight sum, epoch + 1 and criteria, else the state's."""

    wsum: torch.Tensor
    epoch: torch.Tensor
    criteria: torch.Tensor
    live: torch.Tensor


class Pointwise(NamedTuple):
    """What the pointwise pass gives: the per-row multiplier, the loss and
    weight sums and, given an `EpochTail`, the epoch's tail."""

    mult: torch.Tensor
    lsum: torch.Tensor
    wsum: torch.Tensor
    tail: Optional[EpochOut]


@functools.lru_cache(maxsize=256)
def _point_plan(rows: int) -> Tuple[int, int]:
    """The pointwise pass's (grid, passes) for a batch of `rows`: a thread
    of block b takes the rows b * POINT_THREADS + t + k * grid *
    POINT_THREADS, k < passes. A pure function of the batch, so the sums'
    order is the same on every card."""
    grid = max(1, min(-(-rows // POINT_THREADS), POINT_MAX_BLOCKS))
    return grid, -(-rows // (grid * POINT_THREADS))


def _update_plan(d: int, itemsize: int, *data_ptrs) -> Tuple[int, int]:
    """The update's (packed, grid): 16-byte packs where every vector is
    16-byte aligned, a thread a pack (or a coefficient) up to
    UPDATE_MAX_BLOCKS blocks."""
    packed = all(ptr % UPDATE_PACK_BYTES == 0 for ptr in data_ptrs)
    items = -(-d // (UPDATE_PACK_BYTES // itemsize)) if packed else d
    return int(packed), max(1, min(-(-items // UPDATE_THREADS), UPDATE_MAX_BLOCKS))


_slots: Dict[int, int] = {}
_slots_lock = threading.Lock()


def _ticket_slot(stream: int) -> int:
    """The ticket counter of a stream: launches in turn on one stream share
    one, launches that may overlap on two streams do not."""
    with _slots_lock:
        return _slots.setdefault(stream, len(_slots) % TICKET_SLOTS)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load_all(_FIT_SOURCES)[0]
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.fmt_sgd_update.argtypes = [ctypes.c_int] + [ptr] * 6 + [i64] + [ctypes.c_int] * 2 + [ptr]
    lib.fmt_sgd_pointwise.argtypes = (
        [ctypes.c_int] * 2 + [ptr] * 3 + [i64] + [ctypes.c_int] * 2 + [ptr] * 2
        + [ctypes.c_int] + [ptr] * 10)
    for fn in (lib.fmt_sgd_update, lib.fmt_sgd_pointwise):
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernels now rather than at the first launch."""
    _kernels()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda(name: str, dtype: torch.dtype, *named) -> int:
    """The kernel's operands: one CUDA device, `dtype` float32 or float64
    for the (label, tensor, want dtype) triples whose want is None, each
    contiguous. Returns the dtype's code."""
    if dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {dtype}")
    devices = set()
    for label, t, want in named:
        if t is None:
            continue
        if t.dtype != (dtype if want is None else want):
            raise TypeError(f"{name}: {label} must be {dtype if want is None else want}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must be on one device, got {devices}")
    return DTYPES[dtype]


def _launch(name: str, entry: str, device, *args) -> None:
    with torch.cuda.device(device):
        err = getattr(_kernels(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def sgd_update_plain(coeff, grad, wsum, hyper, criteria=None):
    """The plain update: `_update_model`'s op sequence, the proximal step
    with the hyperparameters as device operands (coeff kept exactly where
    reg is 0), kept where wsum <= 0 and, given `criteria`, where
    criteria <= tol. `lr / t` is `t.reciprocal() * lr`, as torch computes
    it for a host lr."""
    updated = coeff - (torch.reciprocal(torch.clamp(wsum, min=1e-30)) * hyper[HYPER_LR]) * grad
    step = hyper[HYPER_LR] * (hyper[HYPER_L1] * torch.sign(updated) + hyper[HYPER_L2] * updated)
    updated = torch.where(hyper[HYPER_REG] > 0.0, updated - step, updated)
    keep = wsum > 0
    if criteria is not None:
        keep = keep & (criteria > hyper[HYPER_TOL])
    return torch.where(keep, updated, coeff)


def sgd_update(coeff, grad, wsum, hyper, criteria=None):
    """The coefficient after one update (`sgd_update_plain`'s function).
    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version."""
    if coeff.device.type == "cpu":
        return sgd_update_plain(coeff, grad, wsum, hyper, criteria)
    dtype = _check_cuda("sgd_update", coeff.dtype, ("coeff", coeff, None), ("grad", grad, None),
                        ("wsum", wsum, None), ("hyper", hyper, None),
                        ("criteria", criteria, torch.float32))
    if coeff.ndim != 1 or tuple(grad.shape) != tuple(coeff.shape):
        raise ValueError(f"sgd_update: coeff and grad must be matching (d,) vectors, got "
                         f"{tuple(coeff.shape)} and {tuple(grad.shape)}")
    if wsum.numel() != 1 or hyper.numel() <= HYPER_L2 or (criteria is not None
                                                          and criteria.numel() != 1):
        raise ValueError("sgd_update: wsum and criteria must be scalars, hyper the fit's vector")
    out = torch.empty_like(coeff)
    d = coeff.shape[0]
    if d == 0:
        return out
    plan = _update_plan(d, coeff.element_size(), coeff.data_ptr(), grad.data_ptr(),
                        out.data_ptr())
    _launch("sgd_update", "fmt_sgd_update", coeff.device, dtype, coeff.data_ptr(),
            grad.data_ptr(), wsum.data_ptr(), hyper.data_ptr(), _ptr(criteria), out.data_ptr(),
            d, *plan)
    sgd_update.launches += 1
    return out


def sgd_pointwise_plain(pointwise: Callable, dot, y, w,
                        tail: Optional[EpochTail] = None) -> Pointwise:
    """The plain pointwise pass: `pointwise(dot, y, w)`, `torch.sum` of the
    loss and of the weights, and given `tail` the epoch's tail under the
    tol mask, as the body's selects formed it."""
    loss, mult = pointwise(dot, y, w)
    lsum, wsum = torch.sum(loss), torch.sum(w)
    if tail is None:
        return Pointwise(mult, lsum, wsum, None)
    live = tail.criteria > tail.hyper[HYPER_TOL]
    criteria = (lsum / torch.clamp(wsum, min=1e-30)).to(torch.float32)
    return Pointwise(mult, lsum, wsum, EpochOut(
        torch.where(live, wsum, tail.wsum), torch.where(live, tail.epoch + 1, tail.epoch),
        torch.where(live, criteria, tail.criteria), live))


def sgd_pointwise(form: str, pointwise: Callable, dot, y, w,
                  tail: Optional[EpochTail] = None) -> Pointwise:
    """The pointwise pass of the form `form` (one of FORMS; `pointwise` its
    plain op sequence) over the batch: `sgd_pointwise_plain`'s function.
    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version."""
    if dot.device.type == "cpu":
        return sgd_pointwise_plain(pointwise, dot, y, w, tail)
    if form not in FORMS:
        raise ValueError(f"sgd_pointwise: no kernel for the pointwise form {form!r}")
    named = [("dot", dot, None), ("y", y, None), ("w", w, None)]
    if tail is not None:
        named += [("hyper", tail.hyper, None), ("wsum", tail.wsum, None),
                  ("epoch", tail.epoch, torch.int32), ("criteria", tail.criteria, torch.float32)]
    dtype = _check_cuda("sgd_pointwise", dot.dtype, *named)
    batch = dot.shape[0] if dot.ndim == 1 else -1
    if batch < 0 or tuple(y.shape) != (batch,) or tuple(w.shape) != (batch,):
        raise ValueError(f"sgd_pointwise: dot, y and w must be matching (B,) vectors, got "
                         f"{tuple(dot.shape)}, {tuple(y.shape)} and {tuple(w.shape)}")
    if tail is not None and (tail.hyper.numel() <= HYPER_TOL or tail.wsum.numel() != 1
                             or tail.epoch.numel() != 1 or tail.criteria.numel() != 1):
        raise ValueError("sgd_pointwise: the tail's wsum, epoch and criteria must be scalars")
    device = dot.device
    grid, passes = _point_plan(batch)
    mult = torch.empty_like(dot)
    partials = torch.empty(2 * grid, dtype=dot.dtype, device=device)
    sums = torch.empty(2, dtype=dot.dtype, device=device)
    out = None
    if tail is not None:
        out = EpochOut(torch.empty((), dtype=dot.dtype, device=device),
                       torch.empty((), dtype=torch.int32, device=device),
                       torch.empty((), dtype=torch.float32, device=device),
                       torch.empty((), dtype=torch.bool, device=device))
    state = (None,) * 8 if tail is None else tuple(map(_ptr, (*tail, *out)))
    slot = _ticket_slot(torch.cuda.current_stream(device).cuda_stream)
    _launch("sgd_pointwise", "fmt_sgd_pointwise", device, dtype, FORMS.index(form),
            dot.data_ptr(), y.data_ptr(), w.data_ptr(), batch, grid, passes,
            mult.data_ptr(), partials.data_ptr(), slot, sums.data_ptr(), *state)
    sgd_pointwise.launches += 1
    return Pointwise(mult, sums[0], sums[1], out)


sgd_update.launches = 0
sgd_pointwise.launches = 0
KERNELS = (sgd_update, sgd_pointwise)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
