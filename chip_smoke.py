#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flink_ml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

It needs a CUDA card and exits non-zero without one, and on any failed
phase; it imports nothing of JAX or of the JAX package. Phases:

1. device: the card's name and power limit (nvidia-smi); the build of
   `flink_ml_tpu_torch/csrc/sparse_kernels.cu` and of the floor probes
   `csrc/probes.cu`, one nvcc each, started together; the registers of
   each kernel (cuobjdump -res-usage) and a look at the SASS (the
   gradient adds with RED);
2. each kernel against its plain PyTorch version, on seeded inputs with
   -1 padding and indices >= d: at edge shapes, on the index-convention
   probe, at the main path's shapes (the fit batch, 100,000 x 39, and the
   1M-row transform), on Zipf-skewed indices at the fit batch (values on
   a grid of quarters, so the gradient must be exact), on a fit batch
   sliced at an odd row offset (not 16-byte aligned) and on a wide row
   (16 x 5000). Each case prints CUDA-event times of the kernel, the
   plain version, one PyTorch library call and, where the batch is
   aligned, the floor probes (a gather per slot; an atomic add per slot),
   beside the bound from the bytes moved;
3. the main path, with the launch counts reset just before it and read
   just after: LogisticRegression fit -> transform on dense data at the
   reference config (10M x 100, maxIter 20, globalBatchSize 100,000,
   learningRate 0.1, tol 1e-6) and on wide sparse data (1M rows, dim 1e6,
   39 non-zeros per row), then save -> load -> transform of both models;
4. the results: the dense fit against a float64 numpy replay of the same
   epochs on the same rows, the sparse fit against the same fit on the
   plain loss on the card, the transforms against float64 references;
5. warm times: the median of five warm fits and transforms of each
   configuration, and a torch.profiler pass over one warm fit of each and
   one warm sparse transform (device time by kernel, the device's idle
   share);
6. a `kernels` JSON line, then the result line.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DENSE_ROWS, DIM = 10_000_000, 100
SPARSE_ROWS, SPARSE_DIM, NNZ = 1_000_000, 1_000_000, 39
MAX_ITER, BATCH, LEARNING_RATE, TOL = 20, 100_000, 0.1, 1e-6
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# above the H100's highest SM clock, so a spin of n cycles lasts at least n / this
SPIN_CYCLES_PER_S = 2e9
MIN_SPIN_S = 0.005
# kernel vs plain version: float32 sums in another order (row dots: a warp
# shuffle tree over <= 39 terms; gradient: atomics in run-dependent order)
ROW_DOTS_TOL = dict(rtol=1e-5, atol=5e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_REL_TOL = 1e-3
DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE = 0.05, 0.001


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, arg_sets, iters=30, warmup=3, ahead=True):
    """Mean time of `fn` over `iters` calls between CUDA events, cycling
    through `arg_sets` (several copies of the inputs keep them out of L2).
    With `ahead`, the stream first spins for twice as long as the host
    takes to enqueue the calls (and at least MIN_SPIN_S), so the events
    time the calls back to back on the card. Without it (reported as
    `enqueue_ms`), a call that the host enqueues more slowly than the card
    runs it is timed at the host's rate."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(int(max(2 * iters * host_s, MIN_SPIN_S) * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def copies_for(nbytes: int, l2_multiple_bytes: int = 150 << 20) -> int:
    return max(1, math.ceil(l2_multiple_bytes / max(nbytes, 1)))


def sparse_batch(gen, rows, nnz, d, dev, mask_share, oor_share):
    """Seeded padded-CSR rows: a share of -1 padding slots and a share of
    indices >= d, which the dot clamps and the gradient drops."""
    idx = torch.randint(0, d, (rows, nnz), generator=gen, device=dev, dtype=torch.int32)
    u = torch.rand((rows, nnz), generator=gen, device=dev)
    idx = torch.where(u < mask_share, -1, idx)
    idx = torch.where(u > 1.0 - oor_share, d + idx % 5, idx).contiguous()
    vals = torch.rand((rows, nnz), generator=gen, device=dev)
    return idx, vals


EDGE_SHAPES = [(64, 5, 24), (200, 39, 64), (1, 3, 4), (33, 40, 50), (7, 0, 10),
               (300, 64, 1000), (300, 65, 1000)]


def edge_phase(sk, dev):
    """The kernels at the edges of their layout (one row, nnz above a warp
    width, a tiny d, an empty row width, the widest row of one pass of the
    row dot and the narrowest of two) and on the index-convention probe:
    an index >= d is clamped in the dot and dropped in the gradient."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for rows, nnz, d in EDGE_SHAPES:
        idx, vals = sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
        coeff = torch.randn(d, generator=gen, device=dev)
        mult = torch.randn(rows, generator=gen, device=dev)
        check(torch.allclose(sk.sparse_row_dots(idx, vals, coeff),
                             sk.sparse_row_dots_plain(idx, vals, coeff), **ROW_DOTS_TOL),
              f"sparse_row_dots disagrees at {(rows, nnz, d)}")
        check(torch.allclose(sk.sparse_grad(idx, vals, mult, coeff),
                             sk.sparse_grad_plain(idx, vals, mult, coeff), **GRAD_TOL),
              f"sparse_grad disagrees at {(rows, nnz, d)}")
    idx = torch.tensor([[0, 5, -1], [7, 1, 2]], dtype=torch.int32, device=dev)
    ones = torch.ones((2, 3), device=dev)
    coeff = torch.tensor([1.0, 10.0, 100.0, 1000.0], device=dev)
    check(sk.sparse_row_dots(idx, ones, coeff).tolist() == [1001.0, 1110.0],
          "sparse_row_dots breaks the clamp convention")
    check(sk.sparse_grad(idx, ones, torch.ones(2, device=dev), coeff).tolist() == [1.0, 1.0, 1.0, 0.0],
          "sparse_grad breaks the drop convention")
    log(f"  edge shapes {EDGE_SHAPES} and the index probe agree")


ZIPF_EXPONENT = 1.1
MISALIGNED_OFFSET = 3  # rows: 3 * 39 * 4 bytes = 468, not a multiple of 16
WIDE_SHAPE = (16, 5000, 4096)


def zipf_batch(gen, rows, nnz, d, dev):
    """Seeded skewed rows, as Criteo's categorical features are skewed:
    rank k is drawn with weight k^-1.1 and the ranks are scattered over the
    columns by a seeded permutation, as hashed features are; padding and
    indices >= d as in `sparse_batch`. Values (and the caller's
    multipliers) lie on a grid of quarters, so every partial sum of the
    gradient is exact in float32 and any order of its adds gives the same,
    exact result."""
    weights = torch.arange(1, d + 1, device=dev, dtype=torch.float64) ** -ZIPF_EXPONENT
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((rows, nnz), generator=gen, device=dev, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp(max=d - 1)
    idx = torch.randperm(d, generator=gen, device=dev)[rank].to(torch.int32)
    u = torch.rand((rows, nnz), generator=gen, device=dev)
    idx = torch.where(u < DEFAULT_MASK_SHARE, -1, idx)
    idx = torch.where(u > 1.0 - OUT_OF_RANGE_SHARE, d + idx % 5, idx).contiguous()
    vals = torch.randint(0, 5, (rows, nnz), generator=gen, device=dev).to(torch.float32) / 4
    return idx, vals


def cuobjdump(cuda_build, name, flag):
    """`cuobjdump <flag>` of the built library of csrc/<name>.cu."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, flag, str(cuda_build._library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def resource_usage(cuda_build, name):
    """Registers, stack and spills (LOCAL) of each kernel of the library, as
    cuobjdump reads them from the binary, whether this run compiled it or
    found it built."""
    usage, kernel = {}, None
    for line in cuobjdump(cuda_build, name, "-res-usage").splitlines():
        match = re.match(r"\s*Function (\S+):", line)
        if match:
            kernel = match.group(1)
        elif kernel is not None and "REG:" in line:
            usage[kernel] = " ".join(f for f in line.split() if f.split(":")[0] in ("REG", "STACK", "LOCAL"))
            kernel = None
    check(bool(usage), f"cuobjdump found no kernel in {name}")
    return usage


def check_sass(cuda_build):
    """What the compiler made of the gradient (cuobjdump -sass): its adds,
    whose result is unused, must be RED (REDG on Hopper), not ATOMG, which
    waits for the old value."""
    sass = cuobjdump(cuda_build, "sparse_kernels", "-sass")
    opcode = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    names = {"RED": "RED", "REDG": "RED", "ATOMG": "ATOMG"}
    counts, seen, kernel = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            counts[kernel], seen[kernel] = {"RED": 0, "ATOMG": 0}, set()
            continue
        match = opcode.search(line)
        if kernel is not None and match:
            seen[kernel].add(match.group(1))
            if match.group(1) in names:
                counts[kernel][names[match.group(1)]] += 1
    check(any("grad_kernel" in k for k in counts), "no gradient kernel in the SASS")
    for kernel, ops in counts.items():
        log(f"  sass {kernel}: {ops}")
        if "grad_kernel" in kernel:
            check(ops["RED"] > 0 and ops["ATOMG"] == 0,
                  f"{kernel} adds with {ops}, not RED; opcodes {sorted(seen[kernel])}")


def load_probes(cuda_build):
    """csrc/probes.cu: the floors of random L2 access that the kernels meet."""
    import ctypes

    lib = cuda_build.load("probes")
    lib.fmt_probe_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.fmt_probe_red.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.fmt_probe_gather.restype = lib.fmt_probe_red.restype = ctypes.c_int

    def gather(idx, coeff):
        n = idx.numel()
        out = torch.empty(-(-n // 1024) * 32, device=idx.device)
        err = lib.fmt_probe_gather(idx.data_ptr(), coeff.data_ptr(), out.data_ptr(), n,
                                   coeff.shape[0], torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"gather probe launch failed with CUDA error {err}")
        return out

    def red(idx, coeff):
        counts = torch.zeros_like(coeff)
        err = lib.fmt_probe_red(idx.data_ptr(), counts.data_ptr(), idx.numel(), coeff.shape[0],
                                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"RED probe launch failed with CUDA error {err}")
        return counts

    return gather, red


def check_probes(gather, red, idx, coeff):
    """The probes compute something checkable: a sum of the gathered
    coefficients per lane, and a count per column."""
    d = coeff.shape[0]
    flat = idx.reshape(-1)
    pad = torch.full((-flat.numel() % 1024,), -1, dtype=flat.dtype, device=flat.device)
    lanes = torch.cat([flat, pad]).reshape(-1, 8, 32, 4)
    want = torch.where(lanes >= 0, coeff[lanes.clamp(0, d - 1).long()], 0.0).sum(dim=(1, 3))
    check(torch.allclose(gather(idx, coeff), want.reshape(-1), **ROW_DOTS_TOL),
          "the gather probe's sums disagree")
    keep = flat[(flat >= 0) & (flat < d)].long()
    check(torch.equal(red(idx, coeff), torch.bincount(keep, minlength=d).to(torch.float32)),
          "the RED probe's counts disagree")


def measure_case(sk, probes, label, idx, vals, coeff, mult, sets, exact_grad=False):
    """Both kernels on one batch: held against their plain versions, and
    timed with the plain versions, one library call each and, where the
    batch is aligned, the probes. `sets` are copies of (idx, vals) that
    rotate through the timed calls."""
    rows, nnz = idx.shape
    d = coeff.shape[0]
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).clamp(max=d - 1)
    masked_vals = torch.where(valid, vals, 0.0)
    keep = valid & (idx < d)
    batch_bytes = idx.numel() * 4 + vals.numel() * 4
    probe_ms = {}
    if idx.data_ptr() % 16 == 0 and idx.numel() % 4 == 0 and probes is not None:
        gather, red = probes
        check_probes(gather, red, idx, coeff)
        probe_ms["sparse_row_dots"] = cuda_ms(lambda i, v: gather(i, coeff), sets)
        probe_ms["sparse_grad"] = cuda_ms(lambda i, v: red(i, coeff), sets)
    results = {}

    got = sk.sparse_row_dots(idx, vals, coeff)
    want = sk.sparse_row_dots_plain(idx, vals, coeff)
    err = (got - want).abs()
    check(torch.allclose(got, want, **ROW_DOTS_TOL),
          f"sparse_row_dots disagrees with its plain version on {label}: max abs {float(err.max())}")
    lib_out = torch.nn.functional.embedding_bag(
        safe, coeff[:, None], per_sample_weights=masked_vals, mode="sum")[:, 0]
    check(torch.allclose(lib_out, want, **ROW_DOTS_TOL), "embedding_bag yardstick disagrees")
    touched = int(torch.unique(safe[valid]).numel())
    b_ms, b_by = bound_ms(batch_bytes + touched * 4 + rows * 4, 2.0 * int(valid.sum()))
    results["sparse_row_dots"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "ms": cuda_ms(lambda i, v: sk.sparse_row_dots(i, v, coeff), sets),
        "enqueue_ms": cuda_ms(lambda i, v: sk.sparse_row_dots(i, v, coeff), sets, ahead=False),
        "plain_ms": cuda_ms(lambda i, v: sk.sparse_row_dots_plain(i, v, coeff), sets, iters=10),
        "library_ms": cuda_ms(
            lambda s, w: torch.nn.functional.embedding_bag(
                s, coeff[:, None], per_sample_weights=w, mode="sum"),
            [(safe, masked_vals)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
    }

    got = sk.sparse_grad(idx, vals, mult, coeff)
    want = sk.sparse_grad_plain(idx, vals, mult, coeff)
    err = (got - want).abs()
    check(torch.allclose(got, want, **GRAD_TOL),
          f"sparse_grad disagrees with its plain version on {label}: max abs {float(err.max())}")
    if exact_grad:
        check(torch.equal(got, want), f"sparse_grad is not exact on {label}'s exact sums")
    flat_idx = torch.where(keep, idx, 0).long().reshape(-1)
    contrib = torch.where(keep, vals * mult[:, None], 0.0).reshape(-1)
    b_ms, b_by = bound_ms(batch_bytes + rows * 4 + d * 4, 2.0 * int(keep.sum()))
    msets = [(i, v, mult) for i, v in sets]
    results["sparse_grad"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "ms": cuda_ms(lambda i, v, m: sk.sparse_grad(i, v, m, coeff), msets),
        "enqueue_ms": cuda_ms(lambda i, v, m: sk.sparse_grad(i, v, m, coeff), msets, ahead=False),
        "plain_ms": cuda_ms(lambda i, v, m: sk.sparse_grad_plain(i, v, m, coeff), msets, iters=10),
        "library_ms": cuda_ms(lambda fi, c: torch.zeros_like(coeff).index_add_(0, fi, c),
                              [(flat_idx, contrib)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    for name, r in results.items():
        r.update(case=label, rows=rows, nnz=nnz, d=d, probe_ms=probe_ms.get(name))
        probe = f", probe {r['probe_ms']:.4f} ms" if r["probe_ms"] is not None else ""
        log(f"  {name} {label} ({rows} x {nnz}, d={d}): max_abs_err "
            f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms (enqueue-bound {r['enqueue_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){probe}")
    return results


def copies(idx, vals, offset=0):
    """(idx, vals) and enough copies of it to exceed L2 several times; with
    `offset`, each copy is the same row slice of a fresh copy of the larger
    tensor, so its base keeps its alignment."""
    n = copies_for(idx.numel() * 8)
    return [(idx[offset:], vals[offset:])] + [
        (idx.clone()[offset:], vals.clone()[offset:]) for _ in range(n - 1)]


def kernel_phase(sk, probes, dev):
    """Each kernel against its plain version at the main path's shapes
    (the fit batch and the 1M-row transform), on skewed indices, on a
    misaligned row slice and on a wide row; the floor probes beside them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    coeff = torch.randn(SPARSE_DIM, generator=gen, device=dev)
    results = {"sparse_row_dots": [], "sparse_grad": []}

    def run(label, idx, vals, c, mult, sets, exact_grad=False):
        res = measure_case(sk, probes, label, idx, vals, c, mult, sets, exact_grad)
        for name in results:
            results[name].append(res[name])

    for label, rows in (("fit batch", BATCH), ("transform", SPARSE_ROWS)):
        idx, vals = sparse_batch(gen, rows, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
        mult = torch.randn(rows, generator=gen, device=dev)
        run(label, idx, vals, coeff, mult, copies(idx, vals))
        del idx, vals

    idx, vals = zipf_batch(gen, BATCH, NNZ, SPARSE_DIM, dev)
    mult = torch.randint(-4, 5, (BATCH,), generator=gen, device=dev).to(torch.float32) / 4
    run("zipf", idx, vals, coeff, mult, copies(idx, vals), exact_grad=True)
    # The same skewed columns with random float values, not a gate: how far
    # float32 sums in any order stray from the float64 sum on hot columns.
    rvals = torch.rand(idx.shape, generator=gen, device=dev)
    rmult = torch.randn(BATCH, generator=gen, device=dev)
    exact = sk.sparse_grad_plain(idx, rvals.double(), rmult.double(), coeff.double())
    log(f"  zipf with float values (not a gate): max abs error against float64 "
        f"{float((sk.sparse_grad(idx, rvals, rmult, coeff).double() - exact).abs().max()):.3g} "
        f"(kernel), {float((sk.sparse_grad_plain(idx, rvals, rmult, coeff).double() - exact).abs().max()):.3g} "
        f"(plain); largest |g| {float(exact.abs().max()):.4g}")
    del idx, vals, rvals

    big_idx, big_vals = sparse_batch(gen, BATCH + MISALIGNED_OFFSET, NNZ, SPARSE_DIM, dev,
                                     DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
    idx, vals = big_idx[MISALIGNED_OFFSET:], big_vals[MISALIGNED_OFFSET:]
    check(idx.data_ptr() % 16 != 0, "the misaligned slice is aligned")
    mult = torch.randn(BATCH, generator=gen, device=dev)
    run("misaligned slice", idx, vals, coeff, mult,
        copies(big_idx, big_vals, MISALIGNED_OFFSET))
    del big_idx, big_vals, idx, vals

    rows, nnz, d = WIDE_SHAPE
    idx, vals = sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
    wide_coeff = torch.randn(d, generator=gen, device=dev)
    mult = torch.randn(rows, generator=gen, device=dev)
    run("wide row", idx, vals, wide_coeff, mult, copies(idx, vals))
    return results


def numpy_reference_sgd(batch_rows, num_batches, max_iter, lr, tol):
    """The reference's SGD semantics (SGD.java:82-292,
    TerminateOnMaxIterOrTol.java) in float64 numpy, on weighted batches
    `batch_rows(k) -> (X, y, w)`: batch k = epoch mod num_batches, the first
    epoch computes a gradient before any update, one extra update after
    the loop. Returns (coeff, loss, epochs)."""
    coeff = grad = None
    wsum, loss, epoch = 0.0, np.inf, 0
    while epoch < max_iter and loss > tol:
        Xk, yk, wk = batch_rows(epoch % num_batches)
        if coeff is None:
            coeff = np.zeros(Xk.shape[1])
            grad = np.zeros(Xk.shape[1])
        if wsum > 0:
            coeff = coeff - (lr / wsum) * grad
        margin = (Xk @ coeff) * (2.0 * yk - 1.0)
        loss_sum = float(np.sum(wk * np.logaddexp(0.0, -margin)))
        grad = Xk.T @ (wk * (-(2.0 * yk - 1.0) / (np.exp(margin) + 1.0)))
        wsum = float(np.sum(wk))
        loss = loss_sum / max(wsum, 1e-30)
        epoch += 1
    if wsum > 0:
        coeff = coeff - (lr / wsum) * grad
    return coeff, loss, epoch


def sigmoid64(z):
    return 1.0 - 1.0 / (1.0 + np.exp(z))


def estimator(lr_module, weight_col=None):
    est = (
        lr_module.LogisticRegression()
        .set_max_iter(MAX_ITER)
        .set_learning_rate(LEARNING_RATE)
        .set_global_batch_size(BATCH)
        .set_tol(TOL)
    )
    return est.set_weight_col(weight_col) if weight_col else est


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.api import Stage
    from flink_ml_tpu_torch.models import _linear
    from flink_ml_tpu_torch.models.classification import logisticregression as lr_module
    from flink_ml_tpu_torch.ops import cuda_build, losses
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.ops.optimizer import SGD

    dev = torch.device(DEVICE)
    # parity checks cover every float32 matmul: keep TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi reported no card")
    card = smi[0].strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    cuda_sources = ("sparse_kernels", "probes")
    cuda_build.load_all(cuda_sources)
    sk.build()
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(f'{n}.cu' for n in cuda_sources)} (one nvcc each, started "
        f"together) in {build_s:.2f} s")
    for name in cuda_sources:
        for kernel, usage in resource_usage(cuda_build, name).items():
            log(f"  registers {name} {kernel}: {usage}")
    check_sass(cuda_build)
    probes = load_probes(cuda_build)

    # -- 2. kernels against their plain versions ------------------------
    log("phase 2: kernels vs plain versions")
    edge_phase(sk, dev)
    kernel_results = kernel_phase(sk, probes, dev)

    # -- 3. the main path -------------------------------------------------
    log("phase 3: main path (launch counts from here)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    X = torch.rand((DENSE_ROWS, DIM), generator=gen, device=dev)
    y = torch.randint(0, 2, (DENSE_ROWS,), generator=gen, device=dev).to(torch.float32)
    w = torch.rand((DENSE_ROWS,), generator=gen, device=dev)
    dense_table = Table({"features": X, "label": y, "weight": w})
    gen.manual_seed(5)
    s_idx = torch.randint(0, SPARSE_DIM, (SPARSE_ROWS, NNZ), generator=gen, device=dev,
                          dtype=torch.int32)
    s_vals = torch.rand((SPARSE_ROWS, NNZ), generator=gen, device=dev)
    s_y = (torch.rand(SPARSE_ROWS, generator=gen, device=dev) > 0.5).to(torch.float32)
    sparse_table = Table({"features": SparseBatch(SPARSE_DIM, s_idx, s_vals), "label": s_y})
    torch.cuda.synchronize()

    sk.reset_launch_counts()
    dense_model, dense_fit_ms = synced(lambda: estimator(lr_module, "weight").fit(dense_table))
    dense_out, dense_transform_ms = synced(lambda: dense_model.transform(dense_table)[0])
    sparse_model, sparse_fit_ms = synced(lambda: estimator(lr_module).fit(sparse_table))
    sparse_out, sparse_transform_ms = synced(lambda: sparse_model.transform(sparse_table)[0])
    reloaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, model, table in (("dense", dense_model, dense_table),
                                   ("sparse", sparse_model, sparse_table)):
            path = os.path.join(tmp, name)
            model.save(path)
            with open(os.path.join(path, "metadata")) as f:
                class_name = json.load(f)["className"]
            loaded = Stage.load(path)
            reloaded[name] = (class_name, loaded, loaded.transform(table)[0])
    torch.cuda.synchronize()
    launches = sk.launch_counts()
    log(f"  dense fit {dense_fit_ms:.1f} ms, transform {dense_transform_ms:.1f} ms; "
        f"sparse fit {sparse_fit_ms:.1f} ms, transform {sparse_transform_ms:.1f} ms")
    log(f"  launches on the main path: {launches}")
    check(launches["sparse_grad"] == MAX_ITER,
          f"sparse_grad launched {launches['sparse_grad']} times, expected one per epoch ({MAX_ITER})")
    check(launches["sparse_row_dots"] == MAX_ITER + 2,
          f"sparse_row_dots launched {launches['sparse_row_dots']} times, expected "
          f"{MAX_ITER + 2} (one per epoch, the transform, the transform after load)")

    # -- 4. results against references ------------------------------------
    log("phase 4: results")
    num_batches = DENSE_ROWS // BATCH
    touched = min(MAX_ITER, num_batches) * BATCH
    X64 = X[:touched].double().cpu().numpy()
    y64, w64 = y[:touched].double().cpu().numpy(), w[:touched].double().cpu().numpy()
    ref_coeff, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                   w64[k * BATCH:(k + 1) * BATCH]),
        num_batches, MAX_ITER, LEARNING_RATE, TOL,
    )
    coeff, loss, epochs = _linear.run_sgd(
        estimator(lr_module, "weight"), dense_table, losses.BINARY_LOGISTIC_LOSS, "weight",
        validate_binomial=True,
    )
    rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    coeff_rel = float(np.max(np.abs(dense_model.coefficient - ref_coeff)) / np.max(np.abs(ref_coeff)))
    log(f"  dense loss {loss:.8f} vs float64 replay {ref_loss:.8f}: relDiff {rel:.3g}; "
        f"epochs {epochs} vs {ref_epochs}; coeff max rel {coeff_rel:.3g}")
    check(rel < LOSS_REL_TOL, f"dense loss relDiff {rel} >= {LOSS_REL_TOL}")
    check(epochs == ref_epochs, "dense epoch count differs from the replay")
    check(coeff_rel < 1e-3, f"dense coefficients differ from the replay by {coeff_rel}")
    check(np.array_equal(coeff, dense_model.coefficient), "dense refit is not deterministic")

    pred, raw = dense_out.column("prediction"), dense_out.column("rawPrediction")
    check(pred.shape == (DENSE_ROWS,) and raw.shape == (DENSE_ROWS, 2), "dense transform shapes")
    check(bool(torch.isfinite(raw).all()), "dense transform has non-finite values")
    dot64 = X64[:BATCH] @ dense_model.coefficient.astype(np.float64)
    raw_err = float(np.max(np.abs(raw[:BATCH, 1].double().cpu().numpy() - sigmoid64(dot64))))
    clear = np.abs(dot64) > 1e-4
    pred_ok = np.array_equal(pred[:BATCH].cpu().numpy()[clear], (dot64 >= 0)[clear].astype(np.float32))
    log(f"  dense transform vs float64: max abs err {raw_err:.3g}, predictions agree {pred_ok}")
    check(raw_err < 1e-5 and pred_ok, "dense transform disagrees with the float64 reference")

    sgd = SGD(max_iter=MAX_ITER, learning_rate=LEARNING_RATE, global_batch_size=BATCH, tol=TOL)
    c_k, loss_k, ep_k = sgd.optimize(np.zeros(SPARSE_DIM), (s_idx, s_vals), s_y, None,
                                     losses.SPARSE_BINARY_LOGISTIC_LOSS)
    c_p, loss_p, ep_p = sgd.optimize(np.zeros(SPARSE_DIM), (s_idx, s_vals), s_y, None,
                                     losses.PLAIN_SPARSE_BINARY_LOGISTIC_LOSS)
    rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    scale = float(np.max(np.abs(c_p)))
    coeff_err = float(np.max(np.abs(c_k - c_p)))
    model_err = float(np.max(np.abs(sparse_model.coefficient - c_p)))
    log(f"  sparse loss {loss_k:.8f} (kernels) vs {loss_p:.8f} (plain): relDiff {rel:.3g}; "
        f"coeff max abs diff {coeff_err:.3g} and {model_err:.3g} (fit) of max |coeff| {scale:.3g}")
    check(rel < LOSS_REL_TOL, f"sparse loss relDiff {rel} >= {LOSS_REL_TOL}")
    check(ep_k == ep_p, "sparse epoch counts differ")
    # atomics reorder float32 sums: hold coefficients to 1e-4 of their scale
    check(coeff_err <= 1e-4 * scale and model_err <= 1e-4 * scale,
          "sparse coefficients differ from the plain-loss fit")
    s_raw = sparse_out.column("rawPrediction")
    s_coeff = torch.as_tensor(sparse_model.coefficient, device=dev)
    want = lr_module._predict_from_dot(sk.sparse_row_dots_plain(s_idx, s_vals, s_coeff))[1]
    check(s_raw.shape == (SPARSE_ROWS, 2) and bool(torch.isfinite(s_raw).all()), "sparse transform shape")
    check(torch.allclose(s_raw, want, rtol=1e-5, atol=1e-6), "sparse transform disagrees with plain")

    java = "org.apache.flink.ml.classification.logisticregression.LogisticRegressionModel"
    for name, out in (("dense", dense_out), ("sparse", sparse_out)):
        class_name, loaded, again = reloaded[name]
        check(class_name == java, f"{name} model saved as {class_name}")
        check(isinstance(loaded, lr_module.LogisticRegressionModel), f"{name} model reload type")
        for col in ("prediction", "rawPrediction"):
            check(torch.equal(again.column(col), out.column(col)),
                  f"{name} {col} differs after save/load")
    log("  save/load: both models reload and predict identically")

    # -- 5. warm times --------------------------------------------------------
    log("phase 5: warm times")
    warm = {}
    for name, table, weight, model in (("dense", dense_table, "weight", dense_model),
                                       ("sparse", sparse_table, None, sparse_model)):
        fits = [synced(lambda: estimator(lr_module, weight).fit(table))[1] for _ in range(5)]
        transforms = [synced(lambda: model.transform(table)[0])[1] for _ in range(5)]
        warm[name] = (float(np.median(fits)), float(np.median(transforms)))
        log(f"  {name}: fit median {warm[name][0]:.3f} ms (runs {[round(t, 3) for t in fits]}), "
            f"transform median {warm[name][1]:.3f} ms (runs {[round(t, 3) for t in transforms]})")
        profile_run(f"{name} fit", lambda: estimator(lr_module, weight).fit(table))
    profile_run("sparse transform", lambda: sparse_model.transform(sparse_table)[0])

    # -- 6. output -----------------------------------------------------------
    sources = {
        "sparse_row_dots": "flink_ml_tpu/ops/sparsekernels.py:96",
        "sparse_grad": "flink_ml_tpu/ops/sparsekernels.py:107",
    }
    kernels = []
    for name, rows in kernel_results.items():
        main = rows[0]  # the fit batch: the shape of every epoch's launch
        kernels.append({
            "name": name, "route": "cuda",
            "source": "flink_ml_tpu_torch/csrc/sparse_kernels.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "tolerance": ROW_DOTS_TOL if name == "sparse_row_dots" else GRAD_TOL,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "probe_ms": main["probe_ms"], "enqueue_ms": main["enqueue_ms"],
            "shape": [main["rows"], main["nnz"], main["d"]],
            "by_shape": rows,
        })
    log(f"first calls: dense fit {dense_fit_ms:.3f} ms, transform {dense_transform_ms:.3f} ms, "
        f"sparse fit {sparse_fit_ms:.3f} ms, transform {sparse_transform_ms:.3f} ms; "
        f"warm medians: dense fit {warm['dense'][0]:.3f} ms, transform {warm['dense'][1]:.3f} ms, "
        f"sparse fit {warm['sparse'][0]:.3f} ms, transform {warm['sparse'][1]:.3f} ms; "
        f"build {build_s:.2f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_run(name, run):
    """torch.profiler over one warm call (a fit or a transform): the wall
    time, the device's busy time (the sum of its kernels and copies) and
    the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    attr = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    events.sort(key=lambda e: -getattr(e, attr))
    busy_ms = sum(getattr(e, attr) for e in events) / 1e3
    log(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle {100.0 * (1.0 - busy_ms / wall_ms):.1f}%")
    for e in events[:8]:
        log(f"    {getattr(e, attr) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
