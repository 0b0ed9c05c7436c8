#!/usr/bin/env python3
"""The sparse kernels of the PyTorch/CUDA port against other designs, on one
CUDA card, all timed the same way in one process.

    python3 scripts/torch_kernel_designs.py      # from the repository root

Designs (`flink_ml_tpu_torch/csrc/designs.cu`, beside the shipped
`csrc/sparse_kernels.cu`):

- row dot: `shipped` (a warp per row, 2 slots a lane in flight); `first`
  (the port's first kernel: a warp per row, one slot at a time);
  `lanesL_kK` (L lanes a row, K slots a lane in flight, a grid that covers
  the rows); `lanes32_k2_walk` (the shipped layout walked by 8 blocks an
  SM);
- gradient: `shipped` (the persistent grid with a shared-memory column
  table, on `ops/sparsekernels.py`'s `_grad_plan`); `red` (the first
  gradient: a thread per slot, a RED each); and the shipped kernel on other
  plans: `flush_each_chunk` (the table flushed after every chunk),
  `threads256`, `threads1024`, `one_block_per_sm` (chunks up to 4096),
  `four_blocks_per_sm` (tables of 4096 entries, chunks up to 1024) and
  `chunk1024`;
- fleet row dot at N = 8: `shipped` (float4 member loads where coeff is
  member-minor) and `scalar` (the first fleet row dot, 8 scalar loads a slot), each
  on member-minor and member-major coefficients.

Every design is first held against the plain PyTorch version at edge shapes
and at the fit batch. Then, on the fit batch (100,000 x 39, d = 1e6), the
1M-row transform batch, Zipf(1.1) indices at the fit batch and the text
path's fit batch (100,000 x 100, d = 2^18), each design is timed in five
interleaved rounds with chip_smoke.py's `cuda_ms` (CUDA events around 30
launches after the stream spins, so device time), and the median, min and
max are printed. Last, the sparse LogisticRegression fit (1M x 1e6 x 39,
20 epochs) runs with the wrappers' launches swapped for the port's first
pair of kernels (`first` row dot, `red` gradient), for the row dot with the
`red` gradient, and for the shipped pair, three fits each in three rounds,
and torch.profiler gives each kernel's device time per launch inside the
fit. Then whole fits and 1M-row transforms on the first and on the shipped
pair alternate, 15 of each, timed on the host's clock with a synchronize on
each side. The card's name and power limit come first; a JSON summary
comes last.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROUNDS = 5
WALL_ROUNDS = 15
LANES = {"lanes32_k2": (2, 5), "lanes16_k4": (4, 4), "lanes16_k2": (2, 4), "lanes8_k8": (8, 3),
         "lanes8_k4": (4, 3), "lanes4_k8": (8, 2), "lanes1_k8": (8, 0)}
EDGE_SHAPES = cs.EDGE_SHAPES + [cs.WIDE_SHAPE]
# the shipped gradient on other plans: module constants of ops/sparsekernels.py
# for `_grad_plan`, and fields of its plan replaced after
GRAD_PLANS = {
    "shipped": ({}, {}),
    "flush_each_chunk": ({}, {"flush_at": 0}),
    "threads256": ({"TABLE_THREADS": 256}, {}),
    "threads1024": ({"TABLE_THREADS": 1024}, {}),
    "one_block_per_sm": ({"TABLE_BLOCKS_PER_SM": 1, "TABLE_MAX_CHUNK": 4096}, {}),
    "four_blocks_per_sm": ({"TABLE_BLOCKS_PER_SM": 4, "TABLE_MAX": 4096, "TABLE_MAX_CHUNK": 1024},
                           {}),
    "chunk1024": ({"TABLE_MAX_CHUNK": 1024}, {}),
}


def grad_plan(sk, design, rows, nnz, sms):
    """`_grad_plan` with GRAD_PLANS[design]'s constants, then its fields."""
    consts, fields = GRAD_PLANS[design]
    saved = {k: getattr(sk, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(sk, k, v)
        plan = sk._grad_plan.__wrapped__(rows, nnz, sms)
    finally:
        for k, v in saved.items():
            setattr(sk, k, v)
    return plan._replace(**fields)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_designs: no CUDA device is available", file=sys.stderr)
        return 2
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.models.classification import logisticregression as lr_module
    from flink_ml_tpu_torch.ops import cuda_build
    from flink_ml_tpu_torch.ops import sparsekernels as sk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lib, designs = cuda_build.load_all(("sparse_kernels", "designs"))
    sk.build()
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    designs.fmt_first_row_dots.argtypes = [vp] * 4 + [ll, i32, ll, vp]
    designs.fmt_lanes_row_dots.argtypes = [vp] * 4 + [ll, i32, ll, i32, i32, i32, vp]
    red_grad, scalar_fleet_row_dots = cs.load_designs(cuda_build, sk)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    shipped_launch = sk._launch

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def ok(err, what):
        cs.check(err == 0, f"{what}: CUDA error {err}")

    def row_dots(design, idx, vals, coeff, out=None):
        out = torch.empty(idx.shape[0], device=dev) if out is None else out
        rows, nnz = idx.shape
        ptrs = (idx.data_ptr(), vals.data_ptr(), coeff.data_ptr(), out.data_ptr(), rows, nnz,
                coeff.shape[0])
        if design == "shipped":
            p = sk._launch_plan(rows, nnz)
            ok(lib.fmt_sparse_row_dots(*ptrs, p.threads, p.grid, stream()), design)
        elif design == "first":
            ok(designs.fmt_first_row_dots(*ptrs, stream()), design)
        else:
            k, lanes_log2 = LANES[design.removesuffix("_walk")]
            grid = -(-rows // (8 * (32 >> lanes_log2)))
            if design.endswith("_walk"):
                grid = min(grid, 8 * sms)
            ok(designs.fmt_lanes_row_dots(*ptrs, k, lanes_log2, grid, stream()), design)
        return out

    def grad(design, idx, vals, mult, d, out=None):
        coeff = torch.empty(d, device=dev)
        if design == "red":
            return red_grad(idx, vals, mult, coeff) if out is None else out.copy_(
                red_grad(idx, vals, mult, coeff))
        out = torch.zeros(d, device=dev) if out is None else out
        plan = grad_plan(sk, design, *idx.shape, sms)
        shipped_launch(design, "fmt_sparse_grad", idx, vals, mult, out, d, (None,), plan)
        return out

    dot_designs = ["shipped", "first", *LANES, "lanes32_k2_walk"]
    grad_designs = ["red", *GRAD_PLANS]

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    for rows, nnz, d in EDGE_SHAPES + [(cs.BATCH, cs.NNZ, cs.SPARSE_DIM)]:
        idx, vals = cs.sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
        coeff = torch.randn(d, generator=gen, device=dev)
        mult = torch.randn(rows, generator=gen, device=dev)
        want = sk.sparse_row_dots_plain(idx, vals, coeff)
        for design in dot_designs:
            cs.check(torch.allclose(row_dots(design, idx, vals, coeff), want, **cs.ROW_DOTS_TOL),
                     f"row dot {design} disagrees at {(rows, nnz, d)}")
        want = sk.sparse_grad_plain(idx, vals, mult, coeff)
        for design in grad_designs:
            cs.check(torch.allclose(grad(design, idx, vals, mult, d), want, **cs.GRAD_TOL),
                     f"gradient {design} disagrees at {(rows, nnz, d)}")
    print(f"every design agrees with the plain versions at {EDGE_SHAPES} and the fit batch",
          flush=True)

    coeff = torch.randn(cs.SPARSE_DIM, generator=gen, device=dev)
    summary = {"card": card, "device_ms": {}, "in_fit_ms_per_launch": {},
               "grad_plans": {name: grad_plan(sk, name, cs.BATCH, cs.NNZ, sms)._asdict()
                              for name in GRAD_PLANS}}
    for label in ("fit batch", "transform", "zipf", "text fit batch"):
        c = coeff
        if label == "zipf":
            idx, vals = cs.zipf_batch(gen, cs.BATCH, cs.NNZ, cs.SPARSE_DIM, dev)
        elif label == "text fit batch":
            idx, vals, d = cs.text_fit_batch(dev)
            c = torch.randn(d, generator=gen, device=dev)
        else:
            rows = cs.BATCH if label == "fit batch" else cs.SPARSE_ROWS
            idx, vals = cs.sparse_batch(gen, rows, cs.NNZ, cs.SPARSE_DIM, dev,
                                        cs.DEFAULT_MASK_SHARE, cs.OUT_OF_RANGE_SHARE)
        mult = torch.randn(idx.shape[0], generator=gen, device=dev)
        sets = cs.copies(idx, vals)
        times = {}
        for _ in range(ROUNDS):
            for design in dot_designs:
                times.setdefault(("row_dots", design), []).append(
                    cs.cuda_ms(lambda i, v: row_dots(design, i, v, c), sets))
            for design in grad_designs:
                times.setdefault(("grad", design), []).append(
                    cs.cuda_ms(lambda i, v: grad(design, i, v, mult, c.shape[0]), sets))
        for (kernel, design), ts in times.items():
            stats = {"median": statistics.median(ts), "min": min(ts), "max": max(ts)}
            summary["device_ms"][f"{kernel} {design} {label}"] = stats
            print(f"{kernel:8s} {design:18s} {label:14s} {tuple(idx.shape)}: median "
                  f"{stats['median']:.4f} ms, min {stats['min']:.4f}, max {stats['max']:.4f}",
                  flush=True)
        del idx, vals, sets

    # the fleet row dot at the sparse fleet's batch, both designs, both layouts
    idx, vals = cs.sparse_batch(gen, cs.BATCH, cs.NNZ, cs.SPARSE_DIM, dev, cs.DEFAULT_MASK_SHARE,
                                cs.OUT_OF_RANGE_SHARE)
    C = torch.randn(cs.FLEET_MEMBERS, cs.SPARSE_DIM, generator=gen, device=dev)
    layouts = {"member-minor": C.T.contiguous().T, "member-major": C}
    fleet_designs = {"shipped": sk.fleet_row_dots, "scalar": scalar_fleet_row_dots}
    sets = cs.copies(idx, vals)
    times = {}
    for _ in range(ROUNDS):
        for design, fn in fleet_designs.items():
            for layout, c in layouts.items():
                times.setdefault(f"fleet_row_dots {design} {layout}", []).append(
                    cs.cuda_ms(lambda i, v: fn(i, v, c), sets))
    for key, ts in times.items():
        stats = {"median": statistics.median(ts), "min": min(ts), "max": max(ts)}
        summary["device_ms"][key] = stats
        print(f"{key:36s} N={cs.FLEET_MEMBERS} {tuple(idx.shape)}: median {stats['median']:.4f} ms, "
              f"min {stats['min']:.4f}, max {stats['max']:.4f}", flush=True)
    del idx, vals, sets

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen.manual_seed(5)
    s_idx = torch.randint(0, cs.SPARSE_DIM, (cs.SPARSE_ROWS, cs.NNZ), generator=gen, device=dev,
                          dtype=torch.int32)
    s_vals = torch.rand((cs.SPARSE_ROWS, cs.NNZ), generator=gen, device=dev)
    s_y = (torch.rand(cs.SPARSE_ROWS, generator=gen, device=dev) > 0.5).to(torch.float32)
    table = Table({"features": SparseBatch(cs.SPARSE_DIM, s_idx, s_vals), "label": s_y})
    chosen = {}

    def launch(name, entry, indices, values, vector, out, d, extra=(), plan=None):
        if entry == "fmt_sparse_grad":
            grad(chosen["grad"], indices, values, vector, d, out)
        elif entry == "fmt_sparse_row_dots":
            row_dots(chosen["row_dots"], indices, values, vector, out)
        else:
            shipped_launch(name, entry, indices, values, vector, out, d, extra, plan)

    sk._launch = launch
    pairs = [("first", "red"), ("shipped", "red"), ("shipped", "shipped")]
    kernel_names = {"row_dots": ("row_dots_kernel",), "grad": ("grad_kernel",)}
    for rep in range(3):
        for pair in pairs:
            chosen.update(row_dots=pair[0], grad=pair[1])
            cs.estimator(lr_module.LogisticRegression).fit(table)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    cs.estimator(lr_module.LogisticRegression).fit(table)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
                else "self_cuda_time_total"
            for e in events:
                for kernel, marks in kernel_names.items():
                    if any(m in e.key for m in marks):
                        per = getattr(e, attr) / 1e3 / e.count
                        key = f"{kernel} {chosen[kernel]}"
                        summary["in_fit_ms_per_launch"].setdefault(key, []).append(per)
                        print(f"in fit, round {rep}: {kernel:8s} {chosen[kernel]:18s} with "
                              f"{'/'.join(pair)}: {per:.4f} ms a launch (x{e.count})", flush=True)

    # whole fits and 1M-row transforms on the first and on the shipped
    # kernels, interleaved, wall time with a synchronize on each side
    model = cs.estimator(lr_module.LogisticRegression).fit(table)
    walls = {}
    for _ in range(WALL_ROUNDS):
        for pair in (pairs[0], pairs[2]):
            chosen.update(row_dots=pair[0], grad=pair[1])
            walls.setdefault(f"fit {'/'.join(pair)}", []).append(
                cs.synced(lambda: cs.estimator(lr_module.LogisticRegression).fit(table))[1])
            walls.setdefault(f"transform {'/'.join(pair)}", []).append(
                cs.synced(lambda: model.transform(table)[0])[1])
    sk._launch = shipped_launch
    summary["wall_ms"] = {}
    for key, ts in walls.items():
        stats = {"median": statistics.median(ts), "min": min(ts), "max": max(ts)}
        summary["wall_ms"][key] = stats
        print(f"wall, {key:27s}: median {stats['median']:.3f} ms, min {stats['min']:.3f}, "
              f"max {stats['max']:.3f} ({len(ts)} runs)", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
