#!/usr/bin/env python3
"""Rehearse chip_smoke.main() on the CPU, at small sizes, in seconds.

    python3 scripts/rehearse_chip_smoke.py      # from the repository root

It runs every phase and gate of chip_smoke.py with the port on the CPU
(`config.use_device("cpu")`) and `torch.cuda` stubbed: the card is
reported present, CUDA events time with the host clock, the builds, the
SASS and register reads, the profiler passes and `nvidia-smi` are skipped,
the floor probes are emulated in torch, the replaced designs of
`csrc/designs.cu` are the plain versions, the card has 132 SMs, the
gradient's walk counters (`sparse_grad_walk`) are the plain gradient
with the counts the table-overflow case asks for (the CPU has no walk),
and each call of a kernel's plain version counts as a launch, as the
kernel's does on the card. The fused transforms of phase 11 run on CPU
tensors, where a fused segment calls its stages' kernels in turn with no
capture (a CUDA graph exists only on the card), so each call counts its
launches as a replay does there. Phase 14's whole fits run through the
program funnel's CPU path (a new signature counted as a capture, the
function run eagerly), and its bank children are real child processes
on the CPU (no stub reaches them; the CPU banks no fused segment), as is
phase 18's examples child (under `use_device("cpu")`, each call of a
kernel's plain version counted as a launch). It catches
a broken path, check or output line before a chip run; every number it
prints is a CPU number and none stands for the card's.
"""

from __future__ import annotations

import os
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flink_ml_tpu_torch import config  # noqa: E402
from flink_ml_tpu_torch.ops import cuda_build  # noqa: E402
from flink_ml_tpu_torch.ops import sparsekernels as sk  # noqa: E402
from flink_ml_tpu_torch.utils import lazyjit  # noqa: E402

#: the rehearsal's sizes: chip_smoke's module constants, cut down
SIZES = dict(
    DEVICE="cpu", DENSE_ROWS=40_000, DIM=8, SPARSE_ROWS=4_000, SPARSE_DIM=5_000, BATCH=1_000,
    KMEANS_ROWS=4_000, PIPELINE_ROWS=4_000, WIDE_SHAPE=(4, 50, 64), STREAM_CHUNK=3_000,
    KMEANS_CHUNK=500, STREAM_CACHE_BUDGET=1 << 30, FEATURE_ROWS=20_000, FEATURE_SMALL_ROWS=10_000,
    FEATURE_STREAM_ROWS=20_000, FEATURE_STREAM_CHUNK=3_000, TEXT_ROWS=20_000,
    CV_SHAPE=(20_000, 100, 100), NGRAM_SHAPE=(20_000, 10, 10), SWR_SHAPE=(5_000, 100, 100),
    HTF_SHAPE=(2_000, 20, 1_000), IDF_SHAPE=(20_000, 10), HASHER_ROWS=20_000, REGEX_ROWS=20_000,
    TOKENIZER_ROWS=2_000, INDEXER_ROWS=20_000, HOST_REPLAY_ROWS=2_000,
    NB_SHAPE=(20_000, 10, 5, 2), UFS_SHAPE=(40_000, 100, 10), KNN_SHAPE=(2_000, 50, 2, 5),
    STATS_SHAPE=(20_000, 10), SPLIT_ROWS=20_000, AGG_SHAPE=(300, 100, 10), AGG_BIG_ROWS=600,
    AGG_COUNT_WINDOW=50, SQL_ROWS=200_000, SQL_WHERE_SHAPE=(50_000, 100), SQL_GROUP_ROWS=5_000,
    SQL_SAMPLE_ROWS=2_000, LSH_ROWS=40_000, LSH_JOIN_ROWS=300, WINDOW_ROWS=40_000, WINDOW_COUNT=500,
    SERVE_REQUESTS=400, SERVE_MAX_ROWS=64, SERVE_BUCKETS=(8, 32, 64, 128), ONLINE_REQUESTS=200,
    LIFECYCLE_CANARY_ROWS=32, MESH_BUDGET_ROWS=128, MESH_BUDGET_BATCH=32,
)
#: below 8 of the small stream segments, so the spill twin spills
CACHE_BUDGET = 200 << 10


class _HostEvent:
    """torch.cuda.Event timed with the host clock."""

    def __init__(self, *args, **kwargs):
        self.t = None

    def record(self, *args):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _probes(_cuda_build):
    """The floor probes of csrc/probes.cu, in torch: a sum of the gathered
    coefficients (or of the gathered rows of a (d, 8) table) per lane, and
    a count per column."""
    def gather(idx, coeff):
        flat = idx.reshape(-1)
        pad = torch.full((-flat.numel() % 1024,), -1, dtype=flat.dtype)
        lanes = torch.cat([flat, pad]).reshape(-1, 8, 32, 4)
        picked = coeff[lanes.clamp(0, coeff.shape[0] - 1).long()]
        return torch.where(lanes >= 0, picked, 0.0).sum(dim=(1, 3)).reshape(-1)

    def red(idx, coeff):
        flat = idx.reshape(-1)
        keep = flat[(flat >= 0) & (flat < coeff.shape[0])].long()
        return torch.bincount(keep, minlength=coeff.shape[0]).to(torch.float32)

    def gather8(idx, table):
        return gather(idx, table.sum(dim=1))

    def red8(form, idx, table):
        counts = red(idx, table[:, 0])
        table.copy_(counts[:, None].expand(table.shape))
        if form == 1:
            table[:, 4:] = 0.0
        return table
    return gather, red, gather8, red8


def _designs(plain):
    """The replaced designs of csrc/designs.cu: their plain versions, the
    fleet gradient's in its coeff's layout as the kernels give it."""
    def fleet_grad(indices, values, multiplier, coeff):
        grad = plain["fleet_grad"](indices, values, multiplier, coeff)
        return grad if coeff.is_contiguous() else grad.T.contiguous().T
    return lambda _cuda_build, _sk: (plain["sparse_grad"], plain["fleet_row_dots"], fleet_grad)


def _walk(indices, values, multiplier, coeff):
    """sparse_grad_walk: the plain gradient, and stand-in counts."""
    grad = sk.sparse_grad_plain(indices, values, multiplier, coeff)
    return grad, {"mid_walk_flushes": 1, "overflows": 1, "direct_chunks": 0}


def stub() -> None:
    """Point chip_smoke at the CPU and stub what needs a card."""
    for name, value in SIZES.items():
        setattr(cs, name, value)
    config.datacache_memory_budget_bytes = CACHE_BUDGET
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda *args: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    for name in ("synchronize", "reset_peak_memory_stats", "_sleep", "empty_cache"):
        setattr(torch.cuda, name, lambda *args, **kwargs: None)
    torch.cuda.memory_allocated = lambda *args, **kwargs: 0
    torch.cuda.max_memory_allocated = lambda *args, **kwargs: 0
    torch.cuda.memory_reserved = lambda *args, **kwargs: 0
    torch.cuda.memory._snapshot = lambda *args, **kwargs: {"segments": []}
    lazyjit.capture_stream = lambda: None
    torch.cuda.Event = _HostEvent
    empty = torch.empty
    torch.empty = lambda *args, pin_memory=False, **kwargs: empty(*args, **kwargs)
    cuda_build.load_all = lambda names: None
    sk.build = lambda: None
    sk._sm_count = lambda index: 132
    sk.sparse_grad_walk = _walk
    cs.resource_usage = lambda *args: {}
    cs.check_sass = lambda *args: []
    cs.load_probes = _probes
    cs.load_designs = _designs({"sparse_grad": sk.sparse_grad_plain,
                                "fleet_row_dots": sk.fleet_row_dots_plain,
                                "fleet_grad": sk.fleet_grad_plain})
    cs.profile_run = lambda name, run: run()
    cs.profile_overlap = lambda name, run: (run(), {})[1]
    cs.count_plain_launches(sk)
    cs.subprocess = types.SimpleNamespace(run=lambda *args, **kwargs: types.SimpleNamespace(
        stdout="CPU rehearsal, 0.00 W\n"))


def main() -> int:
    stub()
    with config.use_device("cpu"):
        return cs.main()


if __name__ == "__main__":
    sys.exit(main())
