#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flink_ml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

It needs a CUDA card and exits non-zero without one, and on any failed
phase; it imports nothing of JAX or of the JAX package. Phases:

1. device: the card's name and power limit (nvidia-smi); the build of
   `flink_ml_tpu_torch/csrc/sparse_kernels.cu`, of the floor probes
   `csrc/probes.cu` and of the replaced designs `csrc/designs.cu`, one
   nvcc each, started together; the registers of each kernel (cuobjdump
   -res-usage) and a look at the SASS: both gradients add to device memory
   with RED and never ATOMG, sparse_grad adds in shared memory (ATOMS; its
   forms are printed), fleet_row_dots loads with 128-bit global loads;
2. each kernel against its plain PyTorch version, on seeded inputs with
   -1 padding and indices >= d: at edge shapes, on the index-convention
   probe, at the main path's shapes (the fit batch, 100,000 x 39, and the
   1M-row transform), on Zipf-skewed indices at the fit batch (values on
   a grid of quarters, so the gradient must be exact), on a fit batch
   sliced at an odd row offset (not 16-byte aligned), on a wide row
   (16 x 5000), on a fit batch that overflows the gradient's table (35%
   of its slots on 128 hot columns, so each block's chunks repeat enough
   columns to stay on the table; 15% on the ~1,000 columns that hash into
   8 of its entries, so they find no entry and add with RED; half uniform,
   so each block claims past its flush threshold every two or three
   chunks and adds into the reset table after; quarter-grid values,
   exact; the kernel's own counters must show mid-walk flushes and probe
   overflows and no chunk added without the table), on a tiny d (7 columns
   for the whole fit batch; quarter-grid values, exact) and at the text
   path's fit batch (phase 7). Each gradient case also prints the walk's
   counters (`sparse_grad_walk`: mid-walk flushes, probe overflows, chunks
   added with direct REDs). Each case prints CUDA-event times of the
   kernel, the plain version, one PyTorch library call, the gradient's
   replaced design (the thread-per-slot RED kernel, `csrc/designs.cu`, held
   to the same gate) and, where the batch is aligned, the floor probes (a gather
   per slot; an atomic add per slot), beside the bound from the bytes
   moved. Then the member-batched (fleet) kernels: at edge shapes (one
   member, a tile of 8 and one more) in both layouts of the (N, d)
   operand and member-minor off 16-byte alignment, and at the sparse fleet
   fit's batch (N = 8, 100,000 x 39, d = 1e6), where the row dot must equal
   solo launches bit for bit at N = 1, 8 and 9 in both layouts; their
   times in both layouts, of the row dot's replaced design (the scalar
   loads) in both, of N solo launches, of the plain version, of one
   library call each (embedding_bag over a (d, N) table, index_add_ of
   (B * nnz, N) rows) and of the row dot's probe (two 16-byte loads a slot
   from a (d, 8) table);
3. the main paths, each run as a user runs it (fit -> transform -> save ->
   load -> transform), with the launch counts reset just before each and
   read just after, at the conf/ configurations: LogisticRegression,
   LinearSVC and LinearRegression on dense data (10M x 100, maxIter 20,
   globalBatchSize 100,000, weighted) and on wide sparse data (1M rows,
   dim 1e6, 39 non-zeros per row), each sparse path on both kernels;
   KMeans (1M x 100 uniform, k 10, maxIter 10, seed 2); the Pipeline
   StandardScaler -> OneHotEncoder (arity 10) -> VectorAssembler ->
   LogisticRegression on 1M rows of 100 features; and, on host data made
   from seeded numpy generators, the stream and online paths:
   LogisticRegression on a StreamTable of 10M x 100 rows in chunks of
   65,536 (out of core through the native data cache, built from
   native/src/datacache.cc at first use), KMeans on a StreamTable of its
   1M rows, OnlineLogisticRegression (FTRL) over 10M rows of a planted
   hyperplane (100 versions) and OnlineKMeans over the KMeans rows from
   the KMeans model (10 versions);
4. the results: each dense fit against a float64 numpy replay of the same
   epochs on the same rows and a refit bit for bit, each sparse fit
   against the same fit on the plain loss on the card, the transforms
   against float64 or plain references; KMeans against a float64 Lloyd
   from the same init rows, its assignments against float64 distances
   outside a 1e-4 relative margin, a refit bit for bit; the pipeline's
   scaler against float64 statistics, its one-hot indices against
   numpy's, its LogisticRegression against a float64 replay on the
   assembled matrix; the stream LR against the bounded fit of the rows its
   epochs train and a float64 replay, a fit that spills against its
   in-memory twin bit for bit; the stream KMeans against the float64
   Lloyd; every tenth FTRL version against a float64 replay; every
   OnlineKMeans version against a float64 update; every reloaded model
   predicts identically;
5. warm times: the median of five (LogisticRegression) or three warm fits
   and transforms of each configuration, and a torch.profiler pass over
   one warm dense and sparse LogisticRegression fit, a KMeans fit, a
   sparse transform and a pipeline transform (device time by kernel, the
   device's idle share); two warm runs of each stream and online path
   (ingest and fit; versions a second and the parts of a version timed
   apart) and a profiler pass over each (idle share, upload overlap);
   the seconds of each path and of the whole run;
6. the fifteen numeric feature stages at their conf/ shapes, on data born
   on the card (10M rows; 1M for MinMaxScaler and Bucketizer): each
   fit -> transform -> save -> load -> transform bit for bit, three warm
   fits and transforms, its peak memory and launch counts (0), then a
   float64 replay on the card: exact for the comparisons, selections and
   order statistics (Binarizer, VectorSlicer, Bucketizer, KBins bins and
   edges, VectorIndexer, the MaxAbs and MinMax extremes, the quantiles'
   order statistics, the Imputer median and mode), within 1e-6 of the
   largest replay value for the elementwise and affine stages, within 1e-5
   for DCT, the variances and the Imputer mean. Twins: Imputer median and
   most_frequent on 1% NaN, KBins quantile and kmeans, Bucketizer with NaN
   and out-of-range values under keep and skip, VectorIndexer with three
   categorical columns and unseen values; and the StreamTable fits of
   RobustScaler, KBins quantile and Imputer median on 1M x 10 seeded numpy
   host chunks, each within relativeError x n ranks of the exact
   quantiles. A profiler pass over a few of them;
7. the text path, StopWordsRemover -> HashingTF (2^18 features) -> IDF ->
   LogisticRegression (the conf/ LR params) on a DictTokenMatrix of
   1M x 100 ids born on the card over 1,000 terms (the first 100 English
   stop words) with planted labels: fit -> transform -> save -> load ->
   transform bit for bit, its launch counts equal to the sparse LR path's
   (22 row dots, 20 gradients); StopWordsRemover and HashingTF against
   numpy replays and the IDF values against float32(v) * float32(idf),
   exactly; the fit against the same fit on the plain loss (1e-4);
   accuracy above 0.7; warm times and a profiler pass. Phase 2 holds both
   kernels at its fit batch (100,000 x 100, d = 2^18; the gradient, whose
   ~900 hashed columns each sum ~10,000 float terms, within the float32
   summation bound). Then the nine string and token stages at their conf/
   shapes (CountVectorizer, NGram, StopWordsRemover, HashingTF on token
   matrices born on the card; IDF on 10M x 10 dense; FeatureHasher,
   RegexTokenizer, Tokenizer, StringIndexer on seeded numpy host columns,
   FeatureHasher through native/src/hashkernels.cc built at first use):
   fit -> transform -> save -> load -> transform bit for bit, three warm
   calls, peak memory, launch counts (0), an exact replay (numpy on the
   host, or on the card in integers or float64);
8. the evaluation path: the text path's table split by RandomSplitter
   (0.8, 0.2), the text pipeline fitted on the first part, the second part
   transformed and scored by BinaryClassificationEvaluator (all four
   metrics), then save -> load -> transform -> evaluate bit for bit; its
   launch counts equal to the sparse LR path's (22 row dots, 20
   gradients), the split equal to a numpy replay of the draw row for row,
   the fit within 1e-4 of the plain-loss fit, the metrics within 1e-9 of
   the float64 numpy oracle on the same scores, a held-out AUC above 0.9;
   warm times and a profiler pass. Then the statistics slice at its
   shapes on data born on the card: NaiveBayes (1M x 10, arity 5, labels
   2; model data equal to an integer replay, predictions to the float64
   argmax), UnivariateFeatureSelector (10M x 100, labels 10, ANOVA;
   F-statistics within 1e-4 of a float64 replay, the selection equal but
   for features within 1e-6 of the cut's p-value), Knn (20,000 x 50,
   labels 2, k 5; predictions equal to float64 neighbours outside a 1e-4
   margin), ChiSqTest, ANOVATest and FValueTest (1M x 10, both flatten
   forms; against float64 replays, statistics within 1e-6 relative and
   p-values within 1e-6 of the largest, chi-square counts exact) and RandomSplitter on a dense, a SparseBatch and a
   DictTokenMatrix column (1M rows): each through fit -> transform ->
   save -> load -> transform bit for bit, three warm calls, peak memory,
   launch counts (0), the host paths taken; then functions.py's round
   trips;
8b. the evaluation Graph: RandomSplitter (0.8, 0.2) as a node with two
   outputs, StopWordsRemover and HashingTF on each part, IDF fitted on the
   train part transforming the test part, LogisticRegression (conf/
   params) fitted on the train features transforming the test features,
   BinaryClassificationEvaluator, and a model-data edge from the LR to a
   twin LogisticRegressionModel on the test features, on phase 7's 1M x 100
   ids: Graph.fit -> GraphModel.transform -> save -> load -> transform bit
   for bit; the fit launches 22 row dots and 20 gradients, a transform 2 row
   dots; the LR within 1e-4 of the plain-loss fit, the metrics within 1e-9
   of the float64 oracle and 1e-6 of phase 8's, the twin's predictions
   equal to the LR node's; warm times and a profiler pass;
9. AgglomerativeClustering at conf/ (1000 x 100 uniform, ward, 10
   clusters; the merge loop native/src/agglomerative.cc built at first use)
   with twins (complete, single and average linkage, cosine, a distance
   threshold, the full tree, count and event-time windows, a 10,000-row
   ward run), each against the numpy merge loop exactly (but the
   10,000-row one) and, for the four linkages, against scipy's linkage
   (merge distances 1e-9, the flat partition); SQLTransformer at conf/
   (100M float64 rows, ABS, exact on the card and in a numpy replay of a
   sample) with a WHERE twin (10M rows, 1% NaN, a 100-wide vector column
   passed through; a numpy replay of SQL's three-valued logic) and a
   GROUP BY twin on the sqlite path (against sqlite3); MinHashLSH (5 tables
   x 3 functions, seed 2022) on phase 3's sparse shape with 1% planted
   near-duplicates: the coefficients against a java.util.Random replay, the
   hashes against an int64 numpy replay, the neighbours of 10 planted keys
   and a 10,000 x 10,000 similarity join against set replays; each through
   fit -> transform -> save -> load -> transform bit for bit, warm calls,
   peak memory, launch counts (0); then window_all_and_process over 1M rows
   (count, event-time tumbling and session windows) against numpy
   groupings;
10. FitFleet and the reference-format loader: a sparse LR fleet of 8
   members (learningRate {0.1, 0.05} x reg {0, 1e-3} x elasticNet
   {0, 0.5}, the last at maxIter 10; conf/ LR params) on phase 3's sparse
   table, which must launch 20 fleet row dots and 20 fleet gradients and
   no solo kernel, each member held against the same fleet on the plain
   versions on the card (1e-4 of its coefficients' scale, plus one L1 step
   on each side of 0 where elasticNet * reg > 0; its loss within 1e-3,
   its epochs equal), its gap from its solo kernel fit printed; a dense LR
   fleet of the same 8 members on phase 3's weighted 10M x 100 table, each
   member within 1e-3 of a float64 replay of its own epochs (with its
   proximal steps) and a refit bit for bit; a KMeans fleet (1M x 100,
   k 10, seeds 2-5, the last at maxIter 5), each member within 1e-3 of a
   float64 Lloyd from its init rows; a stream LR fleet of 4 members on the
   stream LR's 10M x 100 host rows in 100,000-row chunks, against the dense
   fleet on the rows its epochs train (bits expected, gate 1e-6); warm
   medians of three fleet fits beside the members' solo fits, peak memory
   and a profiler pass over a sparse fleet fit. Then the reference format:
   the sparse fleet's members scored by areaUnderROC, the winner and the
   KMeans fleet's first member written in the reference's binary layout
   with the port's encoders, loaded through load_stage and applied to the
   full tables (the winner on one solo row dot), bit for bit as the same
   model saved and loaded as npz; every committed tests/fixtures/
   reference_* directory loaded and applied on the card to the values the
   tests expect, and round-tripped through npz bit for bit;
11. a `kernels` JSON line (four kernels), then the result line.
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
LINREG_LEARNING_RATE = 0.01  # conf/linearregression-benchmark.json
KMEANS_ROWS, KMEANS_K, KMEANS_ITER, KMEANS_SEED = 1_000_000, 10, 10, 2  # conf/kmeans-benchmark.json
PIPELINE_ROWS, ARITY, PIPELINE_SEED = 1_000_000, 10, 7  # conf/standardscaler-, onehotencoder-benchmark.json
# the stream and online paths: host chunks of this many rows (not a multiple
# of the batch, so the remainder carries from chunk to chunk)
STREAM_CHUNK, KMEANS_CHUNK = 65_536, 62_500
STREAM_SEED, ONLINE_SEED, HELD_OUT_SEED = 13, 17, 19
STREAM_CACHE_BUDGET = 8 << 30  # holds the stream LR's 100 packed segments, 4.08 GB
SPILL_BATCHES = 8  # the spill twin: 8 segments against the default 64 MiB budget
ONLINE_REG, ONLINE_ELASTIC_NET = 0.01, 0.5  # both FTRL's l1 and l2 terms act
ONLINE_KMEANS_DECAY = 0.5
# FTRL zeroes a coordinate when |z| <= l1: one whose float64 |z| lies within
# this share of l1 from l1 may go either way in float32, and is not gated
NEAR_L1_SHARE = 1e-3
# KMeans near ties (the KMeans path's rule): points whose two nearest float64
# distances differ by at most this share are not gated
TIE_MARGIN = 1e-4
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
#: the kernels whose launches the paths count (flink_ml_tpu_torch/ops/sparsekernels.py KERNELS)
KERNEL_NAMES = ("sparse_row_dots", "sparse_grad", "fleet_row_dots", "fleet_grad")


def launch_dict(**counts):
    """Launch counts of every kernel: the ones given, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


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
TINY_D = 7  # the tiny-d case: every slot of the fit batch on one of 7 columns
# the table-overflow case: HOT_SHARE of the slots on HOT_COLUMNS columns,
# CROWD_SHARE on the columns whose hashed table entry is one of the first
# CROWDED_ENTRIES, the rest uniform
HOT_SHARE, HOT_COLUMNS = 0.35, 128
CROWD_SHARE, CROWDED_ENTRIES = 0.15, 8


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
    return mask_slots(gen, idx, d), quarter_grid(gen, (rows, nnz), dev)


def quarter_grid(gen, shape, dev, signed=False):
    """Values on a grid of quarters (0..1, or -1..1 with `signed`): every
    partial sum of their products is exact in float32 below 2^20."""
    low = -4 if signed else 0
    return torch.randint(low, 5, shape, generator=gen, device=dev).to(torch.float32) / 4


def mask_slots(gen, idx, d):
    """`sparse_batch`'s padding and indices >= d on given columns."""
    u = torch.rand(idx.shape, generator=gen, device=idx.device)
    idx = torch.where(u < DEFAULT_MASK_SHARE, -1, idx)
    return torch.where(u > 1.0 - OUT_OF_RANGE_SHARE, d + idx % 5, idx).to(torch.int32).contiguous()


def crowded_batch(gen, rows, nnz, d, table, dev):
    """sparse_grad's table overflowing both ways while its blocks stay on
    it. HOT_SHARE of the slots on HOT_COLUMNS random columns: after a
    chunk's first, their slots find their entry, a quarter of every chunk,
    above the 1/8 of repeats below which a block leaves the table.
    CROWD_SHARE on the ~d * CROWDED_ENTRIES / table columns whose hashed
    entry (the kernel's multiplicative hash into `table` entries) is one of
    the first CROWDED_ENTRIES: all but the few that claim an entry within
    reach find none and add with their own RED. The rest uniform over d:
    about half of a chunk's slots claim a new entry, so at the fit batch's
    plan (chunks of 1856 slots, flush at 2048 claims) a block flushes
    every two or three chunks and then adds into the reset table. Values
    on the quarter grid: the sums are exact. Returns (idx, vals, the
    number of crowded columns)."""
    cols = torch.arange(d, device=dev, dtype=torch.int64)
    home = ((cols * 2654435761) & 0xFFFFFFFF) >> (32 - (table.bit_length() - 1))
    crowd = cols[home < CROWDED_ENTRIES]
    hot = torch.randperm(d, generator=gen, device=dev)[:HOT_COLUMNS]
    shape = (rows, nnz)
    pick_hot = hot[torch.randint(0, HOT_COLUMNS, shape, generator=gen, device=dev)]
    pick_crowd = crowd[torch.randint(0, crowd.numel(), shape, generator=gen, device=dev)]
    spread = torch.randint(0, d, shape, generator=gen, device=dev)
    u = torch.rand(shape, generator=gen, device=dev)
    mixed = torch.where(u < HOT_SHARE, pick_hot,
                        torch.where(u < HOT_SHARE + CROWD_SHARE, pick_crowd, spread))
    return mask_slots(gen, mixed, d), quarter_grid(gen, shape, dev), int(crowd.numel())


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


SASS_KERNEL = re.compile(r"\d(sparse_grad|fleet_grad|fleet_row_dots|row_dots)_kernel")


def check_sass(cuda_build):
    """What the compiler made of the kernels (cuobjdump -sass): every
    global add of the gradients must be RED (REDG on Hopper), not ATOMG,
    which waits for the old value; sparse_grad must add in shared memory
    (ATOMS: its claims and its table's float adds, whose form is printed);
    fleet_row_dots must load with 128-bit global loads (its float4 member
    loads). Returns the ATOMS forms of sparse_grad."""
    sass = cuobjdump(cuda_build, "sparse_kernels", "-sass")
    opcode = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)((?:\.[A-Z0-9_]+)*)")
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            match = SASS_KERNEL.search(mangled)
            kernel = f"{match.group(1)}_kernel {mangled}" if match else mangled
            counts[kernel] = {"RED": 0, "ATOMG": 0, "ATOMS": 0, "LDG128": 0, "atoms_forms": set()}
            continue
        match = opcode.search(line)
        if kernel is None or not match:
            continue
        op, mods = match.groups()
        ops = counts[kernel]
        if op in ("RED", "REDG", "ATOMG"):
            ops["ATOMG" if op == "ATOMG" else "RED"] += 1
        elif op == "ATOMS":
            ops["ATOMS"] += 1
            ops["atoms_forms"].add(op + mods)
        elif op == "LDG" and ".128" in mods:
            ops["LDG128"] += 1
    forms = set()
    for kernel, ops in counts.items():
        ops["atoms_forms"] = sorted(ops["atoms_forms"])
        log(f"  sass {kernel}: {ops}")
        name = kernel.split()[0]
        if name in ("sparse_grad_kernel", "fleet_grad_kernel"):
            check(ops["RED"] > 0 and ops["ATOMG"] == 0,
                  f"{kernel} adds to device memory with {ops}, not RED")
        if name == "sparse_grad_kernel":
            check(ops["ATOMS"] > 0, f"{kernel} has no shared atomics: {ops}")
            forms.update(ops["atoms_forms"])
        if name == "fleet_row_dots_kernel":
            check(ops["LDG128"] > 0, f"{kernel} has no 128-bit global loads: {ops}")
    names = {k.split()[0] for k in counts}
    check({"sparse_grad_kernel", "fleet_grad_kernel", "fleet_row_dots_kernel"} <= names,
          f"kernels missing from the SASS: {sorted(names)}")
    log(f"  sparse_grad's shared atomics: {sorted(forms)}")
    return sorted(forms)


def load_probes(cuda_build):
    """csrc/probes.cu: the floors of random L2 access that the kernels meet:
    (gather, red, gather8)."""
    import ctypes

    lib = cuda_build.load("probes")
    for fn in (lib.fmt_probe_gather, lib.fmt_probe_gather8):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fmt_probe_red.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.fmt_probe_red.restype = ctypes.c_int

    def gather_with(fn, what):
        def gather(idx, coeff):
            n = idx.numel()
            out = torch.empty(-(-n // 1024) * 32, device=idx.device)
            err = fn(idx.data_ptr(), coeff.data_ptr(), out.data_ptr(), n, coeff.shape[0],
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{what} probe launch failed with CUDA error {err}")
            return out
        return gather

    def red(idx, coeff):
        counts = torch.zeros_like(coeff)
        err = lib.fmt_probe_red(idx.data_ptr(), counts.data_ptr(), idx.numel(), coeff.shape[0],
                                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"RED probe launch failed with CUDA error {err}")
        return counts

    return gather_with(lib.fmt_probe_gather, "gather"), red, gather_with(lib.fmt_probe_gather8, "gather8")


def load_designs(cuda_build, sk):
    """csrc/designs.cu: the designs that this port's kernels replaced, on
    the plans they ran with: (red_grad, scalar_fleet_row_dots), called as
    sparse_grad and fleet_row_dots are."""
    import ctypes

    lib = cuda_build.load("designs")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fmt_red_grad.argtypes = [vp] * 4 + [ll, i32, ll, i32, i32, vp]
    lib.fmt_scalar_fleet_row_dots.argtypes = [vp] * 4 + [ll, i32, ll, i32, ll, ll, i32, i32, vp]
    lib.fmt_red_grad.restype = lib.fmt_scalar_fleet_row_dots.restype = i32

    def red_grad(idx, vals, mult, coeff):
        grad = torch.zeros_like(coeff)
        plan = sk._launch_plan(*idx.shape, True)
        err = lib.fmt_red_grad(idx.data_ptr(), vals.data_ptr(), mult.data_ptr(), grad.data_ptr(),
                               *idx.shape, coeff.shape[0], *plan, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"fmt_red_grad launch failed with CUDA error {err}")
        return grad

    def scalar_fleet_row_dots(idx, vals, coeff):
        out = torch.empty((coeff.shape[0], idx.shape[0]), device=idx.device)
        plan = sk._launch_plan(*idx.shape)
        err = lib.fmt_scalar_fleet_row_dots(
            idx.data_ptr(), vals.data_ptr(), coeff.data_ptr(), out.data_ptr(), *idx.shape,
            coeff.shape[1], coeff.shape[0], *sk._fleet_strides(coeff), *plan,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"fmt_scalar_fleet_row_dots launch failed with CUDA error {err}")
        return out

    return red_grad, scalar_fleet_row_dots


def check_probes(gather, red, idx, coeff):
    """The probes compute something checkable: a sum of the gathered
    coefficients per lane, and a count per column (gather8: see
    `check_gather8`)."""
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


def check_gather8(gather8, idx, table):
    """The gather8 probe sums the 8 values of each gathered row of a (d, 8)
    table per lane."""
    d = table.shape[0]
    flat = idx.reshape(-1)
    pad = torch.full((-flat.numel() % 1024,), -1, dtype=flat.dtype, device=flat.device)
    lanes = torch.cat([flat, pad]).reshape(-1, 8, 32, 4)
    rows = table.sum(dim=1)[lanes.clamp(0, d - 1).long()]
    want = torch.where(lanes >= 0, rows, 0.0).sum(dim=(1, 3))
    check(torch.allclose(gather8(idx, table), want.reshape(-1), **ROW_DOTS_TOL),
          "the gather8 probe's sums disagree")


def summation_bound(idx, vals, mult, d):
    """Per column c, 2 * n_c * 2^-24 * sum |vals * mult| over its n_c slots:
    twice the worst-case error of a float32 sum of the same n_c products
    in any order, so the largest gap two orders may show."""
    keep = (idx >= 0) & (idx < d)
    flat = torch.where(keep, idx, 0).long().reshape(-1)
    mag = torch.where(keep, (vals * mult[:, None]).abs(), 0.0).double().reshape(-1)
    total = torch.zeros(d, dtype=torch.float64, device=idx.device).index_add_(0, flat, mag)
    count = torch.bincount(flat[keep.reshape(-1)], minlength=d).double()
    return 2.0 * count * 2.0**-24 * total


def measure_case(sk, probes, designs, label, idx, vals, coeff, mult, sets, exact_grad=False,
                 grad_bound=False):
    """Both kernels on one batch: held against their plain versions, and
    timed with the plain versions, one library call each, the gradient's
    replaced design (`fmt_red_grad`, held to the same gate) and, where the
    batch is aligned, the probes. `sets` are copies of (idx, vals) that
    rotate through the timed calls. With `grad_bound`, the gradient is held
    to `summation_bound` instead of GRAD_TOL: on columns that sum thousands
    of float values, cancellation leaves GRAD_TOL's rtol no scale."""
    rows, nnz = idx.shape
    d = coeff.shape[0]
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).clamp(max=d - 1)
    masked_vals = torch.where(valid, vals, 0.0)
    keep = valid & (idx < d)
    batch_bytes = idx.numel() * 4 + vals.numel() * 4
    probe_ms = {}
    if idx.data_ptr() % 16 == 0 and idx.numel() % 4 == 0 and probes is not None:
        gather, red, _ = probes
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

    red_grad = designs[0]
    want = sk.sparse_grad_plain(idx, vals, mult, coeff)
    bound = summation_bound(idx, vals, mult, d) if grad_bound else None
    errs = {}
    for name, fn in (("sparse_grad", sk.sparse_grad), ("fmt_red_grad", red_grad)):
        got = fn(idx, vals, mult, coeff)
        err = errs[name] = (got - want).abs()
        if grad_bound:
            check(bool((err.double() <= bound).all()),
                  f"{name} exceeds the summation bound on {label}: max abs {float(err.max())}, "
                  f"largest share of the bound {float((err.double() / bound.clamp_min(1e-300)).max())}")
        else:
            check(torch.allclose(got, want, **GRAD_TOL),
                  f"{name} disagrees with its plain version on {label}: max abs {float(err.max())}")
        if exact_grad:
            check(torch.equal(got, want), f"{name} is not exact on {label}'s exact sums")
    got, walk = sk.sparse_grad_walk(idx, vals, mult, coeff)
    if grad_bound:
        check(bool(((got - want).abs().double() <= bound).all()),
              f"sparse_grad_walk exceeds the summation bound on {label}")
    else:
        check(torch.allclose(got, want, **GRAD_TOL),
              f"sparse_grad_walk disagrees with its plain version on {label}")
    if exact_grad:
        check(torch.equal(got, want), f"sparse_grad_walk is not exact on {label}'s exact sums")
    err = errs["sparse_grad"]
    flat_idx = torch.where(keep, idx, 0).long().reshape(-1)
    contrib = torch.where(keep, vals * mult[:, None], 0.0).reshape(-1)
    b_ms, b_by = bound_ms(batch_bytes + rows * 4 + d * 4, 2.0 * int(keep.sum()))
    msets = [(i, v, mult) for i, v in sets]
    results["sparse_grad"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "ms": cuda_ms(lambda i, v, m: sk.sparse_grad(i, v, m, coeff), msets),
        "replaced_ms": cuda_ms(lambda i, v, m: red_grad(i, v, m, coeff), msets),
        "enqueue_ms": cuda_ms(lambda i, v, m: sk.sparse_grad(i, v, m, coeff), msets, ahead=False),
        "plain_ms": cuda_ms(lambda i, v, m: sk.sparse_grad_plain(i, v, m, coeff), msets, iters=10),
        "library_ms": cuda_ms(lambda fi, c: torch.zeros_like(coeff).index_add_(0, fi, c),
                              [(flat_idx, contrib)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by, "walk": walk,
    }
    results["sparse_row_dots"]["tolerance"] = ROW_DOTS_TOL
    results["sparse_grad"]["tolerance"] = (
        "per column 2 n_c 2^-24 sum |v m| (summation_bound)" if grad_bound else GRAD_TOL)
    for name, r in results.items():
        r.update(case=label, rows=rows, nnz=nnz, d=d, probe_ms=probe_ms.get(name))
        probe = f", probe {r['probe_ms']:.4f} ms" if r["probe_ms"] is not None else ""
        replaced = f", replaced design {r['replaced_ms']:.4f} ms" if "replaced_ms" in r else ""
        log(f"  {name} {label} ({rows} x {nnz}, d={d}): max_abs_err "
            f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms (enqueue-bound {r['enqueue_ms']:.4f})"
            f"{replaced}, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){probe}"
            + (f"; walk {r['walk']}" if "walk" in r else ""))
    return results


def copies(idx, vals, offset=0):
    """(idx, vals) and enough copies of it to exceed L2 several times; with
    `offset`, each copy is the same row slice of a fresh copy of the larger
    tensor, so its base keeps its alignment."""
    n = copies_for(idx.numel() * 8)
    return [(idx[offset:], vals[offset:])] + [
        (idx.clone()[offset:], vals.clone()[offset:]) for _ in range(n - 1)]


def kernel_phase(sk, probes, designs, dev):
    """Each kernel against its plain version at the main path's shapes
    (the fit batch and the 1M-row transform), on skewed indices, on a
    misaligned row slice, on a wide row, on a batch that overflows the
    gradient's table, on a tiny d and at the text path's fit batch; the
    floor probes and the gradient's replaced design beside them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    coeff = torch.randn(SPARSE_DIM, generator=gen, device=dev)
    results = {"sparse_row_dots": [], "sparse_grad": []}

    def run(label, idx, vals, c, mult, sets, exact_grad=False, grad_bound=False):
        res = measure_case(sk, probes, designs, label, idx, vals, c, mult, sets, exact_grad,
                           grad_bound)
        for name in results:
            results[name].append(res[name])
        return res

    for label, rows in (("fit batch", BATCH), ("transform", SPARSE_ROWS)):
        idx, vals = sparse_batch(gen, rows, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
        mult = torch.randn(rows, generator=gen, device=dev)
        run(label, idx, vals, coeff, mult, copies(idx, vals))
        del idx, vals

    idx, vals = zipf_batch(gen, BATCH, NNZ, SPARSE_DIM, dev)
    mult = quarter_grid(gen, (BATCH,), dev, signed=True)
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
    del idx, vals

    plan = sk._grad_plan(BATCH, NNZ, sk._sm_count(dev.index or 0))
    idx, vals, crowd = crowded_batch(gen, BATCH, NNZ, SPARSE_DIM, plan.table, dev)
    log(f"  table overflow: {HOT_SHARE} of the slots on {HOT_COLUMNS} hot columns, "
        f"{CROWD_SHARE} on the {crowd} columns hashed to {CROWDED_ENTRIES} of {plan.table} "
        f"entries, the rest uniform; {plan.grid} blocks")
    mult = quarter_grid(gen, (BATCH,), dev, signed=True)
    walk = run("table overflow", idx, vals, coeff, mult, copies(idx, vals),
               exact_grad=True)["sparse_grad"]["walk"]
    check(walk["mid_walk_flushes"] > 0 and walk["overflows"] > 0 and walk["direct_chunks"] == 0,
          f"the table-overflow case does not run the table's flush and overflow paths: {walk}")
    del idx, vals

    idx = mask_slots(gen, torch.randint(0, TINY_D, (BATCH, NNZ), generator=gen, device=dev), TINY_D)
    vals = quarter_grid(gen, (BATCH, NNZ), dev)
    mult = quarter_grid(gen, (BATCH,), dev, signed=True)
    run("tiny d", idx, vals, coeff[:TINY_D].contiguous(), mult, copies(idx, vals), exact_grad=True)
    del idx, vals

    # the text path's fit batch: its own features (HashingTF -> IDF of the
    # corpus' first BATCH rows, d = 2^18, so the coefficients fit in L2).
    # Its ~90 slots a row fall on ~900 hashed columns, ~10,000 float terms
    # a column: the gradient is held to the summation bound
    idx, vals, d = text_fit_batch(dev)
    text_coeff = torch.randn(d, generator=gen, device=dev)
    mult = torch.randn(idx.shape[0], generator=gen, device=dev)
    run("text fit batch", idx, vals, text_coeff, mult, copies(idx, vals), grad_bound=True)
    exact = sk.sparse_grad_plain(idx, vals.double(), mult.double(), text_coeff.double())
    log(f"  text fit batch (not a gate): gradient max abs error against float64 "
        f"{float((sk.sparse_grad(idx, vals, mult, text_coeff).double() - exact).abs().max()):.3g} "
        f"(kernel), {float((sk.sparse_grad_plain(idx, vals, mult, text_coeff).double() - exact).abs().max()):.3g} "
        f"(plain); largest |g| {float(exact.abs().max()):.4g}")
    return results


def _logistic64(dot, y, w):
    margin = dot * (2.0 * y - 1.0)
    return w * np.logaddexp(0.0, -margin), w * (-(2.0 * y - 1.0) / (np.exp(margin) + 1.0))


def _hinge64(dot, y, w):
    margin = 1.0 - (2.0 * y - 1.0) * dot
    return w * np.maximum(margin, 0.0), np.where(margin > 0.0, -(2.0 * y - 1.0) * w, 0.0)


def _least_square64(dot, y, w):
    diff = dot - y
    return w * 0.5 * diff * diff, w * diff


#: loss name -> its pointwise (dot, y, w) -> (per-row loss, multiplier), float64
POINTWISE64 = {"binary_logistic": _logistic64, "hinge": _hinge64, "least_square": _least_square64}


def numpy_reference_sgd(batch_rows, num_batches, max_iter, lr, tol, pointwise=_logistic64,
                        reg=0.0, elastic_net=0.0):
    """The reference's SGD semantics (SGD.java:82-292,
    TerminateOnMaxIterOrTol.java, RegularizationUtils.java) in float64
    numpy, on weighted batches `batch_rows(k) -> (X, y, w)` and a pointwise
    loss: batch k = epoch mod num_batches, the first epoch computes a
    gradient before any update, each update followed by the proximal step
    where reg > 0, one extra update after the loop. Returns (coeff, loss,
    epochs)."""
    def update(coeff, grad):
        coeff = coeff - (lr / wsum) * grad
        if reg > 0:
            coeff = coeff - lr * (elastic_net * reg * np.sign(coeff)
                                  + (1.0 - elastic_net) * reg * coeff)
        return coeff

    coeff = grad = None
    wsum, loss, epoch = 0.0, np.inf, 0
    while epoch < max_iter and loss > tol:
        Xk, yk, wk = batch_rows(epoch % num_batches)
        if coeff is None:
            coeff = np.zeros(Xk.shape[1])
            grad = np.zeros(Xk.shape[1])
        if wsum > 0:
            coeff = update(coeff, grad)
        row_loss, mult = pointwise(Xk @ coeff, yk, wk)
        grad = Xk.T @ mult
        wsum = float(np.sum(wk))
        loss = float(np.sum(row_loss)) / max(wsum, 1e-30)
        epoch += 1
    if wsum > 0:
        coeff = update(coeff, grad)
    return coeff, loss, epoch


def sigmoid64(z):
    return 1.0 - 1.0 / (1.0 + np.exp(z))


def estimator(cls, weight_col=None, learning_rate=LEARNING_RATE):
    est = (
        cls()
        .set_max_iter(MAX_ITER)
        .set_learning_rate(learning_rate)
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


def drive(fit, table, tmp, name):
    """One path as a user runs it: fit -> transform -> save -> load ->
    transform. Returns what phase 4 checks and the first calls' times."""
    model, fit_ms = synced(fit)
    out, transform_ms = synced(lambda: model.transform(table)[0])
    from flink_ml_tpu_torch.api import Stage

    path = os.path.join(tmp, name)
    model.save(path)
    with open(os.path.join(path, "metadata")) as f:
        class_name = json.load(f)["className"]
    loaded = Stage.load(path)
    again = loaded.transform(table)[0]
    torch.cuda.synchronize()
    return {"model": model, "out": out, "fit_ms": fit_ms, "transform_ms": transform_ms,
            "class_name": class_name, "loaded": loaded, "again": again}


def same_column(a, b) -> bool:
    """Bit for bit: tensors, host arrays, object columns of token lists,
    SparseBatches (indices, values, size) and DictTokenMatrix columns
    (vocabulary and ids)."""
    from flink_ml_tpu_torch.table import DictTokenMatrix, SparseBatch

    if isinstance(a, SparseBatch):
        return (isinstance(b, SparseBatch) and a.size == b.size
                and same_column(a.indices, b.indices) and same_column(a.values, b.values))
    if isinstance(a, DictTokenMatrix):
        return (isinstance(b, DictTokenMatrix) and np.array_equal(a.vocab, b.vocab)
                and same_column(a.ids, b.ids))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray) and a.dtype == object:
        if len(a) and isinstance(a[0], list) and a[0] and isinstance(a[0][0], np.ndarray):
            # per-row lists of equal-length arrays (MinHashLSH's hashes)
            return len(a) == len(b) and np.array_equal(np.array(a.tolist()), np.array(b.tolist()))
        return len(a) == len(b) and all(list(x) == list(y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def check_reload(name, run, java_class, columns):
    check(run["class_name"] == java_class, f"{name} model saved as {run['class_name']}")
    check(type(run["loaded"]) is type(run["model"]), f"{name} model reload type")
    for col in columns:
        check(same_column(run["again"].column(col), run["out"].column(col)),
              f"{name} {col} differs after save/load")


#: the linear paths: name -> (estimator module, class, loss, learning rate,
#: the Java class name the model is saved as), at the conf/ configurations
LINEAR_PATHS = {
    "lr": ("classification.logisticregression", "LogisticRegression", "binary_logistic",
           LEARNING_RATE, "org.apache.flink.ml.classification.logisticregression.LogisticRegressionModel"),
    "svc": ("classification.linearsvc", "LinearSVC", "hinge", LEARNING_RATE,
            "org.apache.flink.ml.classification.linearsvc.LinearSVCModel"),
    "linreg": ("regression.linearregression", "LinearRegression", "least_square",
               LINREG_LEARNING_RATE,
               "org.apache.flink.ml.regression.linearregression.LinearRegressionModel"),
}


def linear_class(name):
    import importlib

    module, cls, *_ = LINEAR_PATHS[name]
    return getattr(importlib.import_module("flink_ml_tpu_torch.models." + module), cls)


def raw_dots(name, out):
    """The raw dot a linear model's transform gives: LR's probability is
    sigmoid(dot), LinearSVC's rawPrediction[:, 0] is dot, LinearRegression's
    prediction is dot."""
    if name == "lr":
        return out.column("rawPrediction")[:, 1]
    if name == "svc":
        return out.column("rawPrediction")[:, 0]
    return out.column("prediction")


def check_dense_linear(name, run, dense_table, X64, y64, w64):
    """A dense fit against a float64 numpy replay of the same epochs on the
    same rows, a refit bit for bit, and the transform against float64."""
    from flink_ml_tpu_torch.models import _linear
    from flink_ml_tpu_torch.ops import losses

    _, cls, loss_name, lr, _ = LINEAR_PATHS[name]
    num_batches = DENSE_ROWS // BATCH
    ref_coeff, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                   w64[k * BATCH:(k + 1) * BATCH]),
        num_batches, MAX_ITER, lr, TOL, POINTWISE64[loss_name],
    )
    dense_loss = {"binary_logistic": losses.BINARY_LOGISTIC_LOSS, "hinge": losses.HINGE_LOSS,
                  "least_square": losses.LEAST_SQUARE_LOSS}[loss_name]
    coeff, loss, epochs = _linear.run_sgd(
        estimator(linear_class(name), "weight", lr), dense_table, dense_loss, "weight",
        validate_binomial=name != "linreg",
    )
    model = run["model"]
    rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    coeff_rel = float(np.max(np.abs(model.coefficient - ref_coeff)) / np.max(np.abs(ref_coeff)))
    log(f"  dense {name} loss {loss:.8f} vs float64 replay {ref_loss:.8f}: relDiff {rel:.3g}; "
        f"epochs {epochs} vs {ref_epochs}; coeff max rel {coeff_rel:.3g}")
    check(rel < LOSS_REL_TOL, f"dense {name} loss relDiff {rel} >= {LOSS_REL_TOL}")
    check(epochs == ref_epochs, f"dense {name} epoch count differs from the replay")
    check(coeff_rel < 1e-3, f"dense {name} coefficients differ from the replay by {coeff_rel}")
    check(np.array_equal(coeff, model.coefficient), f"dense {name} refit is not bit-identical")

    out = run["out"]
    pred = out.column("prediction")
    check(pred.shape == (DENSE_ROWS,) and bool(torch.isfinite(pred).all()), f"dense {name} transform")
    if name != "linreg":
        check(out.column("rawPrediction").shape == (DENSE_ROWS, 2), f"dense {name} raw shape")
    dot64 = X64[:BATCH] @ model.coefficient.astype(np.float64)
    got = raw_dots(name, out)[:BATCH].double().cpu().numpy()
    want = sigmoid64(dot64) if name == "lr" else dot64
    err = float(np.max(np.abs(got - want)))
    bound = 1e-5 * max(1.0, float(np.max(np.abs(want))))
    clear = np.abs(dot64) > 1e-4
    pred_ok = name == "linreg" or np.array_equal(
        pred[:BATCH].cpu().numpy()[clear], (dot64 >= 0)[clear].astype(np.float32))
    log(f"  dense {name} transform vs float64: max abs err {err:.3g} (bound {bound:.3g}), "
        f"predictions agree {pred_ok}")
    check(err < bound and pred_ok, f"dense {name} transform disagrees with the float64 reference")


def check_sparse_linear(name, run, s_idx, s_vals, s_y, dim=None):
    """A sparse fit on the kernels against the same fit on the plain loss
    on the card, and the transform against the plain row dots; `dim` is
    the feature count (SPARSE_DIM unless given)."""
    from flink_ml_tpu_torch.models.classification import linearsvc
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import losses
    from flink_ml_tpu_torch.ops import sparsekernels as sk
    from flink_ml_tpu_torch.ops.optimizer import SGD

    _, _, loss_name, lr, _ = LINEAR_PATHS[name]
    sgd = SGD(max_iter=MAX_ITER, learning_rate=lr, global_batch_size=BATCH, tol=TOL)
    dim = SPARSE_DIM if dim is None else dim
    c_k, loss_k, ep_k = sgd.optimize(np.zeros(dim), (s_idx, s_vals), s_y, None,
                                     losses.SPARSE_VARIANTS[loss_name])
    c_p, loss_p, ep_p = sgd.optimize(np.zeros(dim), (s_idx, s_vals), s_y, None,
                                     losses.PLAIN_SPARSE_VARIANTS[loss_name])
    model = run["model"]
    rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    scale = float(np.max(np.abs(c_p)))
    coeff_err = float(np.max(np.abs(c_k - c_p)))
    model_err = float(np.max(np.abs(model.coefficient - c_p)))
    log(f"  sparse {name} loss {loss_k:.8f} (kernels) vs {loss_p:.8f} (plain): relDiff {rel:.3g}; "
        f"coeff max abs diff {coeff_err:.3g} and {model_err:.3g} (fit) of max |coeff| {scale:.3g}")
    check(rel < LOSS_REL_TOL, f"sparse {name} loss relDiff {rel} >= {LOSS_REL_TOL}")
    check(ep_k == ep_p, f"sparse {name} epoch counts differ")
    # atomics reorder float32 sums: hold coefficients to 1e-4 of their scale
    check(coeff_err <= 1e-4 * scale and model_err <= 1e-4 * scale,
          f"sparse {name} coefficients differ from the plain-loss fit")
    coeff = torch.as_tensor(model.coefficient, device=s_idx.device)
    plain = sk.sparse_row_dots_plain(s_idx, s_vals, coeff)
    out = run["out"]
    if name == "lr":
        got, want, tol = out.column("rawPrediction"), logisticregression._predict_from_dot(plain)[1], \
            dict(rtol=1e-5, atol=1e-6)
    elif name == "svc":
        got, want, tol = out.column("rawPrediction"), linearsvc._predict_from_dot(plain, 0.0)[1], \
            ROW_DOTS_TOL
    else:
        got, want, tol = out.column("prediction"), plain, ROW_DOTS_TOL
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"sparse {name} transform shape")
    check(torch.allclose(got, want, **tol), f"sparse {name} transform disagrees with plain")


def kmeans_data(dev):
    """conf/kmeans-benchmark.json's input: DenseVectorGenerator's uniform
    [0, 1) vectors, 1M x 100, born on the card from a seeded generator."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(KMEANS_SEED)
    return torch.rand((KMEANS_ROWS, DIM), generator=gen, device=dev)


def kmeans_estimator():
    from flink_ml_tpu_torch.models.clustering import kmeans

    return kmeans.KMeans().set_k(KMEANS_K).set_max_iter(KMEANS_ITER).set_seed(KMEANS_SEED)


def lloyd64(X64, init, max_iter):
    """Lloyd's algorithm in float64, written apart from the port: direct
    distances (cdist without the matmul form), a scatter-add of the cells'
    sums. Returns (centroids, counts) on X64's device."""
    centroids = init.clone()
    k = init.shape[0]
    counts = None
    for _ in range(max_iter):
        assign = torch.cat([
            torch.argmin(torch.cdist(X64[i:i + 100_000], centroids,
                                     compute_mode="donot_use_mm_for_euclid_dist"), dim=1)
            for i in range(0, X64.shape[0], 100_000)])
        counts = torch.bincount(assign, minlength=k).to(torch.float64)
        sums = torch.zeros_like(centroids).index_add_(0, assign, X64)
        centroids = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], centroids)
    return centroids, counts


def check_kmeans(run, X):
    """KMeans against a float64 Lloyd from the same init rows; the
    transform's assignments against float64 distances outside a 1e-4
    relative margin; a refit bit for bit. Returns the points inside the
    margin and the float64 Lloyd's (centroids, counts)."""
    from flink_ml_tpu_torch.models.clustering import kmeans

    model = run["model"]
    X64 = X.double()
    idx = torch.as_tensor(kmeans.init_rows(KMEANS_ROWS, KMEANS_K, KMEANS_SEED), device=X.device)
    ref_c, ref_counts = lloyd64(X64, X64[idx], KMEANS_ITER)
    ref_c_host = ref_c.cpu().numpy()
    scale = float(np.max(np.abs(ref_c_host)))
    c_err = float(np.max(np.abs(model.centroids - ref_c_host)))
    count_diff = int(np.sum(np.abs(model.weights - ref_counts.cpu().numpy())))
    log(f"  kmeans centroids vs float64 Lloyd: max abs diff {c_err:.3g} of scale {scale:.3g}; "
        f"counts differ by {count_diff} points in all")
    check(c_err <= 1e-3 * scale, f"kmeans centroids differ from the float64 Lloyd by {c_err}")
    check(model.weights.sum() == KMEANS_ROWS, "kmeans weights do not count every point")

    C64 = torch.as_tensor(model.centroids, dtype=torch.float64, device=X.device)
    assign = run["out"].column("prediction")
    check(assign.shape == (KMEANS_ROWS,) and assign.dtype == torch.int32, "kmeans transform shape")
    inside, mismatched, _ = kmeans_assignments64(X64, C64, assign)
    log(f"  kmeans transform vs float64 distances: {inside} points within the 1e-4 margin "
        f"(not gated), {mismatched} mismatches outside it")
    check(mismatched == 0, f"kmeans transform assigns {mismatched} clear points differently")
    refit = kmeans_estimator().fit(run["table"])
    check(np.array_equal(refit.centroids, model.centroids) and np.array_equal(refit.weights, model.weights),
          "kmeans refit is not bit-identical")
    del X64
    return inside, (ref_c, ref_counts)


def pipeline_data(dev):
    """The BASELINE pipeline's input: 1M rows of 100 uniform features, a
    categorical column of arity 10 (conf/onehotencoder-benchmark.json), and
    binary labels from a seeded linear rule with noise."""
    from flink_ml_tpu_torch import Table

    gen = torch.Generator(device=dev)
    gen.manual_seed(PIPELINE_SEED)
    X = torch.rand((PIPELINE_ROWS, DIM), generator=gen, device=dev)
    cat = torch.randint(0, ARITY, (PIPELINE_ROWS,), generator=gen, device=dev).to(torch.float32)
    noise = torch.randn(PIPELINE_ROWS, generator=gen, device=dev)
    y = ((X[:, 0] + X[:, 1] - 1.0) + 0.2 * (cat - 4.5) / 4.5 + 0.3 * noise > 0).to(torch.float32)
    return Table({"features": X, "cat": cat, "label": y})


def pipeline():
    from flink_ml_tpu_torch import Pipeline
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.models.feature import onehotencoder, standardscaler, vectorassembler

    # centred: uncentred scaled features (mean 1.7 in each of 100 columns)
    # make LogisticRegression at learningRate 0.1 oscillate
    return Pipeline([
        standardscaler.StandardScaler().set_input_col("features").set_output_col("scaled")
        .set_with_mean(True),
        onehotencoder.OneHotEncoder().set_input_cols("cat").set_output_cols("cat_vec"),
        vectorassembler.VectorAssembler().set_input_cols("scaled", "cat_vec")
        .set_output_col("assembled"),
        estimator(logisticregression.LogisticRegression).set_features_col("assembled"),
    ])


def check_pipeline(run, table):
    """The scaler's stats against float64, the one-hot indices against
    numpy's, the LR against a float64 replay on the assembled float64
    matrix."""
    scaler, encoder, _, lr_model = run["model"].stages
    X64 = table.column("features").double()
    mean64, std64 = X64.mean(0).cpu().numpy(), X64.std(0).cpu().numpy()
    mean_rel = float(np.max(np.abs(scaler.mean - mean64) / np.abs(mean64)))
    std_rel = float(np.max(np.abs(scaler.std - std64) / np.abs(std64)))
    log(f"  pipeline scaler vs float64: mean max rel {mean_rel:.3g}, std max rel {std_rel:.3g}")
    check(mean_rel < 1e-4 and std_rel < 1e-4, "pipeline scaler stats differ from float64")

    cat = table.column("cat").cpu().numpy().astype(np.int64)
    vec_size = int(encoder.category_sizes[0]) - 1
    check(vec_size == ARITY - 1, f"one-hot vector size {vec_size}")
    want_idx = np.where(cat < vec_size, cat, -1)
    got_idx = run["out"].column("cat_vec").indices[:, 0].cpu().numpy()
    check(np.array_equal(got_idx, want_idx), "one-hot indices differ from numpy's")

    scale = np.where(scaler.std > 0, scaler.std, 1.0)
    onehot = np.zeros((PIPELINE_ROWS, vec_size))
    rows = np.nonzero(want_idx >= 0)[0]
    onehot[rows, want_idx[rows]] = 1.0
    A64 = np.hstack([(X64.cpu().numpy() - scaler.mean) / scale, onehot])
    y64 = table.column("label").double().cpu().numpy()
    ones = np.ones(BATCH)
    ref_coeff, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (A64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH], ones),
        PIPELINE_ROWS // BATCH, MAX_ITER, LEARNING_RATE, TOL,
    )
    coeff_rel = float(np.max(np.abs(lr_model.coefficient - ref_coeff)) / np.max(np.abs(ref_coeff)))
    pred = run["out"].column("prediction").cpu().numpy()
    accuracy = float(np.mean(pred == y64))
    log(f"  pipeline LR vs float64 replay on the assembled matrix: coeff max rel {coeff_rel:.3g} "
        f"({ref_epochs} epochs, loss {ref_loss:.6f}); training accuracy {accuracy:.4f}")
    check(coeff_rel < 1e-3, f"pipeline LR coefficients differ from the replay by {coeff_rel}")
    check(accuracy > 0.7, f"the pipeline's training accuracy {accuracy} is near chance")
    check(run["out"].column("assembled").shape == (PIPELINE_ROWS, DIM + vec_size), "assembled width")


def kmeans_assignments64(X64, C64, assign):
    """Float64 nearest centroids of X64's rows against `assign`: (points
    within the TIE_MARGIN, clear points assigned otherwise, the float64
    assignment)."""
    d64 = torch.cat([torch.cdist(X64[i:i + 100_000], C64, compute_mode="donot_use_mm_for_euclid_dist")
                     for i in range(0, X64.shape[0], 100_000)])
    two = torch.topk(d64, 2, dim=1, largest=False)
    clear = (two.values[:, 1] - two.values[:, 0]) > TIE_MARGIN * two.values[:, 1]
    mismatched = int(((assign.long() != two.indices[:, 0]) & clear).sum())
    return int((~clear).sum()), mismatched, two.indices[:, 0]


def host_columns(seed, rows, fill):
    """Host columns of `rows` rows, made chunk by chunk: chunk i of
    STREAM_CHUNK rows from np.random.default_rng([seed, i]), filled by
    `fill(rng, start, stop)`."""
    for i, start in enumerate(range(0, rows, STREAM_CHUNK)):
        fill(np.random.default_rng([seed, i]), start, min(start + STREAM_CHUNK, rows))


def stream_lr_data():
    """conf/logisticregression-benchmark.json's table on the host, as the
    stream paths get it: 10M x 100 uniform [0, 1) features, random 0/1
    labels, uniform weights, float32."""
    X = np.empty((DENSE_ROWS, DIM), np.float32)
    y = np.empty(DENSE_ROWS, np.float32)
    w = np.empty(DENSE_ROWS, np.float32)

    def fill(rng, a, b):
        rng.random((b - a, DIM), dtype=np.float32, out=X[a:b])
        y[a:b] = rng.integers(0, 2, b - a)
        rng.random(b - a, dtype=np.float32, out=w[a:b])

    host_columns(STREAM_SEED, DENSE_ROWS, fill)
    return {"features": X, "label": y, "weight": w}


def planted_rows(seed, rows, truth):
    """Uniform [-0.5, 0.5) features and the labels of the hyperplane
    `truth` through the origin, float32."""
    X = np.empty((rows, DIM), np.float32)

    def fill(rng, a, b):
        rng.random((b - a, DIM), dtype=np.float32, out=X[a:b])
        X[a:b] -= 0.5

    host_columns(seed, rows, fill)
    return {"features": X, "label": (X @ truth > 0).astype(np.float32)}


def stream_of(columns, rows, chunk):
    """A one-shot StreamTable of host Tables of `chunk` rows (views)."""
    from flink_ml_tpu_torch import StreamTable, Table

    return StreamTable(Table({k: v[i:i + chunk] for k, v in columns.items()})
                       for i in range(0, rows, chunk))


def device_table(columns, rows, dev):
    from flink_ml_tpu_torch import Table

    return Table({k: torch.from_numpy(v[:rows]).to(dev) for k, v in columns.items()})


def sgd_chunks(columns, rows):
    """(X, y, w) host chunks of the first `rows` rows, for SGD.optimize_stream."""
    X, y, w = columns["features"], columns["label"], columns["weight"]
    return ((X[i:min(i + STREAM_CHUNK, rows)], y[i:min(i + STREAM_CHUNK, rows)],
             w[i:min(i + STREAM_CHUNK, rows)]) for i in range(0, rows, STREAM_CHUNK))


def stream_sgd():
    from flink_ml_tpu_torch.ops.optimizer import SGD

    return SGD(max_iter=MAX_ITER, learning_rate=LEARNING_RATE, global_batch_size=BATCH, tol=TOL)


def check_stream_lr(run, columns, bounded_table, default_budget):
    """The stream fit against the port's bounded fit of the rows its epochs
    train (the first MAX_ITER batches) on the card, and against the float64
    replay; a fit whose cache spills against its in-memory twin."""
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.ops import losses

    model = run["model"]
    bounded = estimator(LogisticRegression, "weight").fit(bounded_table).coefficient
    rel = float(np.max(np.abs(model.coefficient - bounded)) / np.max(np.abs(bounded)))
    bits = bool(np.array_equal(model.coefficient, bounded))
    rows = MAX_ITER * BATCH
    X64 = columns["features"][:rows].astype(np.float64)
    y64, w64 = columns["label"][:rows].astype(np.float64), columns["weight"][:rows].astype(np.float64)
    ref, ref_loss, ref_epochs = numpy_reference_sgd(
        lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                   w64[k * BATCH:(k + 1) * BATCH]), MAX_ITER, MAX_ITER, LEARNING_RATE, TOL)
    del X64
    ref_rel = float(np.max(np.abs(model.coefficient - ref)) / np.max(np.abs(ref)))
    log(f"  stream lr vs the bounded fit of its {rows} rows on the card: max rel {rel:.3g}, "
        f"bit-identical {bits}; vs the float64 replay: max rel {ref_rel:.3g} ({ref_epochs} epochs)")
    check(rel <= 1e-6, f"stream lr differs from the bounded fit by {rel}")
    check(ref_rel < 1e-3, f"stream lr differs from the float64 replay by {ref_rel}")
    spill_rows = SPILL_BATCHES * BATCH
    twins = {}
    for label, budget in (("spilled", default_budget), ("in memory", STREAM_CACHE_BUDGET)):
        coeff, _, epochs, stats = stream_sgd().optimize_stream(
            None, sgd_chunks(columns, spill_rows), losses.BINARY_LOGISTIC_LOSS,
            memory_budget_bytes=budget)
        twins[label] = coeff
        log(f"  stream lr on {SPILL_BATCHES} batches, {label} (budget {budget} bytes): {stats}")
        check((stats["spilledSegments"] > 0) == (label == "spilled"), f"{label} twin's cache {stats}")
    check(np.array_equal(twins["spilled"], twins["in memory"]),
          "the spilled stream fit differs from its in-memory twin")
    log("  stream lr: the spilled fit equals its in-memory twin bit for bit")
    pred = run["out"].column("prediction")
    check(pred.shape == (rows,) and bool(torch.isfinite(pred).all()), "stream lr transform")


def check_stream_kmeans(run, X, columns, lloyd, bounded_model):
    """The stream fit from the bounded fit's init rows, against the float64
    Lloyd (the bounded KMeans path's gate); its difference from the bounded fit."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.clustering import kmeans

    model = run["model"]
    drawn = kmeans._sample_without_replacement(
        np.random.RandomState(KMEANS_SEED % 2**32), KMEANS_ROWS, KMEANS_K)
    check(np.array_equal(drawn, kmeans.init_rows(KMEANS_ROWS, KMEANS_K, KMEANS_SEED)),
          "the stream fit draws other init rows")
    one = kmeans_estimator().set_max_iter(1)
    first_stream = one.fit(stream_of(columns, KMEANS_ROWS, KMEANS_CHUNK)).centroids
    first_bounded = one.fit(Table({"features": X})).centroids
    first_rel = float(np.max(np.abs(first_stream - first_bounded)) / np.max(np.abs(first_bounded)))
    check(first_rel < 1e-5, f"one stream epoch differs from one bounded epoch by {first_rel}")
    ref_c, ref_counts = (t.cpu().numpy() for t in lloyd)
    scale = float(np.max(np.abs(ref_c)))
    c_err = float(np.max(np.abs(model.centroids - ref_c)))
    count_diff = int(np.sum(np.abs(model.weights - ref_counts)))
    b_err = float(np.max(np.abs(model.centroids - bounded_model.centroids)))
    b_counts = int(np.sum(np.abs(model.weights - bounded_model.weights)))
    log(f"  stream kmeans: init rows are the bounded fit's (one epoch apart by {first_rel:.3g}); "
        f"vs float64 Lloyd max abs {c_err:.3g} of scale {scale:.3g}, counts differ by {count_diff}; "
        f"vs the bounded fit max abs {b_err:.3g}, counts differ by {b_counts}")
    check(c_err <= 1e-3 * scale, f"stream kmeans centroids differ from the float64 Lloyd by {c_err}")
    check(model.weights.sum() == KMEANS_ROWS, "stream kmeans weights do not count every point")
    C64 = torch.as_tensor(model.centroids, dtype=torch.float64, device=X.device)
    inside, mismatched, _ = kmeans_assignments64(X.double(), C64, run["out"].column("prediction"))
    log(f"  stream kmeans transform: {inside} points within the margin, {mismatched} clear mismatches")
    check(mismatched == 0, f"stream kmeans transform assigns {mismatched} clear points differently")


def online_lr_estimator():
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.linalg import DenseVector
    from flink_ml_tpu_torch.models.classification import onlinelogisticregression as olr

    return (olr.OnlineLogisticRegression().set_global_batch_size(BATCH)
            .set_reg(ONLINE_REG).set_elastic_net(ONLINE_ELASTIC_NET)
            .set_initial_model_data(Table({"coefficient": [DenseVector(np.zeros(DIM))]})))


def online_lr_fit(columns, trace=None):
    """The online fit as a user drives it: fit, then train every version
    (ten at a time, recording each tenth coefficient into `trace`)."""
    model = online_lr_estimator().fit(stream_of(columns, DENSE_ROWS, STREAM_CHUNK))
    while True:
        version = model.model_version
        if model.process_updates(10) == version:
            return model
        if trace is not None:
            trace[model.model_version] = model.coefficient.copy()


def ftrl64_replay(columns, versions):
    """FTRL-Proximal in float64 numpy, written apart from the port: returns
    {version: (coefficient, |z| - l1)} at `versions`."""
    X, y = columns["features"], columns["label"]
    l1, l2 = ONLINE_ELASTIC_NET * ONLINE_REG, (1.0 - ONLINE_ELASTIC_NET) * ONLINE_REG
    alpha = beta = 0.1
    coeff, z, n = np.zeros(DIM), np.zeros(DIM), np.zeros(DIM)
    out = {}
    for v in range(1, max(versions) + 1):
        Xb = X[(v - 1) * BATCH:v * BATCH].astype(np.float64)
        yb = y[(v - 1) * BATCH:v * BATCH].astype(np.float64)
        p = 1.0 / (1.0 + np.exp(-(Xb @ coeff)))
        count = np.count_nonzero(Xb, axis=0)
        g = np.where(count > 0, (Xb.T @ (p - yb)) / np.maximum(count, 1), 0.0)
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / alpha
        z = z + g - sigma * coeff
        n = n + g * g
        coeff = np.where(np.abs(z) <= l1, 0.0,
                         (np.sign(z) * l1 - z) / ((beta + np.sqrt(n)) / alpha + l2))
        if v in versions:
            out[v] = (coeff, np.abs(z) - l1)
    return out


def check_online_lr(run, columns, trace, held):
    """Every tenth version and the last against the float64 FTRL replay,
    near-threshold coordinates counted and left out; the version stamp;
    accuracy on a held-out batch."""
    model, out = run["model"], run["out"]
    versions = DENSE_ROWS // BATCH
    check(model.model_version == versions, f"online lr ends at version {model.model_version}")
    check(sorted(trace) == list(range(10, versions + 1, 10)), f"online lr versions {sorted(trace)}")
    l1 = ONLINE_ELASTIC_NET * ONLINE_REG
    worst, near_total = 0.0, 0
    for v, (ref, margin) in ftrl64_replay(columns, set(trace)).items():
        clear = np.abs(margin) > NEAR_L1_SHARE * l1
        near_total += int(np.sum(~clear))
        rel = float(np.max(np.abs(trace[v] - ref)[clear]) / np.max(np.abs(ref)))
        worst = max(worst, rel)
        check(rel < 1e-3, f"online lr version {v} differs from the float64 replay by {rel}")
    zeros = int(np.sum(model.coefficient == 0.0))
    log(f"  online lr: {len(trace)} versions vs the float64 FTRL replay, worst max rel {worst:.3g}; "
        f"{near_total} near-threshold coordinates left out in all; {zeros} of {DIM} coefficients are 0")
    stamp = out.column("modelVersion")
    check(stamp.dtype == torch.int32 and bool((stamp == versions).all()), "online lr modelVersion column")
    accuracy = float((out.column("prediction") == held.column("label")).float().mean())
    log(f"  online lr held-out accuracy {accuracy:.4f} at version {model.model_version}")
    check(accuracy > 0.9, f"online lr held-out accuracy {accuracy}")


def online_kmeans_fit(columns, init_model, trace=None):
    """OnlineKMeans from a KMeans model (its centroids, its counts as
    weights) over the KMeans rows, trained one version at a time, each
    recorded into `trace` as (version, centroids, weights)."""
    from flink_ml_tpu_torch.models.clustering import onlinekmeans

    est = (onlinekmeans.OnlineKMeans().set_k(KMEANS_K).set_global_batch_size(BATCH)
           .set_decay_factor(ONLINE_KMEANS_DECAY)
           .set_initial_model_data(init_model.get_model_data()[0]))
    model = est.fit(stream_of(columns, KMEANS_ROWS, KMEANS_CHUNK))
    while True:
        version = model.model_version
        if model.process_updates(1) == version:
            return model
        if trace is not None:
            trace.append((model.model_version, model.centroids.copy(), model.weights.copy()))


def check_online_kmeans(run, X, init_model, trace):
    """Every version against a float64 replay of its decayed update from the
    version before, under the KMeans path's near-tie rule: points outside the margin
    are assigned as float64 assigns them, and the weights differ by at most
    two for each point inside it."""
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure

    model = run["model"]
    versions = KMEANS_ROWS // BATCH
    check(model.model_version == versions, f"online kmeans ends at version {model.model_version}")
    check([v for v, _, _ in trace] == list(range(1, versions + 1)), "online kmeans versions")
    measure = DistanceMeasure.get_instance("euclidean")
    prev_c, prev_w = init_model.centroids, init_model.weights
    worst, inside_total, flips = 0.0, 0, 0.0
    for v, c32, w32 in trace:
        Xb = X[(v - 1) * BATCH:v * BATCH]
        assign = measure.find_closest(Xb, torch.as_tensor(prev_c, dtype=torch.float32, device=X.device))
        C64 = torch.as_tensor(prev_c, dtype=torch.float64, device=X.device)
        X64 = Xb.double()
        inside, mismatched, assign64 = kmeans_assignments64(X64, C64, assign)
        check(mismatched == 0, f"online kmeans version {v}: {mismatched} clear points assigned otherwise")
        counts = torch.bincount(assign64, minlength=KMEANS_K).double()
        sums = torch.zeros_like(C64).index_add_(0, assign64, X64)
        means = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], C64)
        decayed = torch.as_tensor(prev_w, dtype=torch.float64, device=X.device) * ONLINE_KMEANS_DECAY
        c64 = ((C64 * decayed[:, None] + means * counts[:, None])
               / (decayed + counts).clamp(min=1e-16)[:, None]).cpu().numpy()
        w64 = (decayed + counts).cpu().numpy()
        rel = float(np.max(np.abs(c32 - c64)) / np.max(np.abs(c64)))
        w_diff = float(np.sum(np.abs(w32 - w64)))
        check(rel <= 1e-3, f"online kmeans version {v} differs from the float64 update by {rel}")
        check(w_diff <= 2 * inside, f"online kmeans version {v} weights differ by {w_diff}")
        worst, inside_total, flips = max(worst, rel), inside_total + inside, flips + w_diff
        prev_c, prev_w = c32, w32
    C64 = torch.as_tensor(model.centroids, dtype=torch.float64, device=X.device)
    inside, mismatched, _ = kmeans_assignments64(X.double(), C64, run["out"].column("prediction"))
    log(f"  online kmeans: {versions} versions vs float64 updates, worst max rel {worst:.3g}; "
        f"{inside_total} batch points within the margin, weights apart by {flips:g} in all; "
        f"transform: {inside} points within the margin, {mismatched} clear mismatches")
    check(mismatched == 0, f"online kmeans transform assigns {mismatched} clear points differently")


def online_lr_split(columns, dev):
    """The parts of an online LR version, each timed apart: the rebatch
    generator alone, the staging of every batch (copy into a pinned buffer
    and the upload, waited for), the upload alone (CUDA events), the FTRL
    step (CUDA events) and the publication of a coefficient (host clock)."""
    from flink_ml_tpu_torch.models.classification import onlinelogisticregression as olr
    from flink_ml_tpu_torch.parallel.prefetch import DeviceStager
    from flink_ml_tpu_torch.table import global_batches

    versions = DENSE_ROWS // BATCH
    t0 = time.perf_counter()
    batches = list(global_batches(stream_of(columns, DENSE_ROWS, STREAM_CHUNK), (
        lambda t: t.column("features"), lambda t: t.column("label").astype(np.float64)), BATCH))
    rebatch_ms = (time.perf_counter() - t0) * 1e3 / versions
    stager = DeviceStager(dev, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        staged = stager(b).wait()
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3 / versions
    del batches
    X, y = staged
    pinned = torch.empty(X.numel() * 4 + y.numel() * 4, dtype=torch.uint8, pin_memory=True)
    target = torch.empty_like(pinned, device=dev)
    upload_ms = cuda_ms(lambda: target.copy_(pinned, non_blocking=True), [()], iters=10)
    state = tuple(torch.zeros(DIM, device=dev) for _ in range(3))
    l1, l2 = ONLINE_ELASTIC_NET * ONLINE_REG, (1.0 - ONLINE_ELASTIC_NET) * ONLINE_REG
    step_ms = cuda_ms(lambda: olr._ftrl_step(*state, X, y, 0.1, 0.1, l1, l2), [()])
    coeff = state[0] + 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(versions):
        coeff.cpu().numpy()
    publish_ms = (time.perf_counter() - t0) * 1e3 / versions
    log(f"  online lr per version, timed apart: rebatch {rebatch_ms:.4f} ms, staging (pinned copy + "
        f"upload) {stage_ms:.3f} ms, upload alone {upload_ms:.3f} ms "
        f"({pinned.numel() / upload_ms / 1e6:.2f} GB/s), FTRL step {step_ms:.4f} ms, publish {publish_ms:.4f} ms")
    return {"rebatch_ms": rebatch_ms, "stage_ms": stage_ms, "upload_ms": upload_ms,
            "step_ms": step_ms, "publish_ms": publish_ms}


def profile_overlap(name, run):
    """torch.profiler over one call: wall, device busy and idle share, and
    how much of the host-to-device copy time runs under kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    copies = [(a, b) for n, a, b in spans if "HtoD" in n]
    kernels = sorted((a, b) for n, a, b in spans if "Memcpy" not in n and "Memset" not in n)
    merged = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    overlap = sum(max(0.0, min(b, mb) - max(a, ma)) for a, b in copies for ma, mb in merged)
    busy = []
    for a, b in sorted((a, b) for _, a, b in spans):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    busy_ms = sum(b - a for a, b in busy) / 1e3
    copy_ms = sum(b - a for a, b in copies) / 1e3
    kernel_ms = sum(b - a for a, b in merged) / 1e3
    log(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle {100.0 * (1.0 - busy_ms / wall_ms):.1f}%); {len(copies)} uploads {copy_ms:.3f} ms, "
        f"kernels {kernel_ms:.3f} ms, uploads under kernels {overlap / 1e3:.3f} ms "
        f"({100.0 * overlap / max(copy_ms * 1e3, 1e-9):.1f}% of upload time)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "upload_ms": copy_ms, "kernel_ms": kernel_ms,
            "overlap_ms": overlap / 1e3}

def stream_and_online_times(stream_cols, km_cols, online_cols, kmeans_model, dev, path_s):
    """Phase 5 for the stream and online paths: two warm runs of each, the
    stream fits split into ingest (rows a second into the data cache) and
    fit, the online fits in versions a second with the parts of a version
    timed apart, and a torch.profiler pass over one more run of each."""
    from flink_ml_tpu_torch.native.datacache import ReplayableStreamTable
    from flink_ml_tpu_torch.ops import losses

    def stream_fit():
        return stream_sgd().optimize_stream(
            None, sgd_chunks(stream_cols, DENSE_ROWS), losses.BINARY_LOGISTIC_LOSS)

    out = {}
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        (_, _, _, stats), ms = synced(stream_fit)
        ingest_ms = stats["ingestSeconds"] * 1e3
        runs.append((ms, ingest_ms, ms - ingest_ms))
        log(f"  stream lr: {ms:.1f} ms = ingest {ingest_ms:.1f} ms ({DENSE_ROWS / ingest_ms * 1e3:.4g} "
            f"rows/s into the cache) + fit {ms - ingest_ms:.1f} ms; {stats}")
    out["stream lr"] = {"wall_ms": [r[0] for r in runs], "ingest_ms": [r[1] for r in runs],
                        "fit_ms": [r[2] for r in runs],
                        "profile": profile_overlap("stream lr fit (ingest included)", stream_fit)}
    path_s["stream lr"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    runs = []
    for _ in range(3):  # two timed runs, then one profiled
        t1 = time.perf_counter()
        replay = ReplayableStreamTable(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK), STREAM_CACHE_BUDGET)
        for _ in replay:  # the first pass caches every batch
            pass
        ingest_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        for _ in replay:  # a pass that replays from the cache, as the fit's pass 0 does
            pass
        replay_ms = (time.perf_counter() - t1) * 1e3
        if len(runs) == 2:
            profile = profile_overlap("stream kmeans fit", lambda: kmeans_estimator().fit(replay))
        else:
            _, fit_ms = synced(lambda: kmeans_estimator().fit(replay))
            runs.append((ingest_ms, replay_ms, fit_ms))
            log(f"  stream kmeans: ingest {ingest_ms:.1f} ms ({KMEANS_ROWS / ingest_ms * 1e3:.4g} rows/s), "
                f"a replay pass {replay_ms:.1f} ms, fit {fit_ms:.1f} ms")
        replay.close()
    out["stream kmeans"] = {"ingest_ms": [r[0] for r in runs], "replay_ms": [r[1] for r in runs],
                            "fit_ms": [r[2] for r in runs], "profile": profile}
    path_s["stream kmeans"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    versions = DENSE_ROWS // BATCH
    walls = [synced(lambda: online_lr_fit(online_cols))[1] for _ in range(2)]
    for ms in walls:
        log(f"  online lr: {ms:.1f} ms for {versions} versions, {versions / ms * 1e3:.2f} versions/s, "
            f"{ms / versions:.3f} ms a version")
    out["online lr"] = {"wall_ms": walls, "split": online_lr_split(online_cols, dev),
                        "profile": profile_overlap("online lr fit", lambda: online_lr_fit(online_cols))}
    path_s["online lr"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    versions = KMEANS_ROWS // BATCH
    walls = [synced(lambda: online_kmeans_fit(km_cols, kmeans_model))[1] for _ in range(2)]
    for ms in walls:
        log(f"  online kmeans: {ms:.1f} ms for {versions} versions, {versions / ms * 1e3:.2f} "
            f"versions/s, {ms / versions:.3f} ms a version")
    out["online kmeans"] = {"wall_ms": walls, "profile": profile_overlap(
        "online kmeans fit", lambda: online_kmeans_fit(km_cols, kmeans_model))}
    path_s["online kmeans"] += time.perf_counter() - t0
    return out


# -- 6. the numeric feature stages ------------------------------------------------

#: rows of the conf/ tables: 10M for most stages, 1M for MinMaxScaler and
#: Bucketizer; the stream fits read 1M x 10 host rows in chunks
FEATURE_ROWS, FEATURE_SMALL_ROWS = 10_000_000, 1_000_000
FEATURE_STREAM_ROWS, FEATURE_STREAM_CHUNK = 1_000_000, 65_536
FEATURE_SEED, FEATURE_STREAM_SEED = 2, 23  # the conf/ generators' seed 2
FEATURE_REPEATS = 3
NAN_SHARE = 0.01  # the Imputer twins' missing entries
# max |port - float64 replay| over max |float64 replay|: the elementwise and
# affine stages; float32 sums of up to 10M terms (DCT at d = 100, the
# variances, the Imputer mean)
AFFINE_REL_TOL, SUM_REL_TOL = 1e-6, 1e-5
# the kmeans strategy's edges against a float64 Lloyd on the same rows:
# float32 and float64 Lloyd may stop an iteration apart
KMEANS_EDGE_TOL = 1e-3
FEATURE_JAVA = "org.apache.flink.ml.feature."
NO_LAUNCHES = launch_dict()


def feature_module(name):
    import importlib

    return importlib.import_module(f"flink_ml_tpu_torch.models.feature.{name}")


def seeded(seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def rel_err(got, want64):
    """max |got - want| over max |want|, in float64."""
    diff = (got.double() - want64).abs().max()
    return float(diff / want64.abs().max().clamp(min=torch.finfo(torch.float64).tiny))


def order_statistics64(X, rows):
    """Rows `rows` (0-based) of each column of X in sorted order, found in
    float64 by torch.kthvalue (a selection, not the port's sort)."""
    X64 = X.double()
    return torch.stack([torch.kthvalue(X64, int(r) + 1, dim=0).values for r in rows])


def jnp_quantile64(X, qs):
    """jnp.quantile's float32 linear quantile replayed from float64 order
    statistics: the same rows and weights, the product high * w rounded to
    float32 and the fused multiply-add done in float64, rounded once.
    Returns the quantiles and the floor rows."""
    n = X.shape[0]
    q = np.asarray(qs, np.float32) * (np.float32(n) - np.float32(1))
    low, high = np.floor(q), np.ceil(q)
    w_high = q - low
    w_low = np.float32(1) - w_high
    lo = order_statistics64(X, np.clip(low, 0, n - 1).astype(np.int64))
    hi = order_statistics64(X, np.clip(high, 0, n - 1).astype(np.int64))
    w_low = torch.as_tensor(w_low, dtype=torch.float64, device=X.device)[:, None]
    w_high = torch.as_tensor(w_high, dtype=torch.float64, device=X.device)[:, None]
    return (lo * w_low + (hi * w_high).float().double()).float(), lo


def bins64(X, edges_list):
    """Each feature's bin in float64 by counting: the edges (cast to
    float32, as the transform casts them) at or below x, minus one, clamped;
    NaN on top; a feature of <= 2 edges in bin 0."""
    out = torch.zeros(X.shape, dtype=torch.float64, device=X.device)
    for j, edges in enumerate(edges_list):
        top = max(edges.size - 2, 0)
        if top == 0:
            continue
        x = X[:, j].double()
        e = torch.as_tensor(edges.astype(np.float32).astype(np.float64), device=X.device)
        count = (x[:, None] >= e[None, :]).sum(dim=1) - 1
        out[:, j] = torch.where(torch.isnan(x), top, count.clamp(0, top)).double()
    return out


def poly_exponents(d, degree):
    """The exponent tuples of the monomials in the reference's order
    (PolynomialExpansion.java:103-117), the constant term left out."""
    def expand(last, deg):
        if deg == 0 or last < 0:
            yield (0,) * d
            return
        for i in range(deg + 1):
            for e in expand(last - 1, deg - i):
                yield e[:last] + (i,) + e[last + 1:]
    return list(expand(d - 1, degree))[1:]


def rank_window(sorted_col, value, p, eps):
    """True when `value` is within eps * n ranks of the p-quantile's rank
    ceil(p * n) in `sorted_col` (ties give a window of ranks)."""
    n = sorted_col.size
    below = np.searchsorted(sorted_col, value, side="left")
    upto = np.searchsorted(sorted_col, value, side="right")
    target = np.ceil(p * n)
    return below - eps * n - 1 <= target <= upto + eps * n + 1


def drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java, repeats=None):
    """One stage as a user runs it (`drive`: fit an estimator, transform,
    save, load, transform; `check_reload`: bit for bit), then `repeats`
    (FEATURE_REPEATS unless given) warm fits and transforms. The launch
    counts are reset before and read after; the peak is the card's
    high-water mark over the run above what it held before."""
    from flink_ml_tpu_torch.api import Estimator

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    estimator = isinstance(stage, Estimator)
    fit = (lambda: stage.fit(fit_table)) if estimator else (lambda: stage)
    run = drive(fit, table, tmp, name.replace(" ", "_"))
    repeats = FEATURE_REPEATS if repeats is None else repeats
    fits = [synced(fit)[1] for _ in range(repeats)] if estimator else []
    transforms = [synced(lambda: run["model"].transform(table)[0])[1] for _ in range(repeats)]
    counts = sk.launch_counts()
    high = torch.cuda.max_memory_allocated()
    check(counts == NO_LAUNCHES, f"{name} launched {counts}")
    check_reload(name, run, java, out_cols)
    del run["loaded"], run["again"]
    run.update(fit_ms=run["fit_ms"] if estimator else None,
               warm_fit_ms=float(np.median(fits)) if fits else None,
               warm_transform_ms=float(np.median(transforms)), fit_runs=fits,
               transform_runs=transforms, peak_gib=(high - held) / 2**30,
               high_water_gib=high / 2**30, launches=counts)
    first = f"fit {run['fit_ms']:.1f} ms, " if estimator else ""
    warm = f"fit {run['warm_fit_ms']:.3f} ms (runs {[round(t, 3) for t in fits]}), " if fits else ""
    log(f"  {name}: first {first}transform {run['transform_ms']:.1f} ms; warm median {warm}transform "
        f"{run['warm_transform_ms']:.3f} ms (runs {[round(t, 3) for t in transforms]}); peak "
        f"{run['peak_gib']:.3f} GiB above the {held / 2**30:.2f} GiB held; launches {counts}; "
        f"{time.perf_counter() - t0:.2f} s")
    return run


def feature_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run) at
    the stage's conf/ shape, on data born on the card from seeded
    generators (uniform [0, 1), as the conf/ generators make it) or, for the
    stream fits, host chunks from seeded numpy. They are made one at a time,
    so each stage's data is freed before the next is made."""
    from flink_ml_tpu_torch import StreamTable, Table, Vectors
    from flink_ml_tpu_torch.ops import quantile

    def uniform(rows, cols, seed=FEATURE_SEED):
        return torch.rand((rows, cols), generator=seeded(seed, dev), device=dev)

    def columns(X):
        return {f"f{j}": X[:, j].contiguous() for j in range(X.shape[1])}

    def binarizer():
        X = uniform(FEATURE_ROWS, 5)
        thresholds = [0.5, 0.3, 0.3, 0.6, 0.8]
        outs = [f"o{j}" for j in range(5)]
        stage = feature_module("binarizer").Binarizer().set_input_cols(*columns(X)) \
            .set_output_cols(*outs).set_thresholds(*thresholds)

        def verify(run):
            for j, thr in enumerate(thresholds):
                # against the threshold as a float32, as the stage casts it
                want = (X[:, j].double() > float(np.float32(thr))).float()
                check(torch.equal(run["out"].column(outs[j]), want), f"binarizer {outs[j]}")
            return {"exact": True}
        table = Table(columns(X))
        return stage, table, table, outs, FEATURE_JAVA + "binarizer.Binarizer", verify

    def bucketizer(handle, plant):
        def make():
            x = uniform(FEATURE_SMALL_ROWS, 1)[:, 0].contiguous()
            if plant:  # NaN, below and above the splits, and the splits themselves
                x[:1000] = float("nan")
                x[1000:2000] = -0.5
                x[2000:3000] = 1.5
                x[3000:3005] = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device=dev)
            splits = [0.0, 0.25, 0.5, 0.75, 1.0]
            stage = feature_module("bucketizer").Bucketizer().set_input_cols("f0") \
                .set_output_cols("o0").set_splits_array([splits]).set_handle_invalid(handle)

            def verify(run):
                x64 = x.double()
                s = torch.tensor(splits, dtype=torch.float64, device=dev)
                idx = (x64[:, None] >= s[None, :]).sum(dim=1) - 1
                idx = torch.where(x64 == s[-1], len(splits) - 2, idx)
                bad = (x64 < s[0]) | (x64 > s[-1]) | torch.isnan(x64)
                want = torch.where(bad, len(splits) - 1, idx) if handle == "keep" else idx[~bad]
                check(torch.equal(run["out"].column("o0"), want.float()), f"bucketizer {handle}")
                return {"exact": True, "invalid": int(bad.sum()), "rows_out": run["out"].num_rows}
            table = Table({"f0": x})
            return stage, table, table, ["o0"], FEATURE_JAVA + "bucketizer.Bucketizer", verify
        return make

    def dct():
        X = uniform(FEATURE_ROWS, DIM)
        stage = feature_module("dct").DCT().set_input_col("input").set_output_col("o")

        def verify(run):
            B = torch.as_tensor(feature_module("dct").dct_basis(DIM), device=dev)
            err = rel_err(run["out"].column("o"), X.double() @ B.T)
            check(err <= SUM_REL_TOL, f"dct relative error {err:.3e}")
            return {"rel_err": err, "tol": SUM_REL_TOL}
        table = Table({"input": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "dct.DCT", verify

    def elementwiseproduct():
        X = uniform(FEATURE_ROWS, 5)
        scaling = [1.0, 2.0, 3.0, 4.0, 5.0]
        stage = feature_module("elementwiseproduct").ElementwiseProduct().set_input_col("features") \
            .set_output_col("o").set_scaling_vec(Vectors.dense(*scaling))

        def verify(run):
            want = X.double() * torch.tensor(scaling, dtype=torch.float64, device=dev)
            err = rel_err(run["out"].column("o"), want)
            check(err <= AFFINE_REL_TOL, f"elementwiseproduct relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "elementwiseproduct.ElementwiseProduct", verify

    def interaction():
        X = uniform(FEATURE_ROWS, 5)
        stage = feature_module("interaction").Interaction().set_input_cols(*columns(X)).set_output_col("o")

        def verify(run):
            err = rel_err(run["out"].column("o"), X.double().prod(dim=1, keepdim=True))
            check(err <= AFFINE_REL_TOL, f"interaction relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table(columns(X))
        return stage, table, table, ["o"], FEATURE_JAVA + "interaction.Interaction", verify

    def kbins(strategy):
        def make():
            kb = feature_module("kbinsdiscretizer")
            X = uniform(FEATURE_ROWS, 10)
            stage = kb.KBinsDiscretizer().set_input_col("input").set_output_col("o") \
                .set_strategy(strategy).set_num_bins(5)

            def verify(run):
                edges = run["model"].bin_edges
                sub = stage.get_sub_samples()
                S = X if FEATURE_ROWS <= sub else \
                    X[kb.subsample_rows(FEATURE_ROWS, sub).to(dev)]
                out = {"exact": True}
                if strategy == "uniform":
                    lo_hi = torch.stack(torch.aminmax(S.double(), dim=0)).cpu().numpy()
                    want = [np.unique(np.linspace(lo_hi[0, j], lo_hi[1, j], 6)) for j in range(10)]
                    check(all(np.array_equal(a, b) for a, b in zip(edges, want)), "kbins uniform edges")
                elif strategy == "quantile":
                    qs = np.linspace(0.0, 1.0, 6)
                    q32, lo = jnp_quantile64(S, qs)
                    low = np.floor(np.float32(qs) * (np.float32(S.shape[0]) - np.float32(1)))
                    port_lo = quantile.sorted_rows(S, low.astype(np.int64))
                    check(torch.equal(port_lo.double(), lo), "kbins quantile order statistics")
                    want = q32.double().cpu().numpy()
                    check(all(np.array_equal(a, np.unique(want[:, j])) for j, a in enumerate(edges)),
                          "kbins quantile edges")
                else:  # the port's host Lloyd against a float64 one on the same rows
                    S64 = S.double().cpu().numpy()
                    want = [kb.kmeans_1d_edges(S64[:, j], 5) for j in range(10)]
                    sizes = all(a.size == b.size for a, b in zip(edges, want))
                    err = max(float(np.max(np.abs(a - b))) for a, b in zip(edges, want)) if sizes else 1.0
                    check(err <= KMEANS_EDGE_TOL, f"kbins kmeans edges {err:.3e} from a float64 Lloyd")
                    out = {"exact_bins": True, "edge_err": err, "tol": KMEANS_EDGE_TOL}
                check(torch.equal(run["out"].column("o").double(), bins64(X, edges)),
                      f"kbins {strategy} bins")
                return out
            table = Table({"input": X})
            return stage, table, table, ["o"], FEATURE_JAVA + "kbinsdiscretizer.KBinsDiscretizerModel", verify
        return make

    def maxabsscaler():
        X = uniform(FEATURE_ROWS, DIM) * 2 - 1
        stage = feature_module("maxabsscaler").MaxAbsScaler().set_input_col("features").set_output_col("o")

        def verify(run):
            m64 = X.double().abs().amax(dim=0)
            check(np.array_equal(run["model"].max_abs, m64.cpu().numpy()), "maxabsscaler max")
            err = rel_err(run["out"].column("o"), X.double() / m64)
            check(err <= AFFINE_REL_TOL, f"maxabsscaler relative error {err:.3e}")
            return {"exact_max": True, "rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "maxabsscaler.MaxAbsScalerModel", verify

    def minmaxscaler():
        X = uniform(FEATURE_SMALL_ROWS, DIM)
        stage = feature_module("minmaxscaler").MinMaxScaler().set_input_col("features") \
            .set_output_col("output")

        def verify(run):
            mn, mx = torch.aminmax(X.double(), dim=0)
            model = run["model"]
            check(np.array_equal(model.min_vector, mn.cpu().numpy())
                  and np.array_equal(model.max_vector, mx.cpu().numpy()), "minmaxscaler min and max")
            err = rel_err(run["out"].column("output"), (X.double() - mn) / (mx - mn))
            check(err <= AFFINE_REL_TOL, f"minmaxscaler relative error {err:.3e}")
            return {"exact_min_max": True, "rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["output"], FEATURE_JAVA + "minmaxscaler.MinMaxScalerModel", verify

    def normalizer():
        X = uniform(FEATURE_ROWS, 5)
        stage = feature_module("normalizer").Normalizer().set_input_col("features") \
            .set_output_col("o").set_p(2.0)

        def verify(run):
            X64 = X.double()
            err = rel_err(run["out"].column("o"), X64 / X64.norm(dim=1, keepdim=True))
            check(err <= AFFINE_REL_TOL, f"normalizer relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "normalizer.Normalizer", verify

    def polynomialexpansion():
        X = uniform(FEATURE_ROWS, 5)
        stage = feature_module("polynomialexpansion").PolynomialExpansion().set_input_col("features") \
            .set_output_col("o").set_degree(2)

        def verify(run):
            X64 = X.double()
            exps = poly_exponents(5, 2)
            want = torch.stack([torch.prod(X64 ** torch.tensor(e, dtype=torch.float64, device=dev), dim=1)
                                for e in exps], dim=1)
            got = run["out"].column("o")
            check(tuple(got.shape) == (FEATURE_ROWS, 20), f"polynomialexpansion shape {tuple(got.shape)}")
            err = rel_err(got, want)
            check(err <= AFFINE_REL_TOL, f"polynomialexpansion relative error {err:.3e}")
            return {"rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "polynomialexpansion.PolynomialExpansion", verify

    def robustscaler():
        X = uniform(FEATURE_ROWS, DIM)
        stage = feature_module("robustscaler").RobustScaler().set_input_col("input").set_output_col("o") \
            .set_with_centering(True).set_with_scaling(True)

        def verify(run):
            q32, lo = jnp_quantile64(X, [0.5, 0.25, 0.75])
            n = FEATURE_ROWS
            low = np.floor(np.float32([0.5, 0.25, 0.75]) * (np.float32(n) - np.float32(1)))
            port_lo = quantile.sorted_rows(X, low.astype(np.int64))
            check(torch.equal(port_lo.double(), lo), "robustscaler order statistics")
            q = q32.double().cpu().numpy()
            model = run["model"]
            check(np.array_equal(model.medians, q[0]) and np.array_equal(model.ranges, q[2] - q[1]),
                  "robustscaler medians and ranges")
            med = torch.as_tensor(model.medians, device=dev)
            rng = torch.as_tensor(np.where(model.ranges > 0, model.ranges, 1.0), device=dev)
            err = rel_err(run["out"].column("o"), (X.double() - med) / rng)
            check(err <= AFFINE_REL_TOL, f"robustscaler relative error {err:.3e}")
            return {"exact_quantiles": True, "rel_err": err, "tol": AFFINE_REL_TOL}
        table = Table({"input": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "robustscaler.RobustScalerModel", verify

    def imputer(strategy, with_nan):
        def make():
            names = [f"f{j}" for j in range(15)]
            outs = [f"o{j}" for j in range(15)]
            gen = seeded(FEATURE_SEED, dev)
            X = torch.randint(0, 100, (FEATURE_ROWS, 15), generator=gen, device=dev).float()
            if with_nan:
                X[torch.rand(X.shape, generator=gen, device=dev) < NAN_SHARE] = float("nan")
            stage = feature_module("imputer").Imputer().set_input_cols(*names) \
                .set_output_cols(*outs).set_strategy(strategy)

            def verify(run):
                got = np.array([run["model"].surrogates[c] for c in names])
                want = np.empty(15)
                for j in range(15):
                    x = X[:, j].double()
                    valid = x[~torch.isnan(x)]
                    k = valid.numel()
                    if strategy == "mean":
                        want[j] = float(valid.sum() / k)
                    elif strategy == "median":
                        lo = torch.kthvalue(valid, (k - 1) // 2 + 1).values
                        hi = torch.kthvalue(valid, k // 2 + 1).values
                        want[j] = float((lo + hi) / 2)
                    else:  # the smallest of the most frequent integers
                        want[j] = float(torch.argmax(torch.bincount(valid.long(), minlength=100)))
                if strategy == "mean":
                    err = float(np.max(np.abs(got - want) / np.abs(want)))
                    check(err <= SUM_REL_TOL, f"imputer mean relative error {err:.3e}")
                    result = {"rel_err": err, "tol": SUM_REL_TOL}
                else:
                    check(np.array_equal(got, want), f"imputer {strategy} surrogates {got} vs {want}")
                    result = {"exact": True}
                for j in range(15):
                    fill = torch.tensor(got[j], dtype=torch.float32, device=dev)
                    want_col = torch.where(torch.isnan(X[:, j]), fill, X[:, j])
                    check(torch.equal(run["out"].column(outs[j]), want_col), f"imputer {strategy} {outs[j]}")
                result["filled"] = int(torch.isnan(X).sum())
                return result
            table = Table(columns(X))
            return stage, table, table, outs, FEATURE_JAVA + "imputer.ImputerModel", verify
        return make

    def variancethresholdselector():
        X = uniform(FEATURE_ROWS, DIM)
        vts = feature_module("variancethresholdselector")
        stage = vts.VarianceThresholdSelector().set_input_col("input").set_output_col("o")

        def verify(run):
            X64 = X.double()
            var64 = ((X64 - X64.mean(dim=0)) ** 2).sum(dim=0) / (FEATURE_ROWS - 1)
            err = rel_err(vts.sample_variance(X), var64)
            check(err <= SUM_REL_TOL, f"variance relative error {err:.3e}")
            kept = torch.nonzero(var64 > stage.get_variance_threshold()).flatten().cpu().numpy()
            check(np.array_equal(run["model"].indices, kept), "variancethresholdselector indices")
            check(torch.equal(run["out"].column("o"), X[:, kept]), "variancethresholdselector output")
            return {"var_rel_err": err, "tol": SUM_REL_TOL, "kept": int(kept.size)}
        table = Table({"input": X})
        return (stage, table, table, ["o"],
                FEATURE_JAVA + "variancethresholdselector.VarianceThresholdSelectorModel", verify)

    def vectorslicer():
        X = uniform(FEATURE_ROWS, 10)
        stage = feature_module("vectorslicer").VectorSlicer().set_input_col("features") \
            .set_output_col("o").set_indices(1, 3, 5, 7)

        def verify(run):
            check(torch.equal(run["out"].column("o"), X[:, [1, 3, 5, 7]]), "vectorslicer")
            return {"exact": True}
        table = Table({"features": X})
        return stage, table, table, ["o"], FEATURE_JAVA + "vectorslicer.VectorSlicer", verify

    def vectorindexer(categorical):
        def make():
            X = uniform(FEATURE_ROWS, 10)
            Xt = X
            if categorical:  # three columns of 3, 7 and 20 integer categories
                gen = seeded(FEATURE_SEED + 1, dev)
                for j, k in enumerate((3, 7, 20)):
                    X[:, j] = torch.randint(0, k, (FEATURE_ROWS,), generator=gen, device=dev).float()
                Xt = X.clone()
                Xt[:1000, 1] = 50.0  # unseen: the rows go under skip
            stage = feature_module("vectorindexer").VectorIndexer().set_input_col("input") \
                .set_output_col("o").set_max_categories(20).set_handle_invalid("skip")

            def verify(run):
                counts = [torch.unique(X[:, j].double()).numel() for j in range(10)]
                want_cols = [j for j, c in enumerate(counts) if c <= 20]
                maps = run["model"].category_maps
                check(sorted(maps) == want_cols, f"vectorindexer categorical columns {sorted(maps)}")
                for j in want_cols:  # integer categories from 0: each maps to itself
                    check(maps[j] == {float(v): v for v in range(counts[j])}, f"vectorindexer map {j}")
                keep = ~(Xt[:, 1] == 50.0) if categorical else slice(None)
                check(torch.equal(run["out"].column("o"), Xt[keep]), "vectorindexer output")
                return {"exact": True, "categorical": want_cols, "rows_out": run["out"].num_rows}
            return (stage, Table({"input": X}), Table({"input": Xt}), ["o"],
                    FEATURE_JAVA + "vectorindexer.VectorIndexerModel", verify)
        return make

    def stream_data(integers):
        """1M x 10 host rows from seeded numpy, in chunks: uniform [0, 1), or
        integers in [0, 100) with NAN_SHARE of them NaN."""
        rng = np.random.default_rng(FEATURE_STREAM_SEED)
        if integers:
            X = rng.integers(0, 100, (FEATURE_STREAM_ROWS, 10)).astype(np.float64)
            X[rng.random(X.shape) < NAN_SHARE] = np.nan
        else:
            X = rng.random((FEATURE_STREAM_ROWS, 10))
        return X, [X[i:i + FEATURE_STREAM_CHUNK] for i in range(0, FEATURE_STREAM_ROWS, FEATURE_STREAM_CHUNK)]

    def stream_robustscaler():
        X, chunks = stream_data(False)
        stream = StreamTable.from_batches([Table({"input": c}) for c in chunks])
        stage = feature_module("robustscaler").RobustScaler().set_input_col("input").set_output_col("o") \
            .set_with_centering(True)
        Xd = torch.from_numpy(X).float().to(dev)

        def verify(run):
            model, eps = run["model"], stage.get_relative_error()
            med, lo, hi = stage._fit_stream(stream)
            check(np.array_equal(med, model.medians) and np.array_equal(hi - lo, model.ranges),
                  "stream robustscaler refit")
            for j in range(10):
                col = np.sort(X[:, j])
                for p, v in ((0.5, med[j]), (0.25, lo[j]), (0.75, hi[j])):
                    check(rank_window(col, v, p, eps), f"stream robustscaler {p} of column {j}")
            want = (Xd.double() - torch.as_tensor(med, device=dev)) / torch.as_tensor(hi - lo, device=dev)
            err = rel_err(run["out"].column("o"), want)
            check(err <= AFFINE_REL_TOL, f"stream robustscaler relative error {err:.3e}")
            return {"rank_error_within": eps, "rel_err": err, "tol": AFFINE_REL_TOL}
        return (stage, stream, Table({"input": Xd}), ["o"],
                FEATURE_JAVA + "robustscaler.RobustScalerModel", verify)

    def stream_kbins():
        kb = feature_module("kbinsdiscretizer")
        X, chunks = stream_data(False)
        stream = StreamTable.from_batches([Table({"input": c}) for c in chunks])
        stage = kb.KBinsDiscretizer().set_input_col("input").set_output_col("o") \
            .set_strategy("quantile").set_num_bins(5)
        Xd = torch.from_numpy(X).float().to(dev)

        def verify(run):
            edges, qs = run["model"].bin_edges, np.linspace(0.0, 1.0, 6)
            for j, e in enumerate(edges):
                col = np.sort(X[:, j])
                check(e.size == 6 and all(rank_window(col, v, p, kb.STREAM_RELATIVE_ERROR)
                                          for p, v in zip(qs, e)), f"stream kbins edges of column {j}")
            check(torch.equal(run["out"].column("o").double(), bins64(Xd, edges)), "stream kbins bins")
            return {"rank_error_within": kb.STREAM_RELATIVE_ERROR, "exact_bins": True}
        return (stage, stream, Table({"input": Xd}), ["o"],
                FEATURE_JAVA + "kbinsdiscretizer.KBinsDiscretizerModel", verify)

    def stream_imputer():
        X, chunks = stream_data(True)
        names, outs = [f"f{j}" for j in range(10)], [f"o{j}" for j in range(10)]
        stream = StreamTable.from_batches([Table({n: c[:, j] for j, n in enumerate(names)}) for c in chunks])
        stage = feature_module("imputer").Imputer().set_input_cols(*names).set_output_cols(*outs) \
            .set_strategy("median")
        Xd = torch.from_numpy(X).float().to(dev)

        def verify(run):
            eps = stage.get_relative_error()
            for j, name in enumerate(names):
                col = np.sort(X[:, j][~np.isnan(X[:, j])])
                v = run["model"].surrogates[name]
                check(rank_window(col, v, 0.5, eps), f"stream imputer median of {name}")
                fill = torch.tensor(v, dtype=torch.float32, device=dev)
                check(torch.equal(run["out"].column(outs[j]), torch.where(torch.isnan(Xd[:, j]), fill,
                                                                          Xd[:, j])), f"stream imputer {name}")
            return {"rank_error_within": eps, "exact_fill": True}
        return (stage, stream, Table({n: Xd[:, j].contiguous() for j, n in enumerate(names)}), outs,
                FEATURE_JAVA + "imputer.ImputerModel", verify)

    return {
        "binarizer": binarizer,
        "bucketizer": bucketizer("keep", False),
        "bucketizer invalid keep": bucketizer("keep", True),
        "bucketizer invalid skip": bucketizer("skip", True),
        "dct": dct,
        "elementwiseproduct": elementwiseproduct,
        "interaction": interaction,
        "kbinsdiscretizer": kbins("uniform"),
        "kbinsdiscretizer quantile": kbins("quantile"),
        "kbinsdiscretizer kmeans": kbins("kmeans"),
        "maxabsscaler": maxabsscaler,
        "minmaxscaler": minmaxscaler,
        "normalizer": normalizer,
        "polynomialexpansion": polynomialexpansion,
        "robustscaler": robustscaler,
        "imputer": imputer("mean", False),
        "imputer median": imputer("median", True),
        "imputer most_frequent": imputer("most_frequent", True),
        "variancethresholdselector": variancethresholdselector,
        "vectorslicer": vectorslicer,
        "vectorindexer": vectorindexer(False),
        "vectorindexer categorical": vectorindexer(True),
        "stream robustscaler": stream_robustscaler,
        "stream kbinsdiscretizer quantile": stream_kbins,
        "stream imputer median": stream_imputer,
    }


#: the feature paths given a torch.profiler pass, and the call profiled
FEATURE_PROFILES = {"dct": "transform", "polynomialexpansion": "transform",
                    "kbinsdiscretizer": "fit", "robustscaler": "fit", "imputer median": "fit",
                    "imputer most_frequent": "fit", "stream robustscaler": "fit"}


def feature_phase(sk, dev, tmp):
    """Phase 6: every numeric feature stage at its conf/ shape, one path
    each (drive_feature), then its checks against a float64 replay; a
    profiler pass over one more call of the paths in FEATURE_PROFILES."""
    results = {}
    for name, make in feature_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java)
        checks = verify(run)
        if name in FEATURE_PROFILES:
            call = FEATURE_PROFILES[name]
            profile_run(f"{name} {call}", (lambda: stage.fit(fit_table)) if call == "fit"
                        else (lambda: run["model"].transform(table)[0]))
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
    return results


# -- 7. the string and token stages and the text path --------------------------------

#: the text path: a DictTokenMatrix of the shape of conf/stopwordsremover-
#: benchmark.json (1M x 100) over the vocabulary size of conf/hashingtf-
#: benchmark.json (1,000 terms), the first TEXT_STOPS of them English stop
#: words; HashingTF at its default 2^18 features; the conf/ LR params
TEXT_ROWS, TEXT_TOKENS, TEXT_TERMS, TEXT_STOPS = 1_000_000, 100, 1_000, 100
TEXT_SEED, TEXT_WEIGHT_SEED = 29, 31
TEXT_ACCURACY = 0.7
TEXT_REPEATS = 3
TEXT_LAUNCHES = launch_dict(sparse_row_dots=MAX_ITER + 2, sparse_grad=MAX_ITER)
TEXT_JAVA = "org.apache.flink.ml.builder.PipelineModel"
#: the nine stages at their conf/ shapes (rows, tokens a row, distinct values)
CV_SHAPE = (10_000_000, 100, 100)  # countvectorizer, seed 2
NGRAM_SHAPE = (10_000_000, 10, 10)  # ngram (numDistinctValues defaults to 10), n 2
SWR_SHAPE = (1_000_000, 100, 100)  # stopwordsremover
HTF_SHAPE = (100_000, 20, 1_000)  # hashingtf
IDF_SHAPE = (10_000_000, 10)  # idf, dense, minDocFreq 0
HASHER_ROWS, HASHER_FEATURES = 10_000_000, 1000  # featurehasher: f0-f4, f0-f2 categorical
REGEX_ROWS, REGEX_DISTINCT = 10_000_000, 100  # regextokenizer, pattern 1+
TOKENIZER_ROWS, TOKENIZER_DISTINCT = 100_000, 100
INDEXER_ROWS, INDEXER_DISTINCT = 1_000_000, 1_000  # stringindexer, frequencyDesc
CONF_SEED = 2
#: host replays of the host stages (FeatureHasher, RegexTokenizer) check the
#: first rows only: a Python loop over 10M rows would take minutes
HOST_REPLAY_ROWS = 200_000
_BIG = 2**31 - 1


def string_vocab(m):
    """The conf/ generators' vocabulary: decimal strings at their minimal
    unicode width."""
    return np.arange(m).astype(str).astype(f"<U{len(str(max(m - 1, 1)))}")


def term_runs_replay(mapped, width):
    """numpy replay of a padded-CSR term count: each row's distinct
    non-negative terms ascending with their counts as float32, -1 and 0
    padding, `width` slots."""
    n, k = mapped.shape
    S = np.sort(np.where(mapped >= 0, mapped, _BIG), axis=1).ravel()
    starts = np.flatnonzero(np.concatenate([[True], S[1:] != S[:-1]]) |
                            (np.arange(n * k) % k == 0))
    counts = np.diff(np.append(starts, n * k))
    rows, terms = starts // k, S[starts]
    keep = terms != _BIG
    rows, terms, counts = rows[keep], terms[keep], counts[keep]
    slot = np.arange(rows.size) - np.searchsorted(rows, rows, side="left")
    indices = np.full((n, width), -1, np.int32)
    values = np.zeros((n, width), np.float32)
    indices[rows, slot] = terms
    values[rows, slot] = counts
    return indices, values


def filter_replay(ids, keep_vocab):
    """numpy replay of StopWordsRemover on ids: kept ids left in order, -1 right."""
    keep = (ids >= 0) & keep_vocab[np.maximum(ids, 0)]
    order = np.argsort(~keep, axis=1, kind="stable")
    return np.take_along_axis(np.where(keep, ids, -1), order, axis=1)


def text_corpus(rows, dev):
    """The text path's table: ids from a seeded generator on the card over
    TEXT_TERMS terms (the first TEXT_STOPS English stop words), and labels
    planted on the other terms: 1 when a row's sum of seeded term weights
    is above the median."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.feature._stopwords import STOP_WORDS
    from flink_ml_tpu_torch.ops import tokens
    from flink_ml_tpu_torch.table import DictTokenMatrix

    vocab = np.asarray(list(STOP_WORDS["english"][:TEXT_STOPS])
                       + [f"term{i}" for i in range(TEXT_TERMS - TEXT_STOPS)])
    ids = tokens.random_token_ids(TEXT_SEED, rows, TEXT_TOKENS, TEXT_TERMS, dev)
    weight = torch.randn(TEXT_TERMS, generator=seeded(TEXT_WEIGHT_SEED, dev), device=dev)
    weight[:TEXT_STOPS] = 0.0
    score = weight[ids.long()].sum(dim=1)
    label = (score > score.median()).to(torch.float32)
    return Table({"tokens": DictTokenMatrix(vocab, ids), "label": label})


def text_pipeline():
    from flink_ml_tpu_torch import Pipeline
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    f = feature_module
    return Pipeline([
        f("stopwordsremover").StopWordsRemover().set_input_cols("tokens").set_output_cols("words"),
        f("hashingtf").HashingTF().set_input_col("words").set_output_col("tf"),
        f("idf").IDF().set_input_col("tf").set_output_col("features"),
        estimator(LogisticRegression),
    ])


def text_features(model, table):
    """The tables after each stage of a fitted text PipelineModel but the LR."""
    out = {}
    for stage, col in zip(model.stages[:3], ("words", "tf", "features")):
        table = stage.transform(table)[0]
        out[col] = table.column(col)
    return out


def text_fit_batch(dev):
    """The text path's fit batch (BATCH rows of its features, d = 2^18),
    for phase 2: StopWordsRemover -> HashingTF -> IDF on the first BATCH
    rows of its corpus."""
    remover, hashing_tf, idf, _ = text_pipeline().stages
    tf = hashing_tf.transform(remover.transform(text_corpus(BATCH, dev))[0])[0]
    feats = idf.fit(tf).transform(tf)[0].column("features")
    return feats.indices, feats.values, feats.size


def text_path(sk, dev, tmp):
    """The text path, fit -> transform -> save -> load -> transform with
    the launch counts reset before and read after; its gates; warm times
    and a profiler pass over one fit."""
    from flink_ml_tpu_torch.models.feature.hashingtf import bucket_lut

    t0 = time.perf_counter()
    table = text_corpus(TEXT_ROWS, dev)
    torch.cuda.synchronize()
    log(f"  text corpus on the card: {TEXT_ROWS} x {TEXT_TOKENS} ids over {TEXT_TERMS} terms in "
        f"{time.perf_counter() - t0:.2f} s")
    fit = lambda: text_pipeline().fit(table)  # noqa: E731
    sk.reset_launch_counts()
    run = drive(fit, table, tmp, "text")
    counts = sk.launch_counts()
    log(f"  text path: fit {run['fit_ms']:.1f} ms, transform {run['transform_ms']:.1f} ms (first "
        f"calls); launches {counts}")
    check(counts == TEXT_LAUNCHES, f"text path launched {counts}, expected {TEXT_LAUNCHES}")
    check_reload("text", run, TEXT_JAVA, ("prediction", "rawPrediction"))
    model = run["model"]
    feats = text_features(model, table)
    tokens = table.column("tokens")
    ids = tokens.ids.cpu().numpy()
    keep_vocab = ~np.isin(tokens.vocab, [w.lower() for w in model.stages[0].get_stop_words()])
    words = filter_replay(ids, keep_vocab)
    check(np.array_equal(feats["words"].ids.cpu().numpy(), words),
          "text StopWordsRemover differs from its numpy replay")
    dropped = int((ids >= 0).sum() - (words >= 0).sum())
    check(dropped > 0, "the text path's StopWordsRemover dropped nothing")
    tf = feats["tf"]
    lut = bucket_lut(tokens.vocab, tf.size)
    want_i, want_v = term_runs_replay(np.where(words >= 0, lut[np.maximum(words, 0)], -1),
                                      tf.indices.shape[1])
    check(tf.indices.shape == (TEXT_ROWS, TEXT_TOKENS) and tf.size == 1 << 18,
          f"text HashingTF shape {tuple(tf.indices.shape)}, size {tf.size}")
    check(np.array_equal(tf.indices.cpu().numpy(), want_i)
          and np.array_equal(tf.values.cpu().numpy(), want_v),
          "text HashingTF differs from its numpy replay")
    idf_model = model.stages[2]
    present = want_i[(want_i >= 0) & (want_v != 0)]
    df = np.bincount(present, minlength=tf.size).astype(np.float64)
    idf64 = np.log((TEXT_ROWS + 1.0) / (df + 1.0))
    check(np.array_equal(idf_model.doc_freq, df) and np.array_equal(idf_model.idf, idf64),
          "text IDF model differs from its numpy replay")
    idf32 = torch.as_tensor(idf64.astype(np.float32), device=dev)
    f = feats["features"]
    want = torch.where(tf.indices >= 0, tf.values * idf32[tf.indices.clamp(min=0).long()], 0.0)
    check(torch.equal(f.indices, tf.indices) and torch.equal(f.values, want),
          "text IDF values differ from float32(v) * float32(idf)")
    label = table.column("label")
    check_sparse_linear("lr", {"model": model.stages[-1], "out": run["out"]}, f.indices, f.values,
                        label, dim=f.size)
    accuracy = float((run["out"].column("prediction") == label).float().mean())
    log(f"  text path: {dropped} stop words dropped; HashingTF and StopWordsRemover equal their "
        f"numpy replays, IDF its float32 product; accuracy {accuracy:.4f}")
    check(accuracy > TEXT_ACCURACY, f"text path accuracy {accuracy} <= {TEXT_ACCURACY}")
    fits = [synced(fit)[1] for _ in range(TEXT_REPEATS)]
    transforms = [synced(lambda: model.transform(table)[0])[1] for _ in range(TEXT_REPEATS)]
    log(f"  text path warm: fit median {float(np.median(fits)):.3f} ms (runs "
        f"{[round(t, 3) for t in fits]}), transform median {float(np.median(transforms)):.3f} ms "
        f"(runs {[round(t, 3) for t in transforms]})")
    profile_run("text fit", fit)
    profile_run("text transform", lambda: model.transform(table)[0])
    return {"fit_ms": run["fit_ms"], "transform_ms": run["transform_ms"],
            "warm_fit_ms": float(np.median(fits)), "warm_transform_ms": float(np.median(transforms)),
            "fit_runs": fits, "transform_runs": transforms, "launches": counts,
            "accuracy": accuracy, "dropped_tokens": dropped,
            "seconds": time.perf_counter() - t0}


def text_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run) for
    each of the nine stages at its conf/ shape: token matrices born on the
    card, string and number columns made by seeded numpy on the host."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.ops import tokens
    from flink_ml_tpu_torch.table import DictTokenMatrix

    def token_table(shape, seed=CONF_SEED):
        rows, k, m = shape
        return Table({"input": DictTokenMatrix(string_vocab(m),
                                               tokens.random_token_ids(seed, rows, k, m, dev))})

    def countvectorizer():
        table = token_table(CV_SHAPE)
        ids = table.column("input").ids
        vocab = table.column("input").vocab
        stage = feature_module("countvectorizer").CountVectorizer().set_input_col("input") \
            .set_output_col("output")

        def verify(run):
            m = vocab.size
            tf = torch.bincount(ids.reshape(-1).long(), minlength=m)
            df = torch.zeros(m, dtype=torch.int64, device=dev)
            for s in range(0, ids.shape[0], 1_000_000):
                seen = torch.zeros((min(1_000_000, ids.shape[0] - s), m), dtype=torch.bool, device=dev)
                seen.scatter_(1, ids[s:s + 1_000_000].long(), True)
                df += seen.sum(dim=0)
            tf, df = tf.cpu().numpy(), df.cpu().numpy()
            order = np.lexsort((vocab, -tf))
            want_vocab = [str(vocab[i]) for i in order if df[i] > 0]
            check(run["model"].vocabulary == want_vocab, "countvectorizer vocabulary")
            out = run["out"].column("output")
            lut = torch.as_tensor(np.argsort(order).astype(np.int64), device=dev)
            check(out.indices.shape == (CV_SHAPE[0], min(CV_SHAPE[1], m)), "countvectorizer width")
            for s in range(0, ids.shape[0], 1_000_000):
                e = min(ids.shape[0], s + 1_000_000)
                want = torch.zeros((e - s, m), dtype=torch.float32, device=dev)
                want.scatter_add_(1, lut[ids[s:e].long()], torch.ones((e - s, ids.shape[1]), device=dev))
                idx, val = out.indices[s:e], out.values[s:e]
                got = torch.zeros((e - s, m + 1), dtype=torch.float32, device=dev)
                got.scatter_(1, torch.where(idx >= 0, idx, m).long(), val)
                check(torch.equal(got[:, :m], want), f"countvectorizer counts, rows {s}-{e}")
                nnz = (idx >= 0).sum(dim=1)
                check(torch.equal(nnz, (want > 0).sum(dim=1))
                      and bool((idx[:, 1:] > idx[:, :-1]).logical_or(idx[:, 1:] < 0).all()),
                      f"countvectorizer layout, rows {s}-{e}")
            return {"exact": True, "vocabulary": len(want_vocab)}
        return stage, table, table, ("output",), FEATURE_JAVA + "countvectorizer.CountVectorizerModel", \
            verify

    def ngram():
        table = token_table(NGRAM_SHAPE)
        ids = table.column("input").ids
        vocab = table.column("input").vocab
        stage = feature_module("ngram").NGram().set_input_col("input").set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            m = vocab.size
            check(torch.equal(out.ids, ids[:, :-1] * m + ids[:, 1:]), "ngram codes")
            want = [f"{a} {b}" for a in vocab for b in vocab]
            check(out.vocab.tolist() == want, "ngram vocabulary")
            return {"exact": True, "vocabulary": len(want)}
        return stage, table, table, ("output",), FEATURE_JAVA + "ngram.NGram", verify

    def stopwordsremover():
        table = token_table(SWR_SHAPE)
        ids = table.column("input").ids
        stage = feature_module("stopwordsremover").StopWordsRemover().set_input_cols("input") \
            .set_output_cols("output")

        def verify(run):
            # no decimal term is an English stop word: the ids come back as they are
            check(run["out"].column("output").ids is ids, "stopwordsremover copied its ids")
            return {"exact": True, "dropped": 0}
        return stage, table, table, ("output",), FEATURE_JAVA + "stopwordsremover.StopWordsRemover", \
            verify

    def hashingtf():
        from flink_ml_tpu_torch.models.feature.hashingtf import bucket_lut

        table = token_table(HTF_SHAPE)
        col = table.column("input")
        stage = feature_module("hashingtf").HashingTF().set_input_col("input").set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            lut = bucket_lut(col.vocab, out.size)
            want_i, want_v = term_runs_replay(lut[col.ids.cpu().numpy()], HTF_SHAPE[1])
            check(np.array_equal(out.indices.cpu().numpy(), want_i)
                  and np.array_equal(out.values.cpu().numpy(), want_v), "hashingtf replay")
            return {"exact": True}
        return stage, table, table, ("output",), FEATURE_JAVA + "hashingtf.HashingTF", verify

    def idf():
        rows, d = IDF_SHAPE
        X = torch.rand((rows, d), generator=seeded(CONF_SEED, dev), device=dev)
        table = Table({"input": X})
        stage = feature_module("idf").IDF().set_input_col("input").set_output_col("output") \
            .set_min_doc_freq(0)

        def verify(run):
            df = (X != 0).sum(dim=0).double().cpu().numpy()
            idf64 = np.log((rows + 1.0) / (df + 1.0))
            model = run["model"]
            check(np.array_equal(model.doc_freq, df) and np.array_equal(model.idf, idf64),
                  "idf model")
            want = (X.double() * torch.as_tensor(idf64.astype(np.float32), device=dev).double()).float()
            check(torch.equal(run["out"].column("output"), want), "idf transform")
            return {"exact": True}
        return stage, table, table, ("output",), FEATURE_JAVA + "idf.IDFModel", verify

    def featurehasher():
        from flink_ml_tpu_torch.models.feature.featurehasher import _hash_index
        from flink_ml_tpu_torch.models.feature.stringindexer import _java_double_to_string

        rng = np.random.default_rng(CONF_SEED)
        names = [f"f{j}" for j in range(5)]
        cols = {name: rng.random(HASHER_ROWS) for name in names}
        table = Table(cols)
        stage = feature_module("featurehasher").FeatureHasher().set_input_cols(*names) \
            .set_categorical_cols("f0", "f1", "f2").set_num_features(HASHER_FEATURES) \
            .set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            check(out.indices.shape == (HASHER_ROWS, 5), "featurehasher width")
            idx, val = out.indices[:HOST_REPLAY_ROWS], out.values[:HOST_REPLAY_ROWS]
            for r in range(HOST_REPLAY_ROWS):
                feats = {}
                for name in ("f3", "f4"):
                    b = _hash_index(name, HASHER_FEATURES)
                    feats[b] = feats.get(b, 0.0) + float(cols[name][r])
                for name in ("f0", "f1", "f2"):
                    b = _hash_index(f"{name}={_java_double_to_string(float(cols[name][r]))}",
                                    HASHER_FEATURES)
                    feats[b] = feats.get(b, 0.0) + 1.0
                keys = sorted(feats)
                n = len(keys)
                if (idx[r, :n].tolist() != keys or (idx[r, n:] != -1).any()
                        or val[r, :n].tolist() != [feats[k] for k in keys]):
                    check(False, f"featurehasher row {r} differs from its replay")
            return {"exact": True, "replayed_rows": HOST_REPLAY_ROWS}
        return stage, table, table, ("output",), FEATURE_JAVA + "featurehasher.FeatureHasher", verify

    def strings(rows, distinct, seed=CONF_SEED):
        vocab = string_vocab(distinct)
        return vocab[np.random.default_rng(seed).integers(0, distinct, rows)]

    def regextokenizer():
        import re

        S = strings(REGEX_ROWS, REGEX_DISTINCT)
        table = Table({"input": S})
        stage = feature_module("regextokenizer").RegexTokenizer().set_input_col("input") \
            .set_output_col("output").set_pattern("1+")

        def verify(run):
            out = run["out"].column("output")
            check(len(out) == REGEX_ROWS, "regextokenizer rows")
            for r in range(HOST_REPLAY_ROWS):
                want = [t for t in re.split("1+", str(S[r]).lower()) if len(t) >= 1]
                check(list(out[r]) == want, f"regextokenizer row {r}")
            return {"exact": True, "replayed_rows": HOST_REPLAY_ROWS}
        return stage, table, table, ("output",), FEATURE_JAVA + "regextokenizer.RegexTokenizer", \
            verify

    def tokenizer():
        S = strings(TOKENIZER_ROWS, TOKENIZER_DISTINCT)
        table = Table({"input": S})
        stage = feature_module("tokenizer").Tokenizer().set_input_col("input").set_output_col("output")

        def verify(run):
            out = run["out"].column("output")
            check([list(t) for t in out] == [str(s).lower().split(" ") for s in S], "tokenizer")
            return {"exact": True, "replayed_rows": TOKENIZER_ROWS}
        return stage, table, table, ("output",), FEATURE_JAVA + "tokenizer.Tokenizer", verify

    def stringindexer():
        S = strings(INDEXER_ROWS, INDEXER_DISTINCT)
        table = Table({"input": S})
        stage = feature_module("stringindexer").StringIndexer().set_input_cols("input") \
            .set_output_cols("output").set_string_order_type("frequencyDesc")

        def verify(run):
            uniq, inv, cnt = np.unique(S, return_inverse=True, return_counts=True)
            order = sorted(range(uniq.size), key=lambda i: (-cnt[i], str(uniq[i])))
            check(run["model"].string_arrays == [[str(uniq[i]) for i in order]],
                  "stringindexer order")
            rank = np.empty(uniq.size, np.float64)
            rank[order] = np.arange(uniq.size)
            check(np.array_equal(run["out"].column("output"), rank[inv.reshape(-1)]),
                  "stringindexer transform")
            return {"exact": True}
        return stage, table, table, ("output",), FEATURE_JAVA + "stringindexer.StringIndexerModel", \
            verify

    return {
        "countvectorizer": countvectorizer,
        "featurehasher": featurehasher,
        "hashingtf": hashingtf,
        "idf": idf,
        "ngram": ngram,
        "regextokenizer": regextokenizer,
        "stopwordsremover": stopwordsremover,
        "stringindexer": stringindexer,
        "tokenizer": tokenizer,
    }


#: the text stages given a torch.profiler pass, and the call profiled
TEXT_PROFILES = {"countvectorizer": "fit", "ngram": "transform", "hashingtf": "transform"}


def text_phase(sk, dev, tmp):
    """Phase 7: the text path (text_path), then each of the nine string and
    token stages at its conf/ shape (drive_feature, then its replay)."""
    results = {"text path": text_path(sk, dev, tmp)}
    torch.cuda.empty_cache()
    for name, make in text_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java)
        checks = verify(run)
        if name in TEXT_PROFILES:
            call = TEXT_PROFILES[name]
            profile_run(f"{name} {call}", (lambda: stage.fit(fit_table)) if call == "fit"
                        else (lambda: run["model"].transform(table)[0]))
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
        torch.cuda.empty_cache()
    return results


# -- 8. the statistics slice and the evaluation path --------------------------------

#: the evaluation path: the text path's table split by RandomSplitter, the
#: text pipeline fitted on the first part, the second part scored
EVAL_WEIGHTS, EVAL_SEED = (0.8, 0.2), 37
EVAL_METRICS = ("areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz")
EVAL_AUC = 0.9
#: the evaluator's metrics against the float64 numpy oracle (its sums are
#: float64 on the card, ROADMAP C.11)
METRIC_TOL = 1e-9
EVAL_REPEATS = 3
#: the new stages at their conf/ shapes
NB_SHAPE = (1_000_000, 10, 5, 2)  # naivebayes: rows, vectorDim, featureArity, labelArity
UFS_SHAPE = (10_000_000, 100, 10)  # univariatefeatureselector: rows, vectorDim, labelArity
KNN_SHAPE = (20_000, 50, 2, 5)  # knn: rows, vectorDim, labelArity, k (its default)
#: the three stats stages and RandomSplitter have no conf/ file: 1M rows
STATS_SHAPE = (1_000_000, 10)
CHISQ_ARITY, CHISQ_LABELS, ANOVA_LABELS = 5, 2, 10
SPLIT_ROWS = 1_000_000
#: a statistic against its float64 replay, each relative to itself; a
#: p-value as max |error| over the largest replayed p-value (a p-value
#: far below 1 moves by exp(-F/2) and is not held relative to itself)
STAT_REL_TOL = 1e-6
#: UnivariateFeatureSelector: its float32 F-statistics against the float64
#: replay, and the p-value margin around the cut inside which a swap of
#: two features is rounding, not a fault
UFS_F_TOL, UFS_CUT_MARGIN = 1e-4, 1e-6
STATS_JAVA = "org.apache.flink.ml.stats."
#: the stages of phase 8 given a torch.profiler pass, and the call profiled
STATS_PROFILES = {"univariatefeatureselector": "fit"}


def host_counts():
    """The host paths the JAX package itself takes, counted where the port
    takes them (NaiveBayes' conditions and gap rescore, the chi-square
    test)."""
    from collections import Counter

    from flink_ml_tpu_torch.models.classification import naivebayes
    from flink_ml_tpu_torch.ops import stats

    return Counter(naivebayes.HOST_COUNTS) + Counter(stats.HOST_COUNTS)


def counts_since(before):
    after = host_counts()
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def split_replay(rows, weights, seed):
    """numpy replay of RandomSplitter's draw: each part's row indices."""
    fractions = np.cumsum(weights) / np.sum(weights)
    draws = np.random.RandomState(seed % 2**32).random_sample(rows)
    lower = 0.0
    parts = []
    for upper in fractions:
        parts.append(np.nonzero((draws >= lower) & (draws < upper))[0])
        lower = upper
    return parts


def eval_path(sk, dev, tmp):
    """Phase 8's main path: RandomSplitter -> the text pipeline fitted on
    the train part -> transform of the test part ->
    BinaryClassificationEvaluator -> save -> load -> transform -> evaluate,
    with the launch counts reset before and read after; its gates, warm
    times and a profiler pass."""
    from flink_ml_tpu_torch import PipelineModel, Table
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator, binary_metrics)
    from flink_ml_tpu_torch.models.feature.randomsplitter import RandomSplitter

    t0 = time.perf_counter()
    table = text_corpus(TEXT_ROWS, dev)
    splitter = RandomSplitter().set_weights(*EVAL_WEIGHTS).set_seed(EVAL_SEED)
    evaluator = BinaryClassificationEvaluator().set_metrics_names(*EVAL_METRICS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    (train, test), split_ms = synced(lambda: splitter.transform(table))
    model, fit_ms = synced(lambda: text_pipeline().fit(train))
    out, transform_ms = synced(lambda: model.transform(test)[0])
    metrics, evaluate_ms = synced(lambda: evaluator.transform(out)[0].collect()[0])
    path = os.path.join(tmp, "eval")
    model.save(path)
    loaded = PipelineModel.load(path)
    again = loaded.transform(test)[0]
    metrics_again = evaluator.transform(again)[0].collect()[0]
    torch.cuda.synchronize()
    counts = sk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  eval path: split {split_ms:.1f} ms ({train.num_rows} / {test.num_rows} rows), fit "
        f"{fit_ms:.1f} ms, transform {transform_ms:.1f} ms, evaluate {evaluate_ms:.1f} ms (first "
        f"calls); launches {counts}; peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    check(counts == TEXT_LAUNCHES, f"eval path launched {counts}, expected {TEXT_LAUNCHES} (20 "
          f"epochs of the fit on the train part, a row dot a transform of the test part)")
    for col in ("prediction", "rawPrediction"):
        check(same_column(again.column(col), out.column(col)), f"eval path {col} differs after save/load")
    metrics = {k: float(v) for k, v in metrics.items()}
    check({k: float(v) for k, v in metrics_again.items()} == metrics,
          "eval path metrics differ after save/load")
    # the split, row for row, against the numpy replay of the draw
    ids, label = table.column("tokens").ids, table.column("label")
    for name, part, rows in zip(("train", "test"), (train, test),
                                split_replay(TEXT_ROWS, EVAL_WEIGHTS, EVAL_SEED)):
        sel = torch.as_tensor(rows, device=dev)
        check(part.num_rows == rows.size and torch.equal(part.column("tokens").ids, ids[sel])
              and torch.equal(part.column("label"), label[sel]),
              f"eval path {name} split differs from the numpy replay")
    # the fit on the train part against the same fit on the plain loss
    feats = text_features(model, train)["features"]
    lr = model.stages[-1]
    train_out = lr.transform(Table({"features": feats}))[0]
    check_sparse_linear("lr", {"model": lr, "out": train_out}, feats.indices, feats.values,
                        train.column("label"), dim=feats.size)
    # the metrics against the float64 numpy oracle on the same scores
    scores = out.column("rawPrediction")[:, 1].double().cpu().numpy()
    labels = test.column("label").double().cpu().numpy()
    oracle = binary_metrics(scores, labels, np.ones_like(labels))
    metric_err = max(abs(metrics[k] - oracle[k]) for k in EVAL_METRICS)
    log(f"  eval path metrics {json.dumps(metrics)}; max |port - float64 oracle| {metric_err:.3g}")
    check(metric_err <= METRIC_TOL, f"eval path metrics differ from the float64 oracle by {metric_err}")
    check(metrics["areaUnderROC"] > EVAL_AUC, f"held-out AUC {metrics['areaUnderROC']} <= {EVAL_AUC}")
    warm = {}
    for name, call in (("split", lambda: splitter.transform(table)),
                       ("fit", lambda: text_pipeline().fit(train)),
                       ("transform", lambda: model.transform(test)[0]),
                       ("evaluate", lambda: evaluator.transform(out)[0])):
        runs = [synced(call)[1] for _ in range(EVAL_REPEATS)]
        warm[name] = {"median_ms": float(np.median(runs)), "runs": runs}
    log("  eval path warm medians: " + "; ".join(
        f"{k} {v['median_ms']:.3f} ms (runs {[round(t, 3) for t in v['runs']]})" for k, v in warm.items()))

    def whole():
        tr, te = splitter.transform(table)
        return evaluator.transform(text_pipeline().fit(tr).transform(te)[0])[0]
    profile_run("eval path (split, fit, transform, evaluate)", whole)
    return {"split_ms": split_ms, "fit_ms": fit_ms, "transform_ms": transform_ms,
            "evaluate_ms": evaluate_ms, "warm": warm, "launches": counts, "metrics": metrics,
            "metric_err": metric_err, "peak_gib": peak, "train_rows": train.num_rows,
            "test_rows": test.num_rows, "seconds": time.perf_counter() - t0}


def anova64(X, y, k):
    """float64 one-way ANOVA on the card (two passes: the exact mean, then
    the centred class sums), labels 0..k-1: (F, p)."""
    from flink_ml_tpu_torch.ops.stats import f_sf

    n, d = X.shape
    mean = sum(X[s:s + 1_000_000].double().sum(dim=0) for s in range(0, n, 1_000_000)) / n
    sums = torch.zeros((k, d), dtype=torch.float64, device=X.device)
    ss_tot = torch.zeros(d, dtype=torch.float64, device=X.device)
    for s in range(0, n, 1_000_000):
        Xc = X[s:s + 1_000_000].double() - mean
        sums += torch.nn.functional.one_hot(y[s:s + 1_000_000].long(), k).double().T @ Xc
        ss_tot += (Xc * Xc).sum(dim=0)
    counts = torch.bincount(y.long(), minlength=k).double()
    ss_between = (sums**2 / counts[:, None]).sum(dim=0) - sums.sum(dim=0) ** 2 / n
    f = ((ss_between / (k - 1)) / ((ss_tot - ss_between) / (n - k))).cpu().numpy()
    return f, f_sf(f, float(k - 1), float(n - k))


def fvalue64(X, y):
    """float64 univariate regression F-test on the card: (F, p)."""
    from flink_ml_tpu_torch.ops.stats import f_sf

    n = X.shape[0]
    X64, y64 = X.double(), y.double()
    Xc, yc = X64 - X64.mean(dim=0), y64 - y64.mean()
    corr = ((Xc * yc[:, None]).sum(dim=0) / torch.sqrt((Xc**2).sum(dim=0) * (yc**2).sum())).cpu().numpy()
    f = corr**2 / (1 - corr**2) * (n - 2)
    return f, f_sf(f, 1.0, float(n - 2))


def chisq64(X, y, arity, labels):
    """Integer contingency counts on the card (feature arity x label arity
    a column) and the float64 statistics from them: (counts, stat, p, dof)."""
    from flink_ml_tpu_torch.ops.stats import chi2_sf

    n, d = X.shape
    counts = [torch.bincount(X[:, j].long() * labels + y.long(), minlength=arity * labels)
              .reshape(arity, labels).cpu().numpy() for j in range(d)]
    stat = []
    for observed in counts:
        o = observed.astype(np.float64)
        expected = o.sum(axis=1, keepdims=True) * o.sum(axis=0, keepdims=True) / n
        stat.append(float(np.sum((o - expected) ** 2 / expected)))
    dof = (arity - 1) * (labels - 1)
    stat = np.asarray(stat)
    return counts, stat, chi2_sf(stat, float(dof)), dof


def stat_errors(stat, stat64, p, p64):
    """(max relative error of the statistics, max |p - p64| / max p64)."""
    rel = float(np.max(np.abs(stat - stat64) / np.maximum(np.abs(stat64), 1e-300)))
    return rel, float(np.max(np.abs(p - p64)) / max(float(np.max(np.abs(p64))), 1e-300))


def stats_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run) for
    each stage of phase 8 at its shape, on data born on the card."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.models.classification import knn, naivebayes
    from flink_ml_tpu_torch.models.feature import randomsplitter
    from flink_ml_tpu_torch.models.feature import univariatefeatureselector as ufs
    from flink_ml_tpu_torch.models.stats import anovatest, chisqtest, fvaluetest
    from flink_ml_tpu_torch.ops import stats, tokens
    from flink_ml_tpu_torch.table import DictTokenMatrix

    def naivebayes_spec():
        rows, d, arity, num_labels = NB_SHAPE
        gen = seeded(CONF_SEED, dev)
        X = torch.randint(0, arity, (rows, d), generator=gen, device=dev).float()
        y = torch.randint(0, num_labels, (rows,), generator=gen, device=dev).float()
        table = Table({"features": X, "label": y})
        stage = naivebayes.NaiveBayes()
        before = host_counts()

        def verify(run):
            model, s = run["model"], stage.get_smoothing()
            labels = torch.unique(y)
            cats = [torch.unique(X[:, j]) for j in range(d)]
            label_counts = [int((y == l).sum()) for l in labels]
            theta = []
            for i, l in enumerate(labels):
                rows_l = X[y == l]
                theta.append([{float(v): math.log(int((rows_l[:, j] == v).sum()) + s)
                               - math.log(label_counts[i] + s * cats[j].numel())
                               for v in cats[j]} for j in range(d)])
            pi = [math.log(c * d + s) - math.log(rows * d + labels.numel() * s) for c in label_counts]
            check(model.theta == theta and model.pi.tolist() == pi
                  and model.labels.tolist() == labels.double().cpu().tolist(),
                  "naivebayes model data differs from its integer replay")
            # the float64 argmax on the card
            scores = torch.as_tensor(pi, dtype=torch.float64, device=dev).repeat(rows, 1)
            for j in range(d):
                logp = torch.as_tensor([[theta[i][j][float(v)] for i in range(labels.numel())]
                                        for v in cats[j]], dtype=torch.float64, device=dev)
                scores += logp[torch.searchsorted(cats[j], X[:, j].contiguous())]
            want = labels[torch.argmax(scores, dim=1)]
            pred = run["out"].column("prediction")
            check(torch.equal(pred, want), "naivebayes predictions differ from the float64 argmax")
            host = counts_since(before)
            log(f"    naivebayes host paths over its runs: {host}")
            return {"exact": True, "host_paths": host}
        return stage, table, table, ("prediction",), \
            "org.apache.flink.ml.classification.naivebayes.NaiveBayesModel", verify

    def univariatefeatureselector_spec():
        rows, d, k = UFS_SHAPE
        gen = seeded(CONF_SEED, dev)
        X = torch.rand((rows, d), generator=gen, device=dev)
        y = torch.randint(0, k, (rows,), generator=gen, device=dev).float()
        table = Table({"features": X, "label": y})
        stage = ufs.UnivariateFeatureSelector().set_feature_type("continuous") \
            .set_label_type("categorical")

        def verify(run):
            _, _, f = stats.anova_f_test(X, y)  # the fit's statistics
            f64, p64 = anova64(X, y, k)
            f_err = float(np.max(np.abs(f - f64) / np.abs(f64)))
            top = int(ufs._DEFAULT_THRESHOLDS[ufs.NUM_TOP_FEATURES])
            cut = np.sort(p64)[top - 1]
            near = set(np.nonzero(np.abs(p64 - cut) <= UFS_CUT_MARGIN * cut)[0].tolist())
            want = set(np.argsort(p64, kind="stable")[:top].tolist())
            got = set(run["model"].indices.tolist())
            swapped = got ^ want
            log(f"    univariatefeatureselector: F max rel err {f_err:.3g}; {len(near)} features "
                f"within {UFS_CUT_MARGIN} of the cut p-value {cut:.6g}; {len(swapped)} swapped")
            check(f_err <= UFS_F_TOL, f"univariatefeatureselector F rel err {f_err}")
            check(len(got) == top and swapped <= near, "univariatefeatureselector selection")
            sel = torch.as_tensor(run["model"].indices, device=dev)
            check(torch.equal(run["out"].column("output"), X[:, sel]), "univariatefeatureselector gather")
            return {"f_rel_err": f_err, "near_cut": len(near), "swapped": len(swapped)}
        return stage, table, table, ("output",), \
            FEATURE_JAVA + "univariatefeatureselector.UnivariateFeatureSelectorModel", verify

    def knn_spec():
        rows, d, num_labels, k = KNN_SHAPE
        gen = seeded(CONF_SEED, dev)
        X = torch.rand((rows, d), generator=gen, device=dev)
        y = torch.randint(0, num_labels, (rows,), generator=gen, device=dev).float()
        table = Table({"features": X, "label": y})
        stage = knn.Knn().set_k(k)

        def verify(run):
            pred = run["out"].column("prediction")
            X64 = X.double()
            sq = (X64 * X64).sum(dim=1)
            margin = 0
            for s in range(0, rows, 2_000):
                D = sq[s:s + 2_000, None] - 2.0 * (X64[s:s + 2_000] @ X64.T) + sq[None, :]
                vals, idx = torch.topk(D, k + 1, dim=1, largest=False, sorted=True)
                tie = ((vals[:, k] - vals[:, k - 1]) <= TIE_MARGIN * vals[:, k].abs()).cpu().numpy()
                want = knn._majority_vote(y[idx[:, :k]].double().cpu().numpy())
                margin += int(tie.sum())
                check(np.array_equal(pred[s:s + 2_000][~tie], want[~tie]),
                      f"knn predictions differ from the float64 neighbours, rows {s}-{s + 2_000}")
            log(f"    knn: {margin} rows with their k-th and (k+1)-th float64 distances within "
                f"{TIE_MARGIN} left out")
            return {"margin_rows": margin}
        return stage, table, table, ("prediction",), \
            "org.apache.flink.ml.classification.knn.KnnModel", verify

    def stats_spec(kind, flatten):
        rows, d = STATS_SHAPE
        gen = seeded(CONF_SEED, dev)
        if kind == "chisq":
            X = torch.randint(0, CHISQ_ARITY, (rows, d), generator=gen, device=dev).float()
            y = torch.randint(0, CHISQ_LABELS, (rows,), generator=gen, device=dev).float()
            stage, stat_col = chisqtest.ChiSqTest(), "statistic"
        elif kind == "anova":
            X = torch.rand((rows, d), generator=gen, device=dev)
            y = torch.randint(0, ANOVA_LABELS, (rows,), generator=gen, device=dev).float()
            stage, stat_col = anovatest.ANOVATest(), "fValue"
        else:  # every column tied to the label, some weakly: every F large
            X = torch.rand((rows, d), generator=gen, device=dev)
            w = torch.linspace(0.02, 0.3, d, device=dev)
            y = X @ w + torch.rand(rows, generator=gen, device=dev)
            stage, stat_col = fvaluetest.FValueTest(), "fValue"
        stage.set_flatten(flatten)
        table = Table({"features": X, "label": y})
        cols = (("featureIndex", "pValue", "degreeOfFreedom", stat_col) if flatten
                else ("pValues", "degreesOfFreedom", stat_col + "s"))
        before = host_counts()

        def verify(run):
            out = run["out"]
            if flatten:
                p, stat, dof = (np.asarray(out.column(c), np.float64) for c in
                                ("pValue", stat_col, "degreeOfFreedom"))
            else:
                p, stat, dof = (np.asarray(out.column(c)[0], np.float64) for c in
                                ("pValues", stat_col + "s", "degreesOfFreedom"))
            result = {}
            if kind == "chisq":
                counts, stat64, p64, dof64 = chisq64(X, y, CHISQ_ARITY, CHISQ_LABELS)
                port_counts = list(stats.contingency_tables(X, y))
                check(all(np.array_equal(a, b) for a, b in zip(port_counts, counts)),
                      "chisqtest counts differ from the integer replay")
                result["host_paths"] = counts_since(before)
                log(f"    chisqtest host paths over its runs: {result['host_paths']}")
            elif kind == "anova":
                stat64, p64 = anova64(X, y, ANOVA_LABELS)
                dof64 = rows - 1
            else:
                stat64, p64 = fvalue64(X, y)
                dof64 = rows - 2
            stat_err, p_err = stat_errors(stat, stat64, p, p64)
            check(np.array_equal(dof, np.full(d, dof64)), f"{kind} degrees of freedom {dof}")
            check(stat_err <= STAT_REL_TOL and p_err <= STAT_REL_TOL,
                  f"{kind} statistics rel err {stat_err}, p-values {p_err}")
            result.update(stat_rel_err=stat_err, p_err=p_err)
            return result
        name = {"chisq": "chisqtest.ChiSqTest", "anova": "anovatest.ANOVATest",
                "fvalue": "fvaluetest.FValueTest"}[kind]
        return stage, table, table, cols, STATS_JAVA + name, verify

    def randomsplitter_spec():
        rows = SPLIT_ROWS
        gen = seeded(CONF_SEED, dev)
        table = Table({
            "dense": torch.rand((rows, DIM), generator=gen, device=dev),
            "sparse": SparseBatch(SPARSE_DIM, torch.randint(0, SPARSE_DIM, (rows, NNZ), generator=gen,
                                                             device=dev, dtype=torch.int32),
                                  torch.rand((rows, NNZ), generator=gen, device=dev)),
            "tokens": DictTokenMatrix(string_vocab(TEXT_TERMS),
                                      tokens.random_token_ids(CONF_SEED, rows, TEXT_TOKENS, TEXT_TERMS, dev)),
            "label": torch.arange(rows, device=dev, dtype=torch.float64)})
        stage = randomsplitter.RandomSplitter().set_weights(*EVAL_WEIGHTS).set_seed(EVAL_SEED)

        def verify(run):
            parts = stage.transform(table)
            for part, rows_i in zip(parts, split_replay(rows, EVAL_WEIGHTS, EVAL_SEED)):
                sel = torch.as_tensor(rows_i, device=dev)
                sparse = table.column("sparse")
                check(part.num_rows == rows_i.size
                      and torch.equal(part.column("dense"), table.column("dense")[sel])
                      and torch.equal(part.column("sparse").indices, sparse.indices[sel])
                      and torch.equal(part.column("sparse").values, sparse.values[sel])
                      and torch.equal(part.column("tokens").ids, table.column("tokens").ids[sel])
                      and torch.equal(part.column("label"), table.column("label")[sel]),
                      "randomsplitter parts differ from the numpy replay")
            return {"exact": True, "rows": [p.num_rows for p in parts]}
        return stage, table, table, ("dense", "sparse", "tokens", "label"), \
            FEATURE_JAVA + "randomsplitter.RandomSplitter", verify

    specs = {"naivebayes": naivebayes_spec,
             "univariatefeatureselector": univariatefeatureselector_spec,
             "knn": knn_spec}
    for kind, stage_name in (("chisq", "chisqtest"), ("anova", "anovatest"), ("fvalue", "fvaluetest")):
        for flatten in (False, True):
            specs[stage_name + (" flatten" if flatten else "")] = \
                lambda k=kind, f=flatten: stats_spec(k, f)
    specs["randomsplitter"] = randomsplitter_spec
    return specs


def functions_check(dev):
    """vector_to_array / array_to_vector on the card's layouts: a tensor
    passes through, a SparseBatch densifies to its scatter, ragged rows
    round-trip."""
    from flink_ml_tpu_torch import DenseVector, SparseBatch, array_to_vector, vector_to_array

    X = torch.rand((STATS_SHAPE[0], DIM), generator=seeded(CONF_SEED, dev), device=dev)
    check(vector_to_array(X) is X and array_to_vector(X) is X, "functions moved a tensor column")
    gen = seeded(CONF_SEED + 1, dev)
    # distinct indices a row (a repeated index would leave the scatter's
    # winner to the card's order), about a tenth of them padding
    idx = torch.argsort(torch.rand((10_000, 500), generator=gen, device=dev), dim=1)[:, :NNZ]
    pad = torch.rand((10_000, NNZ), generator=gen, device=dev) < 0.1
    idx = torch.where(pad, -1, idx).to(torch.int32)
    vals = torch.rand((10_000, NNZ), generator=gen, device=dev)
    dense = vector_to_array(SparseBatch(500, idx, vals))
    keep = idx >= 0
    want = torch.zeros((10_000, 501), dtype=torch.float64, device=dev)
    want.scatter_(1, torch.where(keep, idx, 500).long(), torch.where(keep, vals, 0.0).double())
    check(np.array_equal(dense, want[:, :500].cpu().numpy()), "vector_to_array of a SparseBatch")
    ragged = np.empty(3, dtype=object)
    ragged[:] = [DenseVector([1.0, 2.0]), DenseVector([3.0]), DenseVector([4.0, 5.0, 6.0])]
    back = array_to_vector(vector_to_array(ragged))
    check([list(v.to_array()) for v in back] == [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]],
          "functions ragged round trip")
    log("  functions.py: a tensor passes through both ways, a SparseBatch densifies to its "
        "scatter, ragged vectors round-trip")
    return {"exact": True}


def stats_phase(sk, dev, tmp):
    """Phase 8: the evaluation path (eval_path), then each new stage at its
    shape (drive_feature, then its replay), then the functions."""
    results = {"eval path": eval_path(sk, dev, tmp)}
    torch.cuda.empty_cache()
    for name, make in stats_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java)
        checks = verify(run)
        if name in STATS_PROFILES:
            call = STATS_PROFILES[name]
            profile_run(f"{name} {call}", (lambda: stage.fit(fit_table)) if call == "fit"
                        else (lambda: run["model"].transform(table)[0]))
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
        torch.cuda.empty_cache()
    results["functions"] = functions_check(dev)
    return results


# -- 8b. the evaluation Graph -------------------------------------------------------------

GRAPH_JAVA = "org.apache.flink.ml.builder.GraphModel"
#: a GraphModel transform scores the test features twice: the LR node and its
#: model-data twin, one row dot each
GRAPH_TRANSFORM_LAUNCHES = launch_dict(sparse_row_dots=2)
#: the Graph's metrics against phase 8's evaluation path in the same run: the
#: same split and fit, but the gradient's atomics order its float32 sums anew
GRAPH_EVAL_TOL = 1e-6


def eval_graph():
    """Phase 8b's Graph: RandomSplitter (0.8, 0.2) with two outputs ->
    StopWordsRemover and HashingTF on each part -> IDF fitted on the train
    part, transforming the test part (a twin IDF node carries the train
    features) -> LogisticRegression (the conf/ params) fitted on the train
    features, transforming the test features -> BinaryClassificationEvaluator;
    the LR's model data feeds a twin LogisticRegressionModel that scores the
    test features again. Outputs: metrics, predictions, the twin's
    predictions, the train features."""
    from flink_ml_tpu_torch.graph import GraphBuilder
    from flink_ml_tpu_torch.models.classification.logisticregression import (
        LogisticRegression, LogisticRegressionModel)
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator)
    from flink_ml_tpu_torch.models.feature.randomsplitter import RandomSplitter

    f = feature_module
    b = GraphBuilder()
    source = b.create_table_id()
    train, test = b.add_algo_operator(
        RandomSplitter().set_weights(*EVAL_WEIGHTS).set_seed(EVAL_SEED), source)[:2]

    def term_frequencies(part):
        words = b.add_algo_operator(f("stopwordsremover").StopWordsRemover().set_input_cols("tokens")
                                    .set_output_cols("words"), part)[0]
        return b.add_algo_operator(f("hashingtf").HashingTF().set_input_col("words")
                                   .set_output_col("tf"), words)[0]

    tf_train, tf_test = term_frequencies(train), term_frequencies(test)
    feats_test = b.add_estimator(f("idf").IDF().set_input_col("tf").set_output_col("features"),
                                 [tf_train], [tf_test])[0]
    feats_train = b.add_estimator(f("idf").IDF().set_input_col("tf").set_output_col("features"),
                                  [tf_train], [tf_train])[0]
    lr = estimator(LogisticRegression)
    pred = b.add_estimator(lr, [feats_train], [feats_test])[0]
    twin = LogisticRegressionModel()
    b.set_model_data_on_model(twin, b.get_model_data_from_estimator(lr)[0])
    twin_pred = b.add_algo_operator(twin, feats_test)[0]
    metrics = b.add_algo_operator(
        BinaryClassificationEvaluator().set_metrics_names(*EVAL_METRICS), pred)[0]
    return b.build_estimator([source], [metrics, pred, twin_pred, feats_train])


def graph_lr(model):
    """The fitted LR of the evaluation GraphModel (the estimator node's)."""
    return next(n.stage for n in model.nodes
                if n.estimator_input_ids is not None and hasattr(n.stage, "coefficient"))


def graph_path(sk, dev, tmp, eval_metrics):
    """Phase 8b: the evaluation Graph, Graph.fit -> GraphModel.transform ->
    save -> load -> transform, with the launch counts reset before the fit
    and read after it, and again around one transform; its gates, warm
    times and a profiler pass."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.graph import GraphModel
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import binary_metrics

    t0 = time.perf_counter()
    table = text_corpus(TEXT_ROWS, dev)
    graph = eval_graph()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    model, fit_ms = synced(lambda: graph.fit(table))
    counts = sk.launch_counts()
    sk.reset_launch_counts()
    (metrics_t, pred, twin, feats), transform_ms = synced(lambda: model.transform(table))
    transform_counts = sk.launch_counts()
    path = os.path.join(tmp, "graph")
    model.save(path)
    with open(os.path.join(path, "metadata")) as fh:
        class_name = json.load(fh)["className"]
    again = GraphModel.load(path).transform(table)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    metrics = {k: float(v) for k, v in metrics_t.collect()[0].items()}
    log(f"  graph path: fit {fit_ms:.1f} ms, transform {transform_ms:.1f} ms (first calls; "
        f"{pred.num_rows} test rows); launches: fit {counts}, a transform {transform_counts}; "
        f"peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    check(counts == TEXT_LAUNCHES, f"graph fit launched {counts}, expected {TEXT_LAUNCHES} (20 epochs, "
          f"a row dot for the LR node's transform and one for its model-data twin's)")
    check(transform_counts == GRAPH_TRANSFORM_LAUNCHES,
          f"a GraphModel transform launched {transform_counts}, expected {GRAPH_TRANSFORM_LAUNCHES}")
    check(class_name == GRAPH_JAVA, f"graph model saved as {class_name}")
    for name in ("prediction", "rawPrediction"):
        check(same_column(twin.column(name), pred.column(name)),
              f"graph twin {name} differs from the LR node's")
        check(same_column(again[1].column(name), pred.column(name))
              and same_column(again[2].column(name), twin.column(name)),
              f"graph {name} differs after save/load")
    check({k: float(v) for k, v in again[0].collect()[0].items()} == metrics,
          "graph metrics differ after save/load")
    # the LR on the train features against the same fit on the plain loss
    lr = graph_lr(model)
    f = feats.column("features")
    train_out = lr.transform(Table({"features": f}))[0]
    check_sparse_linear("lr", {"model": lr, "out": train_out}, f.indices, f.values,
                        feats.column("label"), dim=f.size)
    scores = pred.column("rawPrediction")[:, 1].double().cpu().numpy()
    labels = pred.column("label").double().cpu().numpy()
    oracle = binary_metrics(scores, labels, np.ones_like(labels))
    metric_err = max(abs(metrics[k] - oracle[k]) for k in EVAL_METRICS)
    eval_err = max(abs(metrics[k] - eval_metrics[k]) for k in EVAL_METRICS)
    log(f"  graph metrics {json.dumps(metrics)}; max |port - float64 oracle| {metric_err:.3g}; max "
        f"|graph - phase 8 eval path| {eval_err:.3g}")
    check(metric_err <= METRIC_TOL, f"graph metrics differ from the float64 oracle by {metric_err}")
    check(eval_err <= GRAPH_EVAL_TOL, f"graph metrics differ from the eval path's by {eval_err}")
    check(metrics["areaUnderROC"] > EVAL_AUC, f"graph held-out AUC {metrics['areaUnderROC']}")
    fits = [synced(lambda: graph.fit(table))[1] for _ in range(EVAL_REPEATS)]
    transforms = [synced(lambda: model.transform(table))[1] for _ in range(EVAL_REPEATS)]
    log(f"  graph path warm: fit median {float(np.median(fits)):.3f} ms (runs "
        f"{[round(t, 3) for t in fits]}), transform median {float(np.median(transforms)):.3f} ms "
        f"(runs {[round(t, 3) for t in transforms]})")
    profile_run("graph fit", lambda: graph.fit(table))
    profile_run("graph transform", lambda: model.transform(table))
    return {"fit_ms": fit_ms, "transform_ms": transform_ms, "warm_fit_ms": float(np.median(fits)),
            "warm_transform_ms": float(np.median(transforms)), "fit_runs": fits,
            "transform_runs": transforms, "launches": counts, "transform_launches": transform_counts,
            "metrics": metrics, "metric_err": metric_err, "eval_path_err": eval_err,
            "peak_gib": peak, "test_rows": pred.num_rows, "seconds": time.perf_counter() - t0}


# -- 9. AgglomerativeClustering, SQLTransformer, MinHashLSH and the windows ------------------

AGG_SHAPE = (1_000, 100, 10)  # conf/agglomerativeclustering: rows, vectorDim, numClusters; seed 2
#: the ward twin that shows the host scale; 5,000 rows, not 10,000: at
#: 10,000 a transform took 19.9 s on the host of an H100 machine (PERF.md)
AGG_BIG_ROWS = 5_000
AGG_COUNT_WINDOW = 100
AGG_EVENT_SPAN_MS, AGG_EVENT_WINDOW_MS = 10_000, 1_000  # timestamps in [0, span), 10 windows
AGG_THRESHOLD = 3.5  # the distanceThreshold twin (average linkage)
AGG_JAVA = "org.apache.flink.ml.clustering.agglomerativeclustering.AgglomerativeClustering"
#: the merge distances against scipy's linkage, relative to the largest
SCIPY_REL_TOL = 1e-9
SQL_ROWS = 100_000_000  # conf/sqltransformer: one float64 column, seed 2
SQL_STATEMENT = "SELECT *, ABS(v1) AS v2 FROM __THIS__"  # conf/sqltransformer
SQL_WHERE_SHAPE = (10_000_000, 100)  # the WHERE twin: rows, width of the vector column passed through
SQL_WHERE = "SELECT vec, v1, ABS(v1) * 2 AS a FROM __THIS__ WHERE v1 > -0.25 AND NOT v1 > 0.4"
SQL_GROUP_ROWS, SQL_GROUPS = 100_000, 100
SQL_GROUP_BY = "SELECT g, SUM(v) AS s, COUNT(*) AS c FROM __THIS__ GROUP BY g"
SQL_SAMPLE_ROWS = 200_000  # the numpy replay of the conf/ statement: a strided sample
#: MinHashLSH: the reference's own test params (MinHashLSHTest.java), phase
#: 3's sparse shape, 1% of the rows planted as near-duplicates of others
LSH_TABLES, LSH_FUNCTIONS, LSH_SEED = 5, 3, 2022
LSH_ROWS, LSH_CHANGED = 1_000_000, 3  # rows; slots of a planted twin drawn anew
LSH_KEYS, LSH_K = 10, 10
LSH_JOIN_ROWS, LSH_THRESHOLD = 10_000, 0.6
HASH_PRIME = 2038074743
#: window_all_and_process over a 1M-row table: timestamps in [0, 10 x rows) ms
WINDOW_ROWS = 1_000_000
WINDOW_COUNT, WINDOW_TUMBLE_MS, WINDOW_GAP_MS = 1_000, 10_000, 60


def java_random_ints(seed, bound, count):
    """`count` draws of java.util.Random(seed).nextInt(bound) (the 48-bit
    LCG of its specification; bound not a power of two)."""
    mult, mask = 0x5DEECE66D, (1 << 48) - 1
    state, out = (seed ^ mult) & mask, []
    while len(out) < count:
        state = (state * mult + 0xB) & mask
        bits = state >> 17
        val = bits % bound
        if bits - val + (bound - 1) < (1 << 31):
            out.append(val)
    return out


def min_hash64(idx, a, b):
    """int64 numpy min-hash of padded index rows: min over a row's indices of
    ((1 + index) * a + b) % HASH_PRIME, HASH_PRIME for a row of padding."""
    idx = idx.astype(np.int64)[:, :, None]
    vals = ((1 + idx) * a + b) % HASH_PRIME
    return np.where(idx >= 0, vals, HASH_PRIME).min(axis=1)


def min_hash_per_function(idx, a, b):
    """The same hash on the card, one function at a time (the plain version
    of the port's broadcast over functions), in int64."""
    idx = idx.long()
    cols = [torch.where(idx >= 0, ((1 + idx) * int(ai) + int(bi)) % HASH_PRIME, HASH_PRIME).amin(dim=1)
            for ai, bi in zip(a, b)]
    return torch.stack(cols, dim=1)


def jaccard(a, b):
    a, b = set(a.tolist()), set(b.tolist())
    return 1.0 - len(a & b) / len(a | b)


def agg_against_plain(stage, table):
    """The stage's transform with each native merge loop's input kept, then
    the numpy merge loop (the plain version) on each kept input. Returns
    the transform's output, the number of loops run and the first that
    disagrees (None when all agree)."""
    from flink_ml_tpu_torch.models.clustering import agglomerativeclustering as agg

    native, calls = agg.cluster_block_native, []

    def keeping(dist, *args):
        kept = dist.copy()
        result = native(dist, *args)
        calls.append((kept, args, result))
        return result

    agg.cluster_block_native = keeping
    try:
        out = stage.transform(table)
    finally:
        agg.cluster_block_native = native
    for c, (kept, args, (pred, merges)) in enumerate(calls):
        want_pred, want_merges = agg.cluster_block_plain(kept, *args)
        if not np.array_equal(pred, want_pred) or merges != want_merges:
            first = next((m for m, (a, b) in enumerate(zip(merges, want_merges)) if a != b), None)
            return out, len(calls), {"loop": c, "merge": first, "native": merges[first:first + 2]
                                     if first is not None else None,
                                     "plain": want_merges[first:first + 2] if first is not None
                                     else None, "predictions_equal": bool(np.array_equal(
                                         pred, want_pred))}
    return out, len(calls), None


def merge_log(merges):
    return [tuple(np.asarray(merges.column(c)).tolist()) for c in merges.column_names]


def scipy_check(X64, linkage, k, distances, pred):
    """The merge distances against scipy.cluster.hierarchy.linkage (sorted,
    relative to the largest) and the flat partition at k clusters (equal up
    to relabelling)."""
    from scipy.cluster.hierarchy import fcluster
    from scipy.cluster.hierarchy import linkage as scipy_linkage

    n = X64.shape[0]
    Z = scipy_linkage(X64, method=linkage, metric="euclidean")
    got = np.sort(np.asarray(distances, np.float64))
    want = np.sort(Z[: got.size, 2])  # the first merges: numClusters, or the full tree
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want))) if n > k else 0.0
    labels = fcluster(Z, k, criterion="maxclust")
    pred = np.asarray(pred)
    pairs = set(zip(pred.tolist(), labels.tolist()))
    same = len(pairs) == len(set(pred.tolist())) == len(set(labels.tolist()))
    check(got.size in (n - k, n - 1) and rel <= SCIPY_REL_TOL,
          f"{linkage} merge distances differ from scipy's by {rel}")
    check(same, f"{linkage} partition at {k} clusters differs from scipy's fcluster")
    return rel


def slice8_specs(dev):
    """name -> a function that makes (stage, fit table, transform table,
    output columns, the Java class it saves as, the check of its run, the
    warm repeats) for each stage of phase 9, on data born on the card."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.common import window
    from flink_ml_tpu_torch.models.clustering import agglomerativeclustering as agg
    from flink_ml_tpu_torch.models.feature import lsh, sqltransformer

    def agg_spec(linkage="ward", measure="euclidean", rows=None, threshold=None, full_tree=False,
                 windows=None, plain=True):
        def make():
            n, d, k = AGG_SHAPE
            n = rows or n
            X = torch.rand((n, d), generator=seeded(CONF_SEED, dev), device=dev, dtype=torch.float64)
            cols = {"features": X}
            if isinstance(windows, window.EventTimeTumblingWindows):
                cols["timestamp"] = torch.randint(0, AGG_EVENT_SPAN_MS, (n,),
                                                  generator=seeded(CONF_SEED + 1, dev), device=dev)
            table = Table(cols)
            stage = agg.AgglomerativeClustering().set_linkage(linkage).set_distance_measure(measure) \
                .set_num_clusters(k).set_compute_full_tree(full_tree)
            if threshold is not None:
                stage.set_distance_threshold(threshold)
            if windows is not None:
                stage.set_windows(windows)

            def verify(run):
                Xh = X.cpu().numpy()
                if plain:
                    (out, merges), loops, differs = agg_against_plain(stage, table)
                    check(differs is None, "agglomerativeclustering's native merge loop differs "
                          f"from the numpy loop on the same distances: {differs}")
                    again = stage.transform(table)
                    pred, distances = out.column("prediction").cpu().numpy(), merges.column("distance")
                    result = {"plain_exact": True, "loops": loops, "merges": merges.num_rows,
                              "repeats": torch.equal(again[0].column("prediction"), out.column(
                                  "prediction")) and merge_log(again[1]) == merge_log(merges)}
                else:  # the transform's two host parts, timed apart
                    t0 = time.perf_counter()
                    dist = agg.distance_matrix(Xh, measure)
                    t1 = time.perf_counter()
                    pred, log_rows = agg.cluster_block_native(dist, linkage, k, None, False)
                    t2 = time.perf_counter()
                    check(np.array_equal(pred, run["out"].column("prediction").cpu().numpy()),
                          "agglomerativeclustering predictions differ from its merge loop's")
                    distances = [m[2] for m in log_rows]
                    result = {"merges": len(log_rows), "pairwise_ms": (t1 - t0) * 1e3,
                              "loop_ms": (t2 - t1) * 1e3}
                result["clusters"] = int(np.unique(pred).size)
                if windows is None and threshold is None and measure == "euclidean":
                    result["scipy_rel_err"] = scipy_check(Xh, linkage, k, distances, pred)
                log(f"    agglomerativeclustering {linkage}/{measure}: {result}")
                return result
            return stage, table, table, ("prediction",), AGG_JAVA, verify, \
                1 if rows else FEATURE_REPEATS
        return make

    def sql_conf():
        v1 = torch.rand(SQL_ROWS, generator=seeded(CONF_SEED, dev), device=dev, dtype=torch.float64)
        table = Table({"v1": v1})
        stage = sqltransformer.SQLTransformer().set_statement(SQL_STATEMENT)

        def verify(run):
            v2 = run["out"].column("v2")
            check(run["out"].column_names == ["v1", "v2"] and run["out"].column("v1") is v1,
                  "sqltransformer output columns")
            check(torch.equal(v2, v1.abs()), "sqltransformer v2 differs from |v1| on the card")
            rows = torch.arange(0, SQL_ROWS, max(1, SQL_ROWS // SQL_SAMPLE_ROWS), device=dev)
            check(np.array_equal(v2[rows].cpu().numpy(), np.abs(v1[rows].cpu().numpy())),
                  "sqltransformer v2 differs from the numpy replay")
            return {"exact": True, "sample_rows": int(rows.numel())}
        return stage, table, table, ("v1", "v2"), FEATURE_JAVA + "sqltransformer.SQLTransformer", \
            verify, FEATURE_REPEATS

    def sql_where():
        rows, width = SQL_WHERE_SHAPE
        gen = seeded(CONF_SEED, dev)
        v1 = torch.rand(rows, generator=gen, device=dev, dtype=torch.float64) - 0.5
        v1[torch.rand(rows, generator=gen, device=dev) < NAN_SHARE] = float("nan")
        vec = torch.rand((rows, width), generator=gen, device=dev)
        table = Table({"vec": vec, "v1": v1})
        stage = sqltransformer.SQLTransformer().set_statement(SQL_WHERE)

        def verify(run):
            out = run["out"]
            x = v1.cpu().numpy()
            with np.errstate(invalid="ignore"):
                keep = (x > -0.25) & ~(x > 0.4) & ~np.isnan(x)  # SQL's NULL: a NaN row drops
            sel = torch.as_tensor(np.flatnonzero(keep), device=dev)
            check(out.num_rows == int(keep.sum()), f"sqltransformer WHERE kept {out.num_rows} rows")
            check(np.array_equal(out.column("v1").cpu().numpy(), x[keep])
                  and np.array_equal(out.column("a").cpu().numpy(), np.abs(x[keep]) * 2)
                  and torch.equal(out.column("vec"), vec[sel]),
                  "sqltransformer WHERE differs from the numpy Kleene replay")
            return {"exact": True, "kept": out.num_rows, "nan_rows": int(np.isnan(x).sum())}
        return stage, table, table, ("vec", "v1", "a"), \
            FEATURE_JAVA + "sqltransformer.SQLTransformer", verify, FEATURE_REPEATS

    def sql_group_by():
        import sqlite3

        gen = seeded(CONF_SEED, dev)
        g = torch.randint(0, SQL_GROUPS, (SQL_GROUP_ROWS,), generator=gen, device=dev)
        v = torch.rand(SQL_GROUP_ROWS, generator=gen, device=dev, dtype=torch.float64)
        table = Table({"g": g, "v": v})
        stage = sqltransformer.SQLTransformer().set_statement(SQL_GROUP_BY)

        def verify(run):
            conn = sqlite3.connect(":memory:")
            conn.execute('CREATE TABLE __this__ ("g", "v")')
            conn.executemany('INSERT INTO __this__ ("g", "v") VALUES (?, ?)',
                             zip(g.cpu().tolist(), v.cpu().tolist()))
            want = conn.execute(SQL_GROUP_BY.replace("__THIS__", "__this__")).fetchall()
            conn.close()
            out = run["out"]
            got = list(zip(*[np.asarray(out.column(c)).tolist() for c in ("g", "s", "c")]))
            check(got == [tuple(r) for r in want], "sqltransformer GROUP BY differs from sqlite3's")
            return {"exact": True, "groups": len(got)}
        return stage, table, table, ("g", "s", "c"), FEATURE_JAVA + "sqltransformer.SQLTransformer", \
            verify, FEATURE_REPEATS

    def minhash():
        from flink_ml_tpu_torch import Vectors

        rows = LSH_ROWS
        planted = rows // 100
        gen = seeded(5, dev)  # phase 3's sparse rows
        idx = torch.randint(0, SPARSE_DIM, (rows, NNZ), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.rand((rows, NNZ), generator=gen, device=dev)
        # the last 1% of the rows: twins of the first 1% with LSH_CHANGED slots drawn anew
        twins = idx[:planted].clone()
        twins[:, :LSH_CHANGED] = torch.randint(0, SPARSE_DIM, (planted, LSH_CHANGED), generator=gen,
                                               device=dev, dtype=torch.int32)
        idx[rows - planted:] = twins
        table = Table({"id": torch.arange(rows, device=dev), "features": SparseBatch(SPARSE_DIM, idx, vals)})
        stage = lsh.MinHashLSH().set_input_col("features").set_output_col("hashes") \
            .set_num_hash_tables(LSH_TABLES).set_num_hash_functions_per_table(LSH_FUNCTIONS) \
            .set_seed(LSH_SEED)

        def verify(run):
            model = run["model"]
            fns = LSH_TABLES * LSH_FUNCTIONS
            draws = java_random_ints(LSH_SEED, HASH_PRIME - 1, 2 * fns)
            a, b = np.asarray(draws[0::2], np.int64) + 1, np.asarray(draws[1::2], np.int64)
            check(np.array_equal(model.rand_coefficient_a, a)
                  and np.array_equal(model.rand_coefficient_b, b),
                  "minhashlsh coefficients differ from the java.util.Random replay")
            replay_rows = min(HOST_REPLAY_ROWS, rows)
            host_idx = idx[:replay_rows].cpu().numpy()
            got = np.array(run["out"].column("hashes")[:replay_rows].tolist())
            want = min_hash64(host_idx, a, b).reshape(replay_rows, LSH_TABLES, LSH_FUNCTIONS)
            check(got.dtype == np.float64 and np.array_equal(got, want.astype(np.float64)),
                  "minhashlsh hashes differ from the int64 numpy replay")
            # nearest neighbours of planted keys: candidates by the per-function
            # hash on the card, distances by sets, the stable order
            every = min_hash_per_function(idx, a, b).reshape(rows, LSH_TABLES, LSH_FUNCTIONS)
            found_twins, neighbours = 0, []
            for r in range(LSH_KEYS):
                keep = np.unique(host_idx[r][host_idx[r] >= 0])
                key = Vectors.sparse(SPARSE_DIM, keep, np.ones(keep.size))
                res = model.approx_nearest_neighbors(table, key, LSH_K)
                kh = torch.as_tensor(min_hash64(keep[None, :], a, b), device=dev).reshape(
                    1, LSH_TABLES, LSH_FUNCTIONS)
                cand = torch.nonzero((every == kh).all(dim=2).any(dim=1)).flatten().cpu().numpy()
                cand_idx = idx[torch.as_tensor(cand, device=dev)].cpu().numpy()
                dists = [jaccard(row[row >= 0], keep) for row in cand_idx]
                order = np.argsort(dists, kind="stable")[:LSH_K]
                check(np.array_equal(res.column("id").cpu().numpy(), cand[order])
                      and np.array_equal(res.column("distCol"), np.asarray(dists)[order]),
                      f"minhashlsh neighbours of row {r} differ from the replay")
                found_twins += int(rows - planted + r in cand[order].tolist())
                neighbours.append(len(cand))
            # the similarity join of the first rows with their planted twins
            m = min(LSH_JOIN_ROWS, planted)
            A = table.take(np.arange(m))
            B = table.take(np.arange(rows - planted, rows - planted + m))
            joined = model.approx_similarity_join(A, B, LSH_THRESHOLD, "id")
            a_idx = idx[:m].cpu().numpy()
            b_idx = idx[rows - planted: rows - planted + m].cpu().numpy()
            ha, hb = min_hash64(a_idx, a, b), min_hash64(b_idx, a, b)
            buckets, pairs = {}, set()
            for i in range(m):
                for t in range(LSH_TABLES):
                    buckets.setdefault((t, tuple(ha[i, t * LSH_FUNCTIONS:(t + 1) * LSH_FUNCTIONS])),
                                       []).append(i)
            for j in range(m):
                for t in range(LSH_TABLES):
                    for i in buckets.get((t, tuple(hb[j, t * LSH_FUNCTIONS:(t + 1) * LSH_FUNCTIONS])), ()):
                        pairs.add((i, j))
            want_rows = []
            for i, j in sorted(pairs):
                d = jaccard(a_idx[i][a_idx[i] >= 0], b_idx[j][b_idx[j] >= 0])
                if d <= LSH_THRESHOLD:
                    want_rows.append((i, rows - planted + j, d))
            got_rows = list(zip(np.asarray(joined.column("idA")).tolist(),
                                np.asarray(joined.column("idB")).tolist(),
                                np.asarray(joined.column("distCol")).tolist()))
            check(got_rows == want_rows, "minhashlsh similarity join differs from the set replay")
            twins_joined = sum(1 for i, j, _ in got_rows if j - (rows - planted) == i)
            log(f"    minhashlsh: coefficients and {replay_rows} rows of hashes exact; {LSH_KEYS} keys "
                f"with {neighbours} candidates, {found_twins} planted twins among their neighbours; "
                f"join of {m} x {m} rows: {len(got_rows)} pairs, {twins_joined} planted twins")
            check(twins_joined >= 0.9 * m, f"minhashlsh join found {twins_joined} of {m} planted twins")
            return {"exact": True, "candidates": neighbours, "twins_found": found_twins,
                    "join_pairs": len(got_rows), "twins_joined": twins_joined}
        return stage, table, table, ("hashes",), FEATURE_JAVA + "lsh.MinHashLSHModel", verify, 1

    return {
        "agglomerativeclustering": agg_spec(),
        "agglomerativeclustering complete": agg_spec("complete"),
        "agglomerativeclustering single": agg_spec("single"),
        "agglomerativeclustering average": agg_spec("average"),
        "agglomerativeclustering cosine average": agg_spec("average", "cosine"),
        "agglomerativeclustering distanceThreshold": agg_spec("average", threshold=AGG_THRESHOLD),
        "agglomerativeclustering computeFullTree": agg_spec(full_tree=True),
        "agglomerativeclustering count windows": agg_spec(
            windows=window.CountTumblingWindows.of(AGG_COUNT_WINDOW)),
        "agglomerativeclustering event-time windows": agg_spec(
            windows=window.EventTimeTumblingWindows.of(AGG_EVENT_WINDOW_MS)),
        "agglomerativeclustering ward big": agg_spec(rows=AGG_BIG_ROWS, plain=False),
        "sqltransformer": sql_conf,
        "sqltransformer where": sql_where,
        "sqltransformer group by": sql_group_by,
        "minhashlsh": minhash,
    }


def windows_check(dev):
    """window_all_and_process over a WINDOW_ROWS-row table on the card with
    count, event-time tumbling and session windows, each window's row count
    and first and last row ids against numpy groupings of the timestamps."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.common import window
    from flink_ml_tpu_torch.utils.datastream import window_all_and_process

    rows = WINDOW_ROWS
    gen = seeded(CONF_SEED, dev)
    ts = torch.randint(0, 10 * rows, (rows,), generator=gen, device=dev)
    table = Table({"id": torch.arange(rows, device=dev), "timestamp": ts,
                   "x": torch.rand(rows, generator=gen, device=dev)})

    def summary(w):
        ids = w.column("id")
        return Table({"n": np.array([w.num_rows]), "first": ids[:1], "last": ids[-1:]})

    host_ts = ts.cpu().numpy()
    starts = host_ts - host_ts % WINDOW_TUMBLE_MS
    order = np.argsort(starts, kind="stable")
    bounds = np.flatnonzero(np.diff(starts[order])) + 1
    tumbling = np.split(order, bounds)
    order = np.argsort(host_ts, kind="stable")
    sessions = [np.sort(g) for g in np.split(order, np.flatnonzero(np.diff(host_ts[order]) >
                                                                  WINDOW_GAP_MS) + 1)]
    count = [np.arange(s, s + WINDOW_COUNT) for s in range(0, rows - WINDOW_COUNT + 1, WINDOW_COUNT)]
    result = {}
    for name, windows, groups in (
            ("count", window.CountTumblingWindows.of(WINDOW_COUNT), count),
            ("event tumbling", window.EventTimeTumblingWindows.of(WINDOW_TUMBLE_MS), tumbling),
            ("event session", window.EventTimeSessionWindows.with_gap(WINDOW_GAP_MS), sessions)):
        out, ms = synced(lambda: window_all_and_process(table, windows, summary))
        got = (np.asarray(out.column("n")).tolist(), out.column("first").cpu().tolist(),
               out.column("last").cpu().tolist())
        want = ([g.size for g in groups], [int(g[0]) for g in groups], [int(g[-1]) for g in groups])
        check(got == want, f"window_all_and_process {name} windows differ from the numpy groupings")
        result[name] = {"windows": len(groups), "ms": ms}
    log(f"  window_all_and_process over {rows} rows: {json.dumps(result)}")
    return result


def slice8_phase(sk, dev, tmp):
    """Phase 9: each stage at its shape (drive_feature, then its replay),
    then window_all_and_process."""
    results = {}
    for name, make in slice8_specs(dev).items():
        t0 = time.perf_counter()
        stage, fit_table, table, out_cols, java, verify, repeats = make()
        run = drive_feature(sk, name, stage, fit_table, table, tmp, out_cols, java, repeats)
        checks = verify(run)
        seconds = time.perf_counter() - t0
        log(f"    {name} checks: {checks}; {seconds:.2f} s")
        results[name] = {k: run[k] for k in ("fit_ms", "transform_ms", "warm_fit_ms", "warm_transform_ms",
                                              "fit_runs", "transform_runs", "peak_gib", "high_water_gib",
                                              "launches")}
        results[name].update(checks=checks, seconds=seconds)
        del stage, fit_table, table, verify, run
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results["window_all_and_process"] = windows_check(dev)
    results["window_all_and_process"]["seconds"] = time.perf_counter() - t0
    return results


# -- the fleet (FitFleet) and the reference-format loader ------------------

FLEET_MEMBERS = 8
# the sparse and dense fleets' members: learningRate x reg x elasticNet,
# every other param conf/'s LR; the last member stops at FLEET_SHORT_ITER
FLEET_GRID = [(lr, reg, en) for lr in (0.1, 0.05) for reg in (0.0, 1e-3) for en in (0.0, 0.5)]
FLEET_SHORT_ITER = 10
STREAM_FLEET_MEMBERS = 4
KMEANS_FLEET_SEEDS = (2, 3, 4, 5)
KMEANS_FLEET_SHORT_ITER = 5
FLEET_REPEATS = 3
# (rows, nnz, d, members): edges of the fleet kernels' layout (a member
# tile of 8 and one member more, an empty row width, one member; 4 and 12
# members take the gradient's float4 REDs when member-minor, 3 and 9 not)
FLEET_EDGE_SHAPES = [(64, 5, 24, 8), (200, 39, 64, 8), (1, 3, 4, 1), (33, 40, 50, 3),
                     (33, 40, 50, 4), (7, 0, 10, 2), (300, 64, 1000, 9), (300, 65, 1000, 12),
                     (300, 65, 1000, 17)]
#: the designs of csrc/designs.cu that this port's kernels replaced (timed in phase 2)
REPLACED_DESIGNS = {"sparse_grad": "fmt_red_grad (csrc/designs.cu)",
                    "fleet_row_dots": "fmt_scalar_fleet_row_dots (csrc/designs.cu)"}
FLEET_SOURCES = {"fleet_row_dots": "flink_ml_tpu/ops/sparsekernels.py:96 (under jax.vmap)",
                 "fleet_grad": "flink_ml_tpu/ops/sparsekernels.py:107 (under jax.vmap)"}
REFERENCE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")


def fleet_layouts(C):
    """C (N, d) as member-major, member-minor and, where N is a multiple
    of 4, member-minor with a base 4 bytes past 16-byte alignment (which
    takes the scalar loads and REDs)."""
    members, d = C.shape
    layouts = {"member-major": C, "member-minor": C.T.contiguous().T}
    if members % 4 == 0:
        buf = torch.empty(d * members + 1, device=C.device)
        shifted = buf[1:].view(d, members)
        shifted.copy_(C.T)
        layouts["member-minor misaligned"] = shifted.T
    return layouts


def fleet_kernel_phase(sk, probes, designs, dev):
    """The member-batched kernels against their plain versions: at edge
    shapes, in both layouts of the (N, d) operand (and member-minor off
    16-byte alignment), and at the sparse fleet fit's batch (N = 8, BATCH x
    NNZ, d = SPARSE_DIM), where the row dot must also equal N launches of
    the solo kernel bit for bit at N = 1, 8 and 9 in both layouts (it adds
    in the solo kernel's order). CUDA-event times of each kernel in both
    layouts, of the row dot's replaced design (`fmt_scalar_fleet_row_dots`)
    in both, of N solo launches, of the plain version, of one library call
    (embedding_bag over a (d, N) table; index_add_ of (B * nnz, N) rows
    into (d, N)) and of the row dot's probe (two 16-byte loads a slot from
    a (d, 8) table), beside the bound from the bytes moved."""
    scalar_row_dots = designs[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    for rows, nnz, d, members in FLEET_EDGE_SHAPES:
        idx, vals = sparse_batch(gen, rows, nnz, d, dev, 0.2, 0.05)
        C = torch.randn(members, d, generator=gen, device=dev)
        M = torch.randn(members, rows, generator=gen, device=dev)
        want_dots, want_grad = sk.fleet_row_dots_plain(idx, vals, C), sk.fleet_grad_plain(idx, vals, M, C)
        for layout, c in fleet_layouts(C).items():
            for name, fn in (("fleet_row_dots", sk.fleet_row_dots),
                             ("fmt_scalar_fleet_row_dots", scalar_row_dots)):
                check(torch.allclose(fn(idx, vals, c), want_dots, **ROW_DOTS_TOL),
                      f"{name} disagrees at {(rows, nnz, d, members)} {layout}")
            g = sk.fleet_grad(idx, vals, M, c)
            check(g.is_contiguous() == c.is_contiguous(), f"fleet_grad's layout {g.stride()} is not coeff's")
            check(torch.allclose(g, want_grad, **GRAD_TOL),
                  f"fleet_grad disagrees at {(rows, nnz, d, members)} {layout}")
    log(f"  fleet kernels: edge shapes (rows, nnz, d, members) {FLEET_EDGE_SHAPES} agree in both "
        f"layouts and member-minor off 16-byte alignment")

    N = FLEET_MEMBERS
    idx, vals = sparse_batch(gen, BATCH, NNZ, SPARSE_DIM, dev, DEFAULT_MASK_SHARE, OUT_OF_RANGE_SHARE)
    C = torch.randn(max(N, 9), SPARSE_DIM, generator=gen, device=dev)
    solo = torch.stack([sk.sparse_row_dots(idx, vals, C[m].contiguous()) for m in range(C.shape[0])])
    bits = {}
    for members in (1, N, 9):
        for layout, c in fleet_layouts(C[:members]).items():
            bits[f"N={members} {layout}"] = bool(torch.equal(sk.fleet_row_dots(idx, vals, c), solo[:members]))
    check(all(bits.values()), f"fleet_row_dots is not bit-identical to solo sparse_row_dots launches: {bits}")
    C = C[:N].contiguous()
    Cm = C.T.contiguous().T  # the fit's layout: member-minor
    M = torch.randn(N, BATCH, generator=gen, device=dev)
    sets = copies(idx, vals)
    valid = idx >= 0
    keep = valid & (idx < SPARSE_DIM)
    safe = torch.where(valid, idx, 0).clamp(max=SPARSE_DIM - 1)
    masked_vals = torch.where(valid, vals, 0.0)
    batch_bytes = idx.numel() * 8
    results = {}

    got = sk.fleet_row_dots(idx, vals, Cm)
    want = sk.fleet_row_dots_plain(idx, vals, C)
    err = (got - want).abs()
    check(torch.allclose(got, want, **ROW_DOTS_TOL),
          f"fleet_row_dots disagrees with its plain version: max abs {float(err.max())}")
    check(torch.equal(scalar_row_dots(idx, vals, Cm), got), "the replaced fleet row dot's bits differ")
    table = Cm.T  # (d, N), contiguous
    gather8 = probes[2]
    check_gather8(gather8, idx, table)
    lib = torch.nn.functional.embedding_bag(safe, table, per_sample_weights=masked_vals, mode="sum")
    check(torch.allclose(lib.T, want, **ROW_DOTS_TOL), "embedding_bag yardstick disagrees")
    touched = int(torch.unique(safe[valid]).numel())
    b_ms, b_by = bound_ms(batch_bytes + touched * N * 4 + N * BATCH * 4, 2.0 * N * int(valid.sum()))
    results["fleet_row_dots"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "bit_identical_to_solo": bits,
        "ms": cuda_ms(lambda i, v: sk.fleet_row_dots(i, v, Cm), sets),
        "replaced_ms": cuda_ms(lambda i, v: scalar_row_dots(i, v, Cm), sets),
        "member_major_ms": cuda_ms(lambda i, v: sk.fleet_row_dots(i, v, C), sets),
        "replaced_member_major_ms": cuda_ms(lambda i, v: scalar_row_dots(i, v, C), sets),
        "solo_n_ms": cuda_ms(lambda i, v: [sk.sparse_row_dots(i, v, C[m]) for m in range(N)], sets),
        "plain_ms": cuda_ms(lambda i, v: sk.fleet_row_dots_plain(i, v, C), sets, iters=10),
        "library_ms": cuda_ms(
            lambda sf, w: torch.nn.functional.embedding_bag(sf, table, per_sample_weights=w, mode="sum"),
            [(safe, masked_vals)], iters=10),
        "probe_ms": cuda_ms(lambda i, v: gather8(i, table), sets),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    del got, want, solo, lib

    got = sk.fleet_grad(idx, vals, M, Cm)
    want = sk.fleet_grad_plain(idx, vals, M, C)
    err = (got - want).abs()
    check(not got.is_contiguous(), "fleet_grad's layout is not coeff's")
    check(torch.allclose(got, want, **GRAD_TOL),
          f"fleet_grad disagrees with its plain version: max abs {float(err.max())}")
    flat_idx = torch.where(keep, idx, 0).long().reshape(-1)
    contrib = torch.where(keep[None], vals[None] * M[:, :, None], 0.0).permute(1, 2, 0).reshape(-1, N)
    lib = torch.zeros((SPARSE_DIM, N), device=dev).index_add_(0, flat_idx, contrib)
    check(torch.allclose(lib.T, want, **GRAD_TOL), "index_add_ yardstick disagrees")
    b_ms, b_by = bound_ms(batch_bytes + N * BATCH * 4 + N * SPARSE_DIM * 4, 2.0 * N * int(keep.sum()))
    msets = [(i, v, M) for i, v in sets]
    results["fleet_grad"] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max()),
        "ms": cuda_ms(lambda i, v, m: sk.fleet_grad(i, v, m, Cm), msets),
        "member_major_ms": cuda_ms(lambda i, v, m: sk.fleet_grad(i, v, m, C), msets),
        "solo_n_ms": cuda_ms(lambda i, v, m: [sk.sparse_grad(i, v, m[j], C[j]) for j in range(N)], msets),
        "plain_ms": cuda_ms(lambda i, v, m: sk.fleet_grad_plain(i, v, m, C), msets, iters=5),
        "library_ms": cuda_ms(
            lambda fi, c: torch.zeros((SPARSE_DIM, N), device=dev).index_add_(0, fi, c),
            [(flat_idx, contrib)], iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    # Zipf-skewed indices with quarter-grid values: every partial sum is
    # exact, so the float4 and scalar REDs in any order give the plain bits
    zidx, zvals = zipf_batch(gen, BATCH, NNZ, SPARSE_DIM, dev)
    zmult = torch.randint(-4, 5, (N, BATCH), generator=gen, device=dev).to(torch.float32) / 4
    for c in (Cm, C):
        check(torch.equal(sk.fleet_grad(zidx, zvals, zmult, c), sk.fleet_grad_plain(zidx, zvals, zmult, C)),
              "fleet_grad is not exact on the Zipf batch's exact sums")
    del zidx, zvals
    for name, r in results.items():
        r.update(rows=BATCH, nnz=NNZ, d=SPARSE_DIM, members=N,
                 tolerance=ROW_DOTS_TOL if name == "fleet_row_dots" else GRAD_TOL)
        extra = (f"; replaced design {r['replaced_ms']:.4f} ms member-minor, "
                 f"{r['replaced_member_major_ms']:.4f} ms member-major; probe {r['probe_ms']:.4f} ms"
                 if "replaced_ms" in r else "")
        log(f"  {name} fit batch ({N} x {BATCH} x {NNZ}, d={SPARSE_DIM}): max_abs_err "
            f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms member-minor, "
            f"{r['member_major_ms']:.4f} ms member-major{extra}; {N} solo launches "
            f"{r['solo_n_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  fleet_row_dots equals solo launches of sparse_row_dots bit for bit: {bits}; fleet_grad "
        f"exact on Zipf-skewed quarter-grid sums in both layouts")
    return results


def fleet_members(cls, weight_col=None, count=FLEET_MEMBERS):
    """conf/'s LR params on `count` members of FLEET_GRID; the last stops
    at FLEET_SHORT_ITER."""
    members = []
    for i, (lr, reg, en) in enumerate(FLEET_GRID[:count]):
        est = estimator(cls, weight_col, lr).set_reg(reg).set_elastic_net(en)
        members.append(est.set_max_iter(FLEET_SHORT_ITER) if i == count - 1 else est)
    return members


def kmeans_fleet_members():
    return [kmeans_estimator().set_seed(seed).set_max_iter(
        KMEANS_FLEET_SHORT_ITER if i == len(KMEANS_FLEET_SEEDS) - 1 else KMEANS_ITER)
        for i, seed in enumerate(KMEANS_FLEET_SEEDS)]


def fleet_timing(name, fleet_fit, members, table, result):
    """Warm medians of FLEET_REPEATS fleet fits and of as many rounds of
    the members' solo fits, timed the same way."""
    fleets = [synced(fleet_fit)[1] for _ in range(FLEET_REPEATS)]
    solos = [synced(lambda: [m.fit(table) for m in members])[1] for _ in range(FLEET_REPEATS)]
    result.update(fleet_ms=float(np.median(fleets)), solo_fits_ms=float(np.median(solos)),
                  fleet_runs=fleets, solo_runs=solos)
    log(f"  {name}: fleet fit median {result['fleet_ms']:.3f} ms (runs "
        f"{[round(t, 3) for t in fleets]}), {len(members)} solo fits median "
        f"{result['solo_fits_ms']:.3f} ms (runs {[round(t, 3) for t in solos]})")


def max_gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def sparse_fleet(sk, sparse_table):
    """The sparse LR fleet on phase 3's table: its launches (only the fleet
    kernels, one each an epoch), each member against the same fleet on the
    plain versions on the card (1e-4 of the coefficients' scale, its loss
    within LOSS_REL_TOL, the same epochs), each member's gap from its solo
    kernel fit, times, peak memory and a profiler pass."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.ops import losses

    members = lambda: fleet_members(LogisticRegression)  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    (models, crit, epochs), fit_ms = synced(lambda: FitFleet(members())._fit_linear(sparse_table))
    counts = sk.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    expected = launch_dict(fleet_row_dots=MAX_ITER, fleet_grad=MAX_ITER)
    log(f"  sparse lr fleet ({FLEET_MEMBERS} members): fit {fit_ms:.1f} ms (first call); launches "
        f"{counts}; epochs {epochs.tolist()}; peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    check(counts == expected, f"sparse lr fleet launched {counts}, expected {expected}")
    check(epochs.tolist() == [MAX_ITER] * (FLEET_MEMBERS - 1) + [FLEET_SHORT_ITER],
          f"sparse lr fleet epochs {epochs.tolist()}")
    plain, plain_crit, plain_epochs = FitFleet(members())._fit_linear(
        sparse_table, losses.fleet_loss("binary_logistic", plain=True))
    solo = [m.fit(sparse_table) for m in members()]
    gaps, solo_gaps, scales = [], [], []
    for i, (got, ref, one, est) in enumerate(zip(models, plain, solo, members())):
        scale = float(np.max(np.abs(ref.coefficient)))
        gap = max_gap(got.coefficient, ref.coefficient)
        rel = abs(crit[i] - plain_crit[i]) / max(abs(plain_crit[i]), 1e-30)
        gaps.append(gap)
        scales.append(scale)
        solo_gaps.append(max_gap(got.coefficient, one.coefficient))
        # atomics reorder float32 sums: 1e-4 of the coefficients' scale, as
        # the solo sparse fits are held; plus, under an L1 term, one step of
        # it on each side: the proximal step moves a coefficient by
        # lr * elasticNet * reg * sign(coeff), so one that rounding leaves
        # on the other side of 0 lands 2 * lr * elasticNet * reg away
        l1_step = est.get_learning_rate() * est.get_elastic_net() * est.get_reg()
        check(np.isfinite(got.coefficient).all() and gap <= 1e-4 * scale + 2.0 * l1_step,
              f"sparse fleet member {i} differs from the plain-version fleet by {gap} (scale "
              f"{scale}, L1 step {l1_step})")
        check(rel < LOSS_REL_TOL and epochs[i] == plain_epochs[i],
              f"sparse fleet member {i} loss {crit[i]} vs plain {plain_crit[i]}")
    log(f"  sparse lr fleet vs the plain-version fleet: max abs gap by member "
        f"{[f'{g:.3g}' for g in gaps]} of max |coeff| {[f'{c:.3g}' for c in scales]}; losses "
        f"{[round(float(c), 6) for c in crit]}")
    log(f"  sparse lr fleet vs each member's solo kernel fit (not gated; atomics): max abs gap by "
        f"member {[f'{g:.3g}' for g in solo_gaps]}")
    result = {"launches": counts, "fit_ms": fit_ms, "peak_gib": peak, "epochs": epochs.tolist(),
              "gap_plain": gaps, "gap_solo": solo_gaps}
    fleet_timing("sparse lr fleet", lambda: FitFleet(members()).fit(sparse_table), members(),
                 sparse_table, result)
    profile_run("sparse lr fleet fit", lambda: FitFleet(members()).fit(sparse_table))
    return models, result


def dense_fleet(dense_table, X64, y64, w64):
    """The dense LR fleet (weighted, 10M x 100): each member against a
    float64 replay of its own epochs (1e-3 of the coefficients' scale, the
    same epochs), a refit bit for bit, each member's gap from its solo fit."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    members = lambda: fleet_members(LogisticRegression, "weight")  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (models, _, epochs), fit_ms = synced(lambda: FitFleet(members())._fit_linear(dense_table))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  dense lr fleet ({FLEET_MEMBERS} members): fit {fit_ms:.1f} ms (first call); epochs "
        f"{epochs.tolist()}; peak {peak:.3f} GiB above the {held / 2**30:.2f} GiB held")
    rels = []
    for i, (model, est) in enumerate(zip(models, members())):
        ref, _, ref_epochs = numpy_reference_sgd(
            lambda k: (X64[k * BATCH:(k + 1) * BATCH], y64[k * BATCH:(k + 1) * BATCH],
                       w64[k * BATCH:(k + 1) * BATCH]),
            DENSE_ROWS // BATCH, est.get_max_iter(), est.get_learning_rate(), TOL, _logistic64,
            est.get_reg(), est.get_elastic_net())
        rel = max_gap(model.coefficient, ref) / float(np.max(np.abs(ref)))
        rels.append(rel)
        check(rel < 1e-3 and epochs[i] == ref_epochs,
              f"dense fleet member {i} differs from its float64 replay by {rel} ({epochs[i]} vs "
              f"{ref_epochs} epochs)")
    refit = FitFleet(members()).fit(dense_table)
    check(all(np.array_equal(a.coefficient, b.coefficient) for a, b in zip(refit, models)),
          "dense lr fleet refit is not bit-identical")
    solo = [m.fit(dense_table) for m in members()]
    solo_gaps = [max_gap(a.coefficient, b.coefficient) for a, b in zip(models, solo)]
    same = [bool(np.array_equal(a.coefficient, b.coefficient)) for a, b in zip(models, solo)]
    log(f"  dense lr fleet vs float64 replays: max rel by member {[f'{r:.3g}' for r in rels]}; "
        f"refit bit for bit; vs solo fits (not gated): max abs gap {[f'{g:.3g}' for g in solo_gaps]}, "
        f"bit-identical {same}")
    result = {"fit_ms": fit_ms, "peak_gib": peak, "epochs": epochs.tolist(), "rel_replay": rels,
              "gap_solo": solo_gaps, "bits_solo": same}
    fleet_timing("dense lr fleet", lambda: FitFleet(members()).fit(dense_table), members(),
                 dense_table, result)
    return models, result


def kmeans_fleet(km_table):
    """The KMeans fleet (1M x 100, k 10; seeds 2-5, the last at maxIter 5):
    each member against a float64 Lloyd from its init rows (1e-3 of the
    centroids' scale), each member's gap from its solo fit."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.clustering import kmeans

    X = km_table.column("features")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    models, fit_ms = synced(lambda: FitFleet(kmeans_fleet_members()).fit(km_table))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    X64 = X.double()
    errs, solo_gaps, same = [], [], []
    for model, est in zip(models, kmeans_fleet_members()):
        idx = torch.as_tensor(kmeans.init_rows(KMEANS_ROWS, KMEANS_K, est.get_seed()), device=X.device)
        ref_c, ref_counts = lloyd64(X64, X64[idx], est.get_max_iter())
        ref = ref_c.cpu().numpy()
        err = max_gap(model.centroids, ref)
        errs.append(err)
        check(err <= 1e-3 * float(np.max(np.abs(ref))) and model.weights.sum() == KMEANS_ROWS,
              f"kmeans fleet member (seed {est.get_seed()}) differs from its float64 Lloyd by {err}")
        one = est.fit(km_table)
        solo_gaps.append(max_gap(model.centroids, one.centroids))
        same.append(bool(np.array_equal(model.centroids, one.centroids)
                         and np.array_equal(model.weights, one.weights)))
    del X64
    log(f"  kmeans fleet (seeds {list(KMEANS_FLEET_SEEDS)}): fit {fit_ms:.1f} ms (first call); "
        f"peak {peak:.3f} GiB; vs float64 Lloyd max abs {[f'{e:.3g}' for e in errs]}; vs solo fits "
        f"(not gated) max abs gap {[f'{g:.3g}' for g in solo_gaps]}, bit-identical {same}")
    result = {"fit_ms": fit_ms, "peak_gib": peak, "err_lloyd64": errs, "gap_solo": solo_gaps,
              "bits_solo": same}
    fleet_timing("kmeans fleet", lambda: FitFleet(kmeans_fleet_members()).fit(km_table),
                 kmeans_fleet_members(), km_table, result)
    return models, result


def stream_fleet(stream_cols, bounded_table):
    """The stream LR fleet: the stream LR's host rows in uniform chunks of
    BATCH rows, STREAM_FLEET_MEMBERS members, each against the dense fleet's
    member on the rows its epochs train (bits expected, gate 1e-6)."""
    from flink_ml_tpu_torch.fleet import FitFleet
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    members = lambda: fleet_members(LogisticRegression, "weight", STREAM_FLEET_MEMBERS)  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    models, fit_ms = synced(lambda: FitFleet(members()).fit(stream_of(stream_cols, DENSE_ROWS, BATCH)))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    bounded = FitFleet(members()).fit(bounded_table)
    rels = [max_gap(a.coefficient, b.coefficient) / float(np.max(np.abs(b.coefficient)))
            for a, b in zip(models, bounded)]
    bits = [bool(np.array_equal(a.coefficient, b.coefficient)) for a, b in zip(models, bounded)]
    log(f"  stream lr fleet ({STREAM_FLEET_MEMBERS} members, {DENSE_ROWS} rows in chunks of {BATCH}, "
        f"stacked on the card once): fit {fit_ms:.1f} ms with the chunks' staging; peak "
        f"{peak:.3f} GiB; vs the dense fleet on its rows: max rel {[f'{r:.3g}' for r in rels]}, "
        f"bit-identical {bits}")
    check(all(r <= 1e-6 for r in rels), f"stream lr fleet differs from the dense fleet by {rels}")
    return {"fit_ms": fit_ms, "peak_gib": peak, "rel_dense": rels, "bits_dense": bits}


#: the committed reference-format fixtures: name -> (input columns, output
#: column, expected values), as tests/test_reference_codecs_all.py and
#: tests/test_reference_format.py expect them; a string column stays on the host
REFERENCE_CASES = {
    "reference_standardscaler_model": ({"input": [[3.0, 6.0]]}, "output", [[1.0, 1.0]]),
    "reference_minmaxscaler_model": ({"input": [[5.0, 20.0]]}, "output", [[0.5, 0.5]]),
    "reference_maxabsscaler_model": ({"input": [[2.0, -4.0]]}, "output", [[0.5, -0.5]]),
    "reference_robustscaler_model": ({"input": [[3.0, 6.0]]}, "output", [[1.0, 1.0]]),
    "reference_idf_model": ({"input": [[2.0, 1.0]]}, "output", [[2.0 * 0.405465, 1.098612]]),
    "reference_imputer_model": ({"a": [float("nan"), 2.0], "b": [3.0, float("nan")]}, "ao",
                                [1.5, 2.0]),
    "reference_kbinsdiscretizer_model": ({"input": [[0.5], [1.5]]}, "output", [[0.0], [1.0]]),
    "reference_stringindexer_model": ({"c": np.array(["a", "b"])}, "ci", [1.0, 0.0]),
    "reference_onehotencoder_model": ({"c": [0.0, 2.0]}, "v", None),
    "reference_vectorindexer_model": ({"input": [[7.0], [5.0]]}, "output", [[1.0], [0.0]]),
    "reference_countvectorizer_model": (None, "output", None),
    "reference_minhashlsh_model": (None, "hashes", None),
    "reference_univariatefeatureselector_model": ({"features": [[1.0, 2.0, 3.0]]}, "output", [[2.0]]),
    "reference_variancethresholdselector_model": ({"input": [[1.0, 2.0, 3.0]]}, "output",
                                                  [[1.0, 3.0]]),
    "reference_naivebayes_model": ({"features": [[0.0], [1.0]]}, "prediction", [10.0, 20.0]),
    "reference_knn_model": ({"features": [[1.0, 1.0], [9.0, 9.0]]}, "prediction", [1.0, 2.0]),
    "reference_kmeans_model": ({"features": [[1.0, 1.0], [9.0, 9.0]]}, "prediction", [0, 1]),
    "reference_lr_pipelinemodel": ({"features": [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]]},
                                   "prediction", [1.0, 0.0]),
}


def host_values(col):
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def reference_fixture_check(dev, tmp):
    """Every committed tests/fixtures/reference_* directory loads through
    load_stage and transforms a small table on the card to the expected
    values; the loaded model saved as npz and loaded again transforms the
    same, bit for bit."""
    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch.utils import read_write

    dirs = sorted(d for d in os.listdir(REFERENCE_FIXTURES) if d.startswith("reference_"))
    check(sorted(REFERENCE_CASES) == dirs, f"reference fixtures {dirs} vs the cases here")
    for name in dirs:
        cols, out_col, expected = REFERENCE_CASES[name]
        model = read_write.load_stage(os.path.join(REFERENCE_FIXTURES, name))
        if name == "reference_countvectorizer_model":
            tokens = np.empty(1, dtype=object)
            tokens[0] = ["pear", "apple", "pear"]
            table = Table({"input": tokens})
        elif name == "reference_minhashlsh_model":
            check(list(model.rand_coefficient_a) == [1, 2, 3, 4, 5, 6]
                  and list(model.rand_coefficient_b) == [11, 12, 13, 14, 15, 16],
                  "the MinHashLSH fixture's coefficients")
            table = Table({"vec": SparseBatch(10, torch.tensor([[0, 3]], dtype=torch.int32, device=dev),
                                              torch.ones((1, 2), device=dev))})
        else:
            table = Table({k: v if isinstance(v, np.ndarray) else
                           torch.tensor(v, dtype=torch.float32, device=dev) for k, v in cols.items()})
        out = model.transform(table)[0]
        got = out.column(out_col)
        if name == "reference_onehotencoder_model":
            rows = [got.row(i) for i in range(2)]
            ok = (list(rows[0].indices) == [0] and list(rows[0].values) == [1.0]
                  and list(rows[1].indices) == [])
        elif name == "reference_countvectorizer_model":
            row = got.row(0)
            ok = list(row.indices) == [0, 1] and list(row.values) == [1.0, 2.0]
        elif name == "reference_minhashlsh_model":
            ok = len(got) == 1
        else:
            ok = np.allclose(host_values(got).astype(np.float64), np.asarray(expected, np.float64),
                             rtol=1e-6, atol=0)
        if name == "reference_imputer_model":
            ok = ok and np.allclose(host_values(out.column("bo")), [3.0, 9.0])
        check(ok, f"{name} transforms to {host_values(got) if expected is not None else got}")
        path = os.path.join(tmp, name + "_npz")
        model.save(path)
        again = read_write.load_stage(path).transform(table)[0]
        check(same_column(again.column(out_col), got), f"{name} differs after an npz round trip")
    log(f"  {len(dirs)} committed reference-format fixtures load, transform on the card as the "
        f"tests expect, and round-trip through npz bit for bit")
    return len(dirs)


def reference_format_check(sk, dev, tmp, sparse_models, km_models, sparse_table, km_table):
    """A.15 on the card: score the sparse fleet's members by areaUnderROC,
    write the winner and the KMeans fleet's first member in the reference's
    binary layout with the port's encoders, load both through load_stage
    and transform the full tables (the winner on the solo row-dot kernel);
    the predictions equal those of the same model saved and loaded as npz
    bit for bit. Then the committed fixtures."""
    from flink_ml_tpu_torch.models.evaluation.binaryclassification import (
        BinaryClassificationEvaluator)
    from flink_ml_tpu_torch.utils import javacodec, read_write

    evaluator = BinaryClassificationEvaluator().set_metrics_names("areaUnderROC")
    aucs = [float(evaluator.transform(m.transform(sparse_table)[0])[0].collect()[0]["areaUnderROC"])
            for m in sparse_models]
    check(all(np.isfinite(aucs)), f"fleet AUCs {aucs}")
    winner = int(np.argmax(aucs))
    log(f"  sparse fleet areaUnderROC by member {[round(a, 6) for a in aucs]}: winner {winner}")
    written = {}
    for name, model, payload, table, cols in (
            ("winner", sparse_models[winner],
             javacodec.encode_logisticregression_model_data(sparse_models[winner].coefficient, 0),
             sparse_table, ("prediction", "rawPrediction")),
            ("kmeans member 0", km_models[0],
             javacodec.encode_kmeans_model_data(km_models[0].centroids, km_models[0].weights),
             km_table, ("prediction",))):
        ref_path = os.path.join(tmp, name.replace(" ", "_") + "_reference")
        read_write.save_metadata(model, ref_path)
        javacodec.write_reference_data_file(ref_path, payload)
        check(not read_write.model_data_exists(ref_path), "the reference layout holds an npz")
        npz_path = os.path.join(tmp, name.replace(" ", "_") + "_npz")
        model.save(npz_path)
        loaded = read_write.load_stage(ref_path)
        sk.reset_launch_counts()
        out = loaded.transform(table)[0]
        torch.cuda.synchronize()
        counts = sk.launch_counts()
        want = read_write.load_stage(npz_path).transform(table)[0]
        for col in cols:
            check(same_column(out.column(col), want.column(col)),
                  f"{name} from the reference layout predicts {col} unlike its npz twin")
        expected = launch_dict(sparse_row_dots=1) if name == "winner" else launch_dict()
        check(counts == expected, f"{name} transform launched {counts}, expected {expected}")
        written[name] = counts
        log(f"  {name}: reference-layout directory (metadata + data/part-0-0) loads through "
            f"load_stage and transforms {table.num_rows} rows as its npz twin, bit for bit; "
            f"launches {counts}")
    fixtures = reference_fixture_check(dev, tmp)
    return {"aucs": aucs, "winner": winner, "launches": written, "fixtures": fixtures}


def fleet_phase(sk, dev, tmp, tables):
    """Phase 10: the four fleets and the reference-format loader."""
    t0 = time.perf_counter()
    out = {}
    sparse_models, out["sparse lr fleet"] = sparse_fleet(sk, tables["sparse"])
    touched = min(MAX_ITER, DENSE_ROWS // BATCH) * BATCH
    X = tables["dense"].column("features")
    X64 = X[:touched].double().cpu().numpy()
    y64 = tables["dense"].column("label")[:touched].double().cpu().numpy()
    w64 = tables["dense"].column("weight")[:touched].double().cpu().numpy()
    _, out["dense lr fleet"] = dense_fleet(tables["dense"], X64, y64, w64)
    del X64
    km_models, out["kmeans fleet"] = kmeans_fleet(tables["kmeans"])
    out["stream lr fleet"] = stream_fleet(tables["stream_cols"], tables["bounded"])
    out["reference format"] = reference_format_check(
        sk, dev, tmp, sparse_models, km_models, tables["sparse"], tables["kmeans"])
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 10 took {out['seconds']:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    from flink_ml_tpu_torch import SparseBatch, Table
    from flink_ml_tpu_torch import config as port_config
    from flink_ml_tpu_torch.models.classification import logisticregression
    from flink_ml_tpu_torch.ops import cuda_build
    from flink_ml_tpu_torch.ops import sparsekernels as sk

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
        f"{torch.cuda.get_device_name(0)} ({card}), allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    cuda_sources = ("sparse_kernels", "probes", "designs")
    cuda_build.load_all(cuda_sources)
    sk.build()
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(f'{n}.cu' for n in cuda_sources)} (one nvcc each, started "
        f"together) in {build_s:.2f} s")
    for name in cuda_sources:
        for kernel, usage in resource_usage(cuda_build, name).items():
            log(f"  registers {name} {kernel}: {usage}")
    shared_atomics = check_sass(cuda_build)
    probes = load_probes(cuda_build)
    designs = load_designs(cuda_build, sk)

    # -- 2. kernels against their plain versions ------------------------
    log("phase 2: kernels vs plain versions")
    edge_phase(sk, dev)
    kernel_results = kernel_phase(sk, probes, designs, dev)
    fleet_kernel_results = fleet_kernel_phase(sk, probes, designs, dev)

    # -- 3. the main path -------------------------------------------------
    log("phase 3: main paths (launch counts reset before and read after each)")
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
    km_table = Table({"features": kmeans_data(dev)})
    p_table = pipeline_data(dev)
    t0 = time.perf_counter()
    stream_cols = stream_lr_data()
    bounded_table = device_table(stream_cols, MAX_ITER * BATCH, dev)
    km_cols = {"features": km_table.column("features").cpu().numpy()}
    truth = np.random.default_rng(ONLINE_SEED).standard_normal(DIM).astype(np.float32)
    online_cols = planted_rows(ONLINE_SEED, DENSE_ROWS, truth)
    held_table = device_table(planted_rows(HELD_OUT_SEED, BATCH, truth), BATCH, dev)
    torch.cuda.synchronize()
    log(f"  host data of the stream and online paths made in {time.perf_counter() - t0:.2f} s")
    default_budget = port_config.datacache_memory_budget_bytes
    port_config.datacache_memory_budget_bytes = STREAM_CACHE_BUDGET

    # name -> (fit, table, launches expected of (sparse_row_dots, sparse_grad))
    sparse_launches = launch_dict(sparse_row_dots=MAX_ITER + 2, sparse_grad=MAX_ITER)
    no_launches = launch_dict()
    paths = {}
    for name, (_, _, _, lr, _) in LINEAR_PATHS.items():
        cls = linear_class(name)
        paths[f"dense {name}"] = (lambda c=cls, r=lr: estimator(c, "weight", r).fit(dense_table),
                                  dense_table, no_launches)
        paths[f"sparse {name}"] = (lambda c=cls, r=lr: estimator(c, None, r).fit(sparse_table),
                                   sparse_table, sparse_launches)
    paths["kmeans"] = (lambda: kmeans_estimator().fit(km_table), km_table, no_launches)
    paths["pipeline"] = (lambda: pipeline().fit(p_table), p_table, no_launches)
    # the stream and online paths, each run once here with its checks'
    # traces, and timed apart in phase 5
    traces = {"online lr": {}, "online kmeans": []}
    new_paths = {
        "stream lr": (lambda: estimator(logisticregression.LogisticRegression, "weight").fit(
            stream_of(stream_cols, DENSE_ROWS, STREAM_CHUNK)), bounded_table, no_launches),
        "stream kmeans": (lambda: kmeans_estimator().fit(stream_of(km_cols, KMEANS_ROWS, KMEANS_CHUNK)),
                          km_table, no_launches),
        "online lr": (lambda: online_lr_fit(online_cols, traces["online lr"]), held_table, no_launches),
        "online kmeans": (lambda: online_kmeans_fit(km_cols, runs["kmeans"]["model"],
                                                    traces["online kmeans"]), km_table, no_launches),
    }

    runs, launches, path_s = {}, launch_dict(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fit, table, expected) in {**paths, **new_paths}.items():
            t0 = time.perf_counter()
            sk.reset_launch_counts()
            run = drive(fit, table, tmp, name.replace(" ", "_"))
            counts = sk.launch_counts()
            run.update(table=table, launches=counts)
            runs[name] = run
            log(f"  {name}: fit {run['fit_ms']:.1f} ms, transform {run['transform_ms']:.1f} ms "
                f"(first calls); launches {counts}")
            check(counts == expected, f"{name} launched {counts}, expected {expected} (one row "
                  f"dot and one gradient per epoch, a row dot per transform)")
            for kernel in launches:
                launches[kernel] += counts[kernel]
            path_s[name] = time.perf_counter() - t0
    log(f"  launches on the main paths: {launches}")
    check(launches == launch_dict(sparse_row_dots=3 * (MAX_ITER + 2), sparse_grad=3 * MAX_ITER),
          f"launches over phase 3 {launches}")

    # -- 4. results against references ------------------------------------
    log("phase 4: results")
    touched = min(MAX_ITER, DENSE_ROWS // BATCH) * BATCH
    X64 = X[:touched].double().cpu().numpy()
    y64, w64 = y[:touched].double().cpu().numpy(), w[:touched].double().cpu().numpy()
    for name in LINEAR_PATHS:
        check_dense_linear(name, runs[f"dense {name}"], dense_table, X64, y64, w64)
        check_sparse_linear(name, runs[f"sparse {name}"], s_idx, s_vals, s_y)
    del X64
    for name, (*_, java_class) in LINEAR_PATHS.items():
        columns = ("prediction",) if name == "linreg" else ("prediction", "rawPrediction")
        for layout in ("dense", "sparse"):
            check_reload(f"{layout} {name}", runs[f"{layout} {name}"], java_class, columns)
    kmeans_margin, lloyd = check_kmeans(runs["kmeans"], km_table.column("features"))
    check_reload("kmeans", runs["kmeans"], "org.apache.flink.ml.clustering.kmeans.KMeansModel",
                 ("prediction",))
    check_pipeline(runs["pipeline"], p_table)
    check_reload("pipeline", runs["pipeline"], "org.apache.flink.ml.builder.PipelineModel",
                 ("prediction", "rawPrediction"))
    km_X = km_table.column("features")
    new_checks = {
        "stream lr": (lambda: check_stream_lr(runs["stream lr"], stream_cols, bounded_table,
                                              default_budget),
                      LINEAR_PATHS["lr"][4], ("prediction", "rawPrediction")),
        "stream kmeans": (lambda: check_stream_kmeans(runs["stream kmeans"], km_X, km_cols, lloyd,
                                                      runs["kmeans"]["model"]),
                          "org.apache.flink.ml.clustering.kmeans.KMeansModel", ("prediction",)),
        "online lr": (lambda: check_online_lr(runs["online lr"], online_cols, traces["online lr"],
                                              held_table),
                      "org.apache.flink.ml.classification.onlinelogisticregression."
                      "OnlineLogisticRegressionModel", ("prediction", "rawPrediction", "modelVersion")),
        "online kmeans": (lambda: check_online_kmeans(runs["online kmeans"], km_X, runs["kmeans"]["model"],
                                                      traces["online kmeans"]),
                          "org.apache.flink.ml.clustering.onlinekmeans.OnlineKMeansModel",
                          ("prediction",)),
    }
    for name, (run_check, java_class, columns) in new_checks.items():
        t0 = time.perf_counter()
        run_check()
        check_reload(name, runs[name], java_class, columns)
        path_s[name] += time.perf_counter() - t0
    log("  save/load: every model reloads and predicts identically")

    # -- 5. warm times --------------------------------------------------------
    log("phase 5: warm times")
    warm = {}
    for name, (fit, table, _) in paths.items():
        model = runs[name]["model"]
        repeats = 5 if name.endswith(" lr") else 3
        fits = [synced(fit)[1] for _ in range(repeats)]
        transforms = [synced(lambda: model.transform(table)[0])[1] for _ in range(repeats)]
        warm[name] = (float(np.median(fits)), float(np.median(transforms)))
        log(f"  {name}: fit median {warm[name][0]:.3f} ms (runs {[round(t, 3) for t in fits]}), "
            f"transform median {warm[name][1]:.3f} ms (runs {[round(t, 3) for t in transforms]})")
    from flink_ml_tpu_torch.models.clustering import kmeans

    draws = []
    for _ in range(3):
        t0 = time.perf_counter()
        kmeans.init_rows(KMEANS_ROWS, KMEANS_K, KMEANS_SEED)
        draws.append((time.perf_counter() - t0) * 1e3)
    log(f"  kmeans init rows (host RandomState.choice, {KMEANS_K} of {KMEANS_ROWS}): median "
        f"{float(np.median(draws)):.3f} ms (runs {[round(t, 3) for t in draws]})")
    for name in ("dense lr", "sparse lr", "kmeans"):
        profile_run(f"{name} fit", paths[name][0])
    profile_run("sparse lr transform", lambda: runs["sparse lr"]["model"].transform(sparse_table)[0])
    profile_run("pipeline transform", lambda: runs["pipeline"]["model"].transform(p_table)[0])
    new_warm = stream_and_online_times(stream_cols, km_cols, online_cols, runs["kmeans"]["model"], dev,
                                       path_s)

    # -- 6. the numeric feature stages ------------------------------------------
    log("phase 6: numeric feature stages at the conf/ shapes (launch counts reset before and "
        "read after each)")
    high_water = torch.cuda.max_memory_allocated()  # phase 6 resets the mark per stage
    with tempfile.TemporaryDirectory() as tmp:
        features = feature_phase(sk, dev, tmp)
    high_water = max([high_water / 2**30] + [r["high_water_gib"] for r in features.values()])
    for name, r in features.items():
        path_s[name] = r["seconds"]

    # -- 7. the string and token stages and the text path ----------------------------
    log("phase 7: the text path StopWordsRemover -> HashingTF -> IDF -> LogisticRegression, then "
        "the string and token stages at the conf/ shapes (launch counts reset before and read "
        "after each)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        texts = text_phase(sk, dev, tmp)
    text_run = texts.pop("text path")
    high_water = max([high_water] + [r["high_water_gib"] for r in texts.values()])
    path_s["text path"] = text_run["seconds"]
    for name, r in texts.items():
        path_s[name] = r["seconds"]
    for kernel in launches:
        launches[kernel] += text_run["launches"][kernel]

    # -- 8. the statistics slice and the evaluation path ------------------------------
    log("phase 8: the evaluation path RandomSplitter -> text pipeline -> "
        "BinaryClassificationEvaluator, then NaiveBayes, UnivariateFeatureSelector, Knn, the "
        "three stats tests and RandomSplitter at their shapes (launch counts reset before and "
        "read after each)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        stat_stages = stats_phase(sk, dev, tmp)
    eval_run = stat_stages.pop("eval path")
    functions = stat_stages.pop("functions")
    high_water = max([high_water] + [r["high_water_gib"] for r in stat_stages.values()])
    path_s["eval path"] = eval_run["seconds"]
    for name, r in stat_stages.items():
        path_s[name] = r["seconds"]
    for kernel in launches:
        launches[kernel] += eval_run["launches"][kernel]

    # -- 8b. the evaluation Graph ---------------------------------------------------------
    log("phase 8b: the evaluation Graph: RandomSplitter -> StopWordsRemover -> HashingTF -> IDF "
        "(fitted on the train part, transforming the test part) -> LogisticRegression -> "
        "BinaryClassificationEvaluator, with a model-data twin (launch counts reset before and "
        "read after the fit, and around one transform)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        graph_run = graph_path(sk, dev, tmp, eval_run["metrics"])
    path_s["graph path"] = graph_run["seconds"]
    for kernel in launches:
        launches[kernel] += graph_run["launches"][kernel]

    # -- 9. AgglomerativeClustering, SQLTransformer, MinHashLSH, the windows ---------------
    log("phase 9: AgglomerativeClustering, SQLTransformer and MinHashLSH at their shapes, then "
        "window_all_and_process (launch counts reset before and read after each)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        slice8 = slice8_phase(sk, dev, tmp)
    phase9_s = time.perf_counter() - t0
    windows_run = slice8.pop("window_all_and_process")
    high_water = max([high_water] + [r["high_water_gib"] for r in slice8.values()])
    for name, r in slice8.items():
        path_s[name] = r["seconds"]
    path_s["window_all_and_process"] = windows_run["seconds"]
    log(f"  phase 9 took {phase9_s:.2f} s")

    # -- 10. the fleet and the reference-format loader ----------------------
    log("phase 10: FitFleet (sparse, dense, KMeans and stream fleets) and the reference-format "
        "loader (launch counts reset before and read after each)")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fleets = fleet_phase(sk, dev, tmp, {
            "sparse": sparse_table, "dense": dense_table, "kmeans": km_table,
            "stream_cols": stream_cols, "bounded": bounded_table})
    high_water = max([high_water] + [r["peak_gib"] for r in fleets.values()
                                     if isinstance(r, dict) and "peak_gib" in r])
    path_s["fleets and reference format"] = fleets["seconds"]
    for kernel in launches:
        launches[kernel] += fleets["sparse lr fleet"]["launches"][kernel]
        launches[kernel] += fleets["reference format"]["launches"]["winner"][kernel]

    # -- output -----------------------------------------------------------------
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
            "launches_by_path": {**{p: r["launches"][name] for p, r in runs.items()
                                    if r["launches"][name]},
                                 "text": text_run["launches"][name],
                                 "eval": eval_run["launches"][name],
                                 "graph": graph_run["launches"][name],
                                 "graph transform": graph_run["transform_launches"][name],
                                 "reference-format transform":
                                     fleets["reference format"]["launches"]["winner"][name]},
            "launches_by_feature_path": {p: r["launches"][name] for p, r in
                                         {**features, **texts, **stat_stages, **slice8}.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "tolerance": ROW_DOTS_TOL if name == "sparse_row_dots" else GRAD_TOL,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "probe_ms": main["probe_ms"], "enqueue_ms": main["enqueue_ms"],
            **({"replaced_design": REPLACED_DESIGNS[name], "replaced_ms": main["replaced_ms"],
                "shared_atomics": shared_atomics} if name in REPLACED_DESIGNS else {}),
            "shape": [main["rows"], main["nnz"], main["d"]],
            "by_shape": rows,
        })
    for name, r in fleet_kernel_results.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "flink_ml_tpu_torch/csrc/sparse_kernels.cu",
            "replaces": FLEET_SOURCES[name],
            "launches": launches[name],
            "launches_by_path": {"sparse lr fleet": fleets["sparse lr fleet"]["launches"][name]},
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "member_major_ms": r["member_major_ms"], "solo_n_ms": r["solo_n_ms"],
            **({"replaced_design": REPLACED_DESIGNS[name], "replaced_ms": r["replaced_ms"],
                "replaced_member_major_ms": r["replaced_member_major_ms"], "probe_ms": r["probe_ms"],
                "bit_identical_to_solo": r["bit_identical_to_solo"]}
               if name in REPLACED_DESIGNS else {}),
            "shape": [r["members"], r["rows"], r["nnz"], r["d"]],
        })
    log("first calls: " + "; ".join(
        f"{n} fit {r['fit_ms']:.3f} ms, transform {r['transform_ms']:.3f} ms" for n, r in runs.items()))
    log("warm medians: " + "; ".join(
        f"{n} fit {f:.3f} ms, transform {t:.3f} ms" for n, (f, t) in warm.items()))
    log("stream and online, warm: " + json.dumps(new_warm))
    log("feature stages: " + json.dumps(features))
    log("text path: " + json.dumps(text_run))
    log("text stages: " + json.dumps(texts))
    log("eval path: " + json.dumps(eval_run))
    log("stats stages: " + json.dumps(stat_stages) + "; functions: " + json.dumps(functions))
    log("graph path: " + json.dumps(graph_run))
    log("phase 9 stages: " + json.dumps(slice8) + "; window_all_and_process: " + json.dumps(windows_run))
    log("fleets and reference format: " + json.dumps(fleets))
    log("seconds by path (phases 3-10): " + "; ".join(f"{n} {t:.2f}" for n, t in path_s.items()))
    log(f"kmeans points within the 1e-4 margin: {kmeans_margin}; build {build_s:.2f} s, "
        f"peak memory {high_water:.2f} GiB, "
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
