#!/usr/bin/env python3
"""chip_smoke.py's phase 13 (checkpoint and recovery) alone on the card.

    python3 scripts/chip_checkpoint_phase.py      # from the repository root

It builds the sparse kernels, makes phase 3's tables from the same seeds,
fits the phase 3 models that phase 13 resumes against (dense, sparse,
stream LR, stream KMeans, online LR with its trace, the sparse LR's
plain-loss fit), then runs `chip_smoke.checkpoint_phase`, which prints
each leg and exits non-zero on a failed gate. About 90 s on an H100, a
fifth of a full chip_smoke run."""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t_start = time.perf_counter()
from flink_ml_tpu_torch import SparseBatch, Table  # noqa: E402
from flink_ml_tpu_torch import config as port_config  # noqa: E402
from flink_ml_tpu_torch.models.classification import logisticregression  # noqa: E402
from flink_ml_tpu_torch.ops import cuda_build  # noqa: E402
from flink_ml_tpu_torch.ops import sparsekernels as sk  # noqa: E402

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
cuda_build.load_all(("sparse_kernels",))
sk.build()
gen = torch.Generator(device=dev)
gen.manual_seed(2)
X = torch.rand((cs.DENSE_ROWS, cs.DIM), generator=gen, device=dev)
y = torch.randint(0, 2, (cs.DENSE_ROWS,), generator=gen, device=dev).to(torch.float32)
w = torch.rand((cs.DENSE_ROWS,), generator=gen, device=dev)
dense_table = Table({"features": X, "label": y, "weight": w})
s_idx, s_vals, s_y = cs.sparse_data(dev)
sparse_table = Table({"features": SparseBatch(cs.SPARSE_DIM, s_idx, s_vals), "label": s_y})
km_table = Table({"features": cs.kmeans_data(dev)})
stream_cols = cs.stream_lr_data()
km_cols = {"features": km_table.column("features").cpu().numpy()}
truth = np.random.default_rng(cs.ONLINE_SEED).standard_normal(cs.DIM).astype(np.float32)
online_cols = cs.planted_rows(cs.ONLINE_SEED, cs.DENSE_ROWS, truth)
held_table = cs.device_table(cs.planted_rows(cs.HELD_OUT_SEED, cs.BATCH, truth), cs.BATCH, dev)
port_config.datacache_memory_budget_bytes = cs.STREAM_CACHE_BUDGET
LR = logisticregression.LogisticRegression
traces = {"online lr": {}}
runs = {
    "dense lr": {"model": cs.estimator(LR, "weight").fit(dense_table)},
    "sparse lr": {"model": cs.estimator(LR).fit(sparse_table)},
    "stream lr": {"model": cs.estimator(LR, "weight").fit(
        cs.stream_of(stream_cols, cs.DENSE_ROWS, cs.STREAM_CHUNK))},
    "stream kmeans": {"model": cs.kmeans_estimator().fit(
        cs.stream_of(km_cols, cs.KMEANS_ROWS, cs.KMEANS_CHUNK))},
    "online lr": {"model": cs.online_lr_fit(online_cols, traces["online lr"])},
}
from flink_ml_tpu_torch.ops import losses  # noqa: E402
from flink_ml_tpu_torch.ops.optimizer import SGD  # noqa: E402

runs["sparse lr"]["plain_coefficient"] = SGD(
    max_iter=cs.MAX_ITER, learning_rate=cs.LEARNING_RATE, global_batch_size=cs.BATCH,
    tol=cs.TOL).optimize(np.zeros(cs.SPARSE_DIM), (s_idx, s_vals), s_y, None,
                         losses.PLAIN_SPARSE_VARIANTS["binary_logistic"])[0]
cs.log(f"setup {time.perf_counter() - t_start:.1f} s ({card})")
result = cs.checkpoint_phase(sk, dev, card, runs, traces, dense_table, sparse_table, stream_cols,
                             km_cols, online_cols, held_table)
cs.log(f"total {time.perf_counter() - t_start:.1f} s")
print(card)
