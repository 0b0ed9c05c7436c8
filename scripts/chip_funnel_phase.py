#!/usr/bin/env python3
"""chip_smoke.py's phase 14 (the program funnel, the program bank and a
traced run) alone on the card.

    python3 scripts/chip_funnel_phase.py      # from the repository root

It builds the sparse kernels, makes phase 3's dense, sparse and KMeans
tables from the same seeds, and runs `chip_smoke.funnel_phase`, which
prints each leg and exits non-zero on a failed gate. About a minute on
an H100."""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t_start = time.perf_counter()
from flink_ml_tpu_torch import SparseBatch, Table  # noqa: E402
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
cs.log(f"setup {time.perf_counter() - t_start:.1f} s ({card})")
with tempfile.TemporaryDirectory() as tmp:
    result, launches = cs.funnel_phase(sk, dev, card, dense_table, sparse_table, km_table, tmp)
cs.log("launches by path: " + str(launches))
cs.log(f"total {time.perf_counter() - t_start:.1f} s")
print(card)
