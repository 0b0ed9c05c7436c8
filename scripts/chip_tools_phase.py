#!/usr/bin/env python3
"""chip_smoke.py's phase 20 (the repo's operator tools on the port) alone
on the card.

    python3 scripts/chip_tools_phase.py      # from the repository root

It builds the CUDA kernels, makes phase 3's sparse table (1M x 39, d 1e6,
seeded on the card), drives the sparse LR as phase 3 does (fit, transform,
save, load, transform; its launches counted) and fits its plain-loss twin
as phase 4 does, then runs `chip_smoke.tools_phase`: the traced fit in a
child, the trace report, the timeline, the fit-timeline and cold-start
smokes and the two writers, each a fresh process under the sanitizer. It
exits non-zero on a failed gate."""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t_start = time.perf_counter()
if not torch.cuda.is_available():
    sys.exit("chip_tools_phase: no CUDA device is available")
from flink_ml_tpu_torch import SparseBatch, Table  # noqa: E402
from flink_ml_tpu_torch.ops import cuda_build  # noqa: E402
from flink_ml_tpu_torch.ops import sparsekernels as sk  # noqa: E402

card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
cuda_build.load_all(("sparse_kernels",))
sk.build()
dev = torch.device("cuda")
s_idx, s_vals, s_y = cs.sparse_data(dev)
table = Table({"features": SparseBatch(cs.SPARSE_DIM, s_idx, s_vals), "label": s_y})
with tempfile.TemporaryDirectory() as tmp:
    sk.reset_launch_counts()
    run = cs.drive(lambda: cs.estimator(cs.linear_class("lr")).fit(table), table, tmp, "sparse_lr")
    run["launches"] = sk.launch_counts()
cs.log(f"phase 3's sparse lr: launches {run['launches']}")
run["plain_coefficient"] = cs.check_sparse_linear("lr", run, s_idx, s_vals, s_y)
del table, s_idx, s_vals, s_y
torch.cuda.empty_cache()
result = cs.tools_phase(card, {"sparse lr": run})
cs.log("tools: " + cs.json.dumps(result))
cs.log(f"total {time.perf_counter() - t_start:.1f} s")
print(card)
