#!/usr/bin/env python3
"""chip_smoke.py's phase 19 (the port's benchmark CLI over conf/) alone on
the card.

    python3 scripts/chip_benchmark_phase.py      # from the repository root

It runs `chip_smoke.benchmark_phase`: one child process runs `python -m
flink_ml_tpu_torch.benchmark` over conf/benchmark-demo.json and every
conf/*-benchmark.json at their own shapes under the sanitizer, and the
phase prints each entry and exits non-zero on a failed gate. It builds
no CUDA kernel (no conf/ entry is sparse); the native host libraries are
built by g++ at first use."""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t_start = time.perf_counter()
if not torch.cuda.is_available():
    sys.exit("chip_benchmark_phase: no CUDA device is available")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
result = cs.benchmark_phase(card)
cs.log(f"total {time.perf_counter() - t_start:.1f} s")
print(card)
