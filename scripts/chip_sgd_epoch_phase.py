#!/usr/bin/env python3
"""chip_smoke.py's SGD epoch kernels (phase 2's `sgd_epoch_phase`) alone
on the card, then the card's cases of tests/test_torch_sgd_fused.py.

    python3 scripts/chip_sgd_epoch_phase.py      # from the repository root

It builds csrc/sgd_epoch.cu (with csrc/sparse_kernels.cu, started
together), prints each kernel's registers, holds the update and the
pointwise pass against their plain versions at the fits' shapes and times
them, then runs `pytest --noconftest tests/test_torch_sgd_fused.py -m
card` (the tests' conftest imports JAX, which the card's machine need not
have). Exits non-zero on a failed gate or test. About two minutes on an
H100."""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t_start = time.perf_counter()
from flink_ml_tpu_torch.ops import cuda_build  # noqa: E402
from flink_ml_tpu_torch.ops import sgdkernels  # noqa: E402

dev = torch.device("cuda")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
sgdkernels.build()
cs.log(f"build: sgd_epoch.cu with sparse_kernels.cu in {time.perf_counter() - t_start:.2f} s "
       f"({card})")
for kernel, usage in cs.resource_usage(cuda_build, "sgd_epoch").items():
    cs.log(f"  registers sgd_epoch {kernel}: {usage}")
results = cs.sgd_epoch_phase(dev)
cs.log("sgd_epoch " + json.dumps({"card": card, **results}))
tests = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                        "-q", "-m", "card", "tests/test_torch_sgd_fused.py"], cwd=ROOT)
cs.log(f"total {time.perf_counter() - t_start:.1f} s")
sys.exit(tests.returncode)
