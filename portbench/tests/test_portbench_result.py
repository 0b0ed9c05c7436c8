"""The result line: only the contract's keys, the checks last, on
standard output's last line; the checks also close standard error. A run
without a card prints no result and fails, as does a checkout that holds
only the benchmark's files."""

import io
import json
import os
import shutil
import subprocess
import sys

from conftest import run_on_cpu, tiny_cell
from portbench import harness, trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def test_last_line_has_only_the_contracts_keys():
    result = run_on_cpu(tiny_cell("lr_sparse.score_10m"))
    out, err = io.StringIO(), io.StringIO()
    harness.report(result, err=err, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) <= KEYS and {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    assert {"setup_s", "score_rows_per_s"} == set(line["metrics"])


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", "lr_sparse.fit_sweep",
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = ("import time, torch\n"
              "from portbench import harness\n"
              "from portbench.tests.conftest import tiny_cell\n"
              "harness.report(harness.run(tiny_cell('lr_sparse.fit_sweep'), 1, 0.1, False,"
              " torch.device('cpu'), time.perf_counter()))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "flink_ml_tpu_torch" in proc.stderr


def test_trace_reduction(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.fit", "ts": 0, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 20, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::row_dots_kernel(int const*)",
         "ts": 40, "dur": 10, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "sparse_grad_kernel(int const*, float*)", "ts": 45,
         "dur": 15, "pid": 0, "tid": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 80,
         "dur": 10, "pid": 0, "tid": 7},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.reduce_trace(str(path))
    assert got["window_s"] == 100e-6 and abs(got["busy_s"] - 30e-6) < 1e-12
    assert got["kernels"]["row_dots_kernel"] == [10e-6, 1]
    assert got["kernels"]["sparse_grad_kernel"] == [15e-6, 1]
    # idle: [0, 40) mid 20 inside aten::copy_; [60, 80) and [90, 100) inside the annotation only
    assert abs(got["idle_by_host"]["aten::copy_"] - 40e-6) < 1e-12
    assert abs(got["idle_by_host"]["portbench.fit"] - 30e-6) < 1e-12
