"""`flink_ml_tpu_torch/utils/traceprof.py` on chrome traces the test writes.

`analyze_trace` reduces a torch.profiler chrome trace to the union of the
device intervals (kernels, copies and sets on any stream, overlaps counted
once), the traced window and its idle share, and the top kernels, from
plain or gzipped JSON. The expected values are computed in the test from
the same seeded intervals. `capture_trace` runs a CPU call under
torch.profiler and reads back its own export (no device events on the
CPU: idle share 1).
"""

import gzip
import json

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch.utils import traceprof


def _trace(seed, n=40):
    rng = np.random.default_rng(seed)
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    for i in range(n):
        cat = ["kernel", "gpu_memcpy", "gpu_memset", "cpu_op", "cuda_runtime"][int(rng.integers(5))]
        ts, dur = float(rng.integers(0, 5000)), float(rng.integers(1, 300))
        events.append({"ph": "X", "cat": cat, "name": f"{cat}{i % 4}", "ts": ts, "dur": dur,
                       "pid": 0, "tid": int(rng.integers(7, 9))})
    events.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0})
    return {"traceEvents": events}


def _expected(trace):
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in spans if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")]
    covered = np.zeros(6000, bool)
    for e in device:
        covered[int(e["ts"]):int(e["ts"] + e["dur"])] = True
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    return covered.sum() / 1000.0, (hi - lo) / 1000.0, len(device)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_analyze_trace(tmp_path, seed, gz):
    trace = _trace(seed)
    path = tmp_path / ("t.json.gz" if gz else "t.json")
    raw = json.dumps(trace).encode()
    path.write_bytes(gzip.compress(raw) if gz else raw)
    stats = traceprof.analyze_trace(str(path))
    busy, window, count = _expected(trace)
    assert stats["deviceBusyMs"] == pytest.approx(busy, rel=1e-12)
    assert stats["windowMs"] == pytest.approx(window, rel=1e-12)
    assert stats["deviceIdleShare"] == pytest.approx(1.0 - busy / window, rel=1e-12)
    assert stats["deviceEvents"] == count
    assert sum(v["count"] for v in stats["byCategory"].values()) == count
    durations = [v["durUs"] for v in stats["topKernels"].values()]
    assert durations == sorted(durations, reverse=True)
    assert "hbmBytesAccessed" not in stats and "modelFlops" not in stats


def test_upload_overlap(tmp_path):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 40.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 60.0,
         "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 0.0,
         "dur": 10.0},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    stats = traceprof.analyze_trace(str(path))
    assert stats["hostToDeviceMs"] == pytest.approx(0.02)
    assert stats["hostToDeviceUnderKernelsMs"] == pytest.approx(0.01)
    assert stats["deviceBusyMs"] == pytest.approx(0.08)


def test_an_empty_trace_has_no_idle_share(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": []}))
    stats = traceprof.analyze_trace(str(path))
    assert stats["deviceBusyMs"] == 0.0 and stats["deviceIdleShare"] is None


def test_capture_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    stats = traceprof.capture_trace(lambda: a @ a, str(tmp_path))
    assert stats["wallMs"] > 0.0 and stats["deviceEvents"] == 0
    assert stats["deviceIdleShare"] == 1.0
    assert stats["tracePath"].startswith(str(tmp_path))
    assert traceprof.analyze_trace(stats["tracePath"])["windowMs"] == stats["windowMs"]
