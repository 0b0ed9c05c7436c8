"""Build and load the port's CUDA sources at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with ctypes. Outputs go
to `flink_ml_tpu_torch/_build/`, named by a hash of the source and flags,
so an edited source rebuilds and an unchanged one is reused. Nothing is
built at import time: the CPU tests import every module without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the port's CUDA "
            "kernels are built from source at first use"
        )
    return found


def _library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load_all(names) -> List[ctypes.CDLL]:
    """The loaded libraries for `csrc/<name>.cu`, one per name. The sources
    without an up-to-date library compile at the same time, one nvcc each;
    every nvcc is waited for before any failure is raised, with the
    compiler's output."""
    with _lock:
        started = {}
        for name in names:
            out = _library_path(name)
            if name in _libs or name in started or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in started.items():
            output = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu:\n{output}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return [_libs[name] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    return load_all([name])[0]
