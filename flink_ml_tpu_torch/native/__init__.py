"""ctypes loader of the native spillable data cache.

`native/src/datacache.cc` (host C++, shared with the JAX package) is
compiled alone with `g++ -O2 -std=c++17 -shared -fPIC` into
`flink_ml_tpu_torch/_build/` at first use, and rebuilt when the source is
newer than the library. A failed build raises with the compiler's output:
the port has no pure-Python cache to fall back to. The JAX package's other
native sources (`hashkernels.cc`, `agglomerative.cc`) come with the stages
that use them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "src" / "datacache.cc"
LIBRARY = _PKG / "_build" / "libdatacache.so"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """Compile to a file of this process, then rename it into place, so
    processes that build at once never load a half-written library."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)


def _declare(lib: ctypes.CDLL) -> None:
    u64, p, long_ = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_long
    lib.dc_create.restype = p
    lib.dc_create.argtypes = [u64, ctypes.c_char_p]
    lib.dc_destroy.restype = None
    lib.dc_destroy.argtypes = [p]
    lib.dc_append.restype = long_
    lib.dc_append.argtypes = [p, p, u64]
    lib.dc_num_segments.restype = long_
    lib.dc_num_segments.argtypes = [p]
    lib.dc_segment_size.restype = u64
    lib.dc_segment_size.argtypes = [p, long_]
    lib.dc_read.restype = ctypes.c_int
    lib.dc_read.argtypes = [p, long_, p]
    lib.dc_memory_used.restype = u64
    lib.dc_memory_used.argtypes = [p]
    lib.dc_spilled_segments.restype = long_
    lib.dc_spilled_segments.argtypes = [p]
    lib.dc_spilled_bytes.restype = u64
    lib.dc_spilled_bytes.argtypes = [p]


def load() -> ctypes.CDLL:
    """The data cache library, built first if it is missing or older than
    its source."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
            _declare(lib)
            _lib = lib
        return _lib
