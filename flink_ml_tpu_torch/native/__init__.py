"""ctypes loaders of the native host libraries.

The C++ sources under `native/src/` (host code, shared with the JAX
package) are each compiled alone with g++ into `flink_ml_tpu_torch/_build/`
at first use, and rebuilt when the source is newer than the library:

- `datacache.cc`, the spillable data cache and the delimited-number
  parser (`load`, `native/datacache.py`);
- `hashkernels.cc`, the hashing-trick kernels of FeatureHasher
  (`load_hashkernels`, `native/hashkernels.py`), built with the JAX
  package's `-ffp-contract=off` and with `<version>` included first: the
  source tests `__cpp_lib_to_chars` before it includes a header that
  defines it, so without it a compiler that has `std::to_chars` for
  doubles still takes the fallback that probes `snprintf` at up to 17
  precisions a value (both give the shortest round-trip digits; the
  fallback is about 50 times slower);
- `agglomerative.cc`, AgglomerativeClustering's merge loop
  (`load_agglomerative`), built with `-ffp-contract=off` as the JAX
  package builds it: a fused multiply-add would move a Lance-Williams
  distance by an ulp and reorder ties, and the loop must repeat the numpy
  loop's arithmetic.

A failed build raises with the compiler's output: the port has no silent
pure-Python fallback. `available()` and `has_symbol(name)` ask without
raising, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "src" / "datacache.cc"
LIBRARY = _PKG / "_build" / "libdatacache.so"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
HASH_SOURCE = _PKG.parent / "native" / "src" / "hashkernels.cc"
HASH_LIBRARY = _PKG / "_build" / "libhashkernels.so"
HASH_GXX_FLAGS = GXX_FLAGS + ("-ffp-contract=off", "-include", "version")
AGG_SOURCE = _PKG.parent / "native" / "src" / "agglomerative.cc"
AGG_LIBRARY = _PKG / "_build" / "libagglomerative.so"
AGG_GXX_FLAGS = GXX_FLAGS + ("-ffp-contract=off",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: loaded libraries by path: a library asked for at another path is built anew
_libs: Dict[Path, ctypes.CDLL] = {}


def _build(source: Path, library: Path, flags: Sequence[str]) -> None:
    """Compile to a file of this process, then rename it into place, so
    processes that build at once never load a half-written library."""
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *flags, "-o", str(tmp), str(source)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {source}:\n{proc.stderr}")
    os.replace(tmp, library)


def _open(source: Path, library: Path, flags: Sequence[str]) -> ctypes.CDLL:
    """The library of `source`, built first if it is missing or older."""
    if not library.exists() or library.stat().st_mtime < source.stat().st_mtime:
        _build(source, library, flags)
    return ctypes.CDLL(str(library))


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
    lib.dc_parse_csv_doubles.restype = long_
    lib.dc_parse_csv_doubles.argtypes = [ctypes.c_char_p, u64, p, u64]


def _declare_hashkernels(lib: ctypes.CDLL) -> None:
    p, i32, long_ = ctypes.c_void_p, ctypes.c_int32, ctypes.c_long
    lib.fh_hash_categorical_doubles.restype = None
    lib.fh_hash_categorical_doubles.argtypes = [p, long_, p, long_, i32, p]
    lib.fh_hash_categorical_utf32.restype = None
    lib.fh_hash_categorical_utf32.argtypes = [p, long_, long_, p, long_, i32, p]
    lib.fh_combine.restype = None
    lib.fh_combine.argtypes = [p, p, long_, long_, p, p]


def _declare_agglomerative(lib: ctypes.CDLL) -> None:
    p, long_, int_ = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.agg_cluster.restype = long_
    lib.agg_cluster.argtypes = [p, long_, int_, ctypes.c_double, int_, long_, int_, p, p]


def load() -> ctypes.CDLL:
    """The data cache library, built first if it is missing or older than
    its source."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _open(SOURCE, LIBRARY, GXX_FLAGS)
            _declare(lib)
            _lib = lib
        return _lib


def load_hashkernels() -> ctypes.CDLL:
    """The hashing-trick library, built first if it is missing or older
    than its source."""
    with _lock:
        lib = _libs.get(HASH_LIBRARY)
        if lib is None:
            lib = _open(HASH_SOURCE, HASH_LIBRARY, HASH_GXX_FLAGS)
            _declare_hashkernels(lib)
            _libs[HASH_LIBRARY] = lib
        return lib


def load_agglomerative() -> ctypes.CDLL:
    """The agglomerative merge-loop library, built first if it is missing
    or older than its source."""
    with _lock:
        lib = _libs.get(AGG_LIBRARY)
        if lib is None:
            lib = _open(AGG_SOURCE, AGG_LIBRARY, AGG_GXX_FLAGS)
            _declare_agglomerative(lib)
            _libs[AGG_LIBRARY] = lib
        return lib


def available() -> bool:
    """True when the data cache library builds and loads."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def has_symbol(name: str) -> bool:
    """True when one of the native libraries exports `name` (each built
    first if it is missing or older than its source; one that does not
    build exports nothing)."""
    for loader in (load, load_hashkernels, load_agglomerative):
        try:
            lib = loader()
        except (OSError, RuntimeError):
            continue
        if hasattr(lib, name):
            return True
    return False
