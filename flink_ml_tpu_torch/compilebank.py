"""The program bank: the signatures a process captured, for the next one.

Port of flink_ml_tpu/compilebank.py. The JAX package serializes compiled
executables so that a fresh process neither traces nor compiles. A CUDA
graph cannot be serialized, so here an entry is a **signature**: the
kernel id, the descriptors of its tensor operands (shape, dtype, strides,
device type), the tokens of its static arguments (`static_token`) and its
extras (a fused segment's guard messages). A fresh process **warm-loads**
the bank: it captures every banked signature ahead of its first call, on
synthetic operands (zeros of the banked shapes),

- at load time (`active_bank()`) for the program funnel's wrappers
  (utils/lazyjit.py: the whole fits), whose kernel ids name a module
  function and whose statics the tokens rebuild (`register_static_type`);
- at a fused segment's first call, or `MicroBatchServer.warmup` /
  `ModelStore.warmup_programs`, for the segments (pipeline.FusedSegment),
  whose stages only exist once a model is served.

A warm load ticks `jit.bankLoads` (and the `bank.load` timer and event),
never `jit.traces`: `jit.traces` counts the captures a call had to wait
for. So a fresh process whose bank holds its serving and fit signatures
captures nothing on its first serve (after `warmup`) and its first
banked fit.

On-disk contract (the JAX package's, compilebank.py:1-45):

- `manifest.json`: the environment fingerprint (format version, torch and
  CUDA versions, the card's name and count, a digest of the kernels'
  CUDA sources) and one record per entry (file name, sha256 digest,
  kernel id), committed atomically (`ckpt.coordinator.atomic_commit`):
  a reader never sees a torn manifest;
- `<sighash>.pbx`: the entry, JSON, also committed atomically.

Refusals: a fingerprint mismatch or an unreadable manifest refuses the
whole bank; a digest mismatch or an unparseable or unloadable entry
refuses that entry. Each is a warning and a `bank.refused` tick, never a
crash, and the refused signatures are captured at their first call as
without a bank. Counters: `bank.hits` (a call served by a banked graph),
`bank.misses` (a call that captured), `bank.backfills` (entries
written), `bank.refused`, `bank.unbankable` (a call whose statics have no
token), the `bank.entries` gauge, `jit.bankLoads`.
"""

from __future__ import annotations

import ast
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from . import config
from .utils.metrics import inc_counter, record_time, set_gauge

logger = logging.getLogger(__name__)

#: bump when the entry schema or the signature descriptor changes
FORMAT_VERSION = 1

MANIFEST = "manifest.json"
ENTRY_SUFFIX = ".pbx"


# ---------------------------------------------------------------------------
# static tokens
# ---------------------------------------------------------------------------

#: class name -> factory(name) that rebuilds a named singleton from its token
_STATIC_TYPES: Dict[str, Callable[[str], Any]] = {}


def register_static_type(class_name: str, factory: Callable[[str], Any]) -> None:
    """Let tokens `"<class_name>:<name>"` be rebuilt as `factory(name)` (a
    warm load rebuilds a banked call's static arguments)."""
    _STATIC_TYPES[class_name] = factory


def static_token(value) -> Optional[str]:
    """A process-restart-stable token for one static argument, or None
    when the value has no stable identity (such a call is unbankable)."""
    name = getattr(value, "name", None)
    if isinstance(name, str) and not isinstance(value, (str, bytes)):
        # named singletons (LossFunc and friends): class + declared name,
        # only where the name rebuilds this very object
        factory = _STATIC_TYPES.get(type(value).__name__)
        if factory is not None:
            try:
                if factory(name) is not value:
                    return None
            except (KeyError, ValueError):
                return None
        return f"{type(value).__name__}:{name}"
    if value is None or isinstance(value, (bool, int, float, str)):
        return repr(value)
    if isinstance(value, (tuple, list)):
        parts = [static_token(v) for v in value]
        if any(p is None for p in parts):
            return None
        return "(" + ",".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if isinstance(value, dict):
        items = []
        for k in sorted(value, key=repr):
            kt, vt = static_token(k), static_token(value[k])
            if kt is None or vt is None:
                return None
            items.append(f"{kt}:{vt}")
        return "{" + ",".join(items) + "}"
    return None


def static_value(token: str) -> Any:
    """The value a `static_token` stands for (a named singleton through
    its registered factory). Raises ValueError for an unknown token."""
    head, sep, rest = token.partition(":")
    if sep and head in _STATIC_TYPES and not token.startswith(("'", '"', "(", "{")):
        return _STATIC_TYPES[head](rest)
    try:
        return ast.literal_eval(token)
    except (ValueError, SyntaxError) as exc:
        raise ValueError(f"static token {token!r} cannot be rebuilt") from exc


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

_SOURCES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def _sources_digest() -> str:
    digest = hashlib.sha256()
    if os.path.isdir(_SOURCES):
        for name in sorted(os.listdir(_SOURCES)):
            if name.endswith((".cu", ".cuh", ".h")):
                with open(os.path.join(_SOURCES, name), "rb") as f:
                    digest.update(name.encode() + b"\0" + f.read())
    return digest.hexdigest()[:32]


def env_fingerprint() -> Dict[str, Any]:
    """The bank-wide compatibility key: a graph captured from a signature
    runs the same kernels only on the same torch, CUDA, card and kernel
    sources."""
    cuda = torch.cuda.is_available()
    return {
        "formatVersion": FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "deviceCount": torch.cuda.device_count() if cuda else 0,
        "kernelSources": _sources_digest(),
    }


def signature_digest(kernel_id: str, sig) -> str:
    return hashlib.sha256(json.dumps([kernel_id, repr(sig)]).encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

class ProgramBank:
    """One on-disk program bank and the signatures it holds. Thread-safe;
    every write is an atomic replace."""

    def __init__(self, path: str, warm_load: bool = True):
        self.path = path
        self._lock = threading.RLock()
        #: sig digest -> the entry (kernel, leaves, structure, statics, extras)
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._manifest_entries: Dict[str, Dict[str, Any]] = {}
        self._fingerprint = env_fingerprint()
        self._warned: set = set()
        self.load_ms = 0.0
        os.makedirs(path, exist_ok=True)
        self._read()
        if warm_load:
            self.warm_load_funnel()

    # -- reading -------------------------------------------------------------
    def _read(self) -> None:
        manifest_path = os.path.join(self.path, MANIFEST)
        if not os.path.exists(manifest_path):
            return
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
            entries = dict(manifest.get("entries") or {})
        except Exception as exc:  # torn/corrupt manifest: refuse the bank
            self._refuse(f"unreadable manifest ({exc}); starting empty")
            return
        if manifest.get("fingerprint") != self._fingerprint:
            self._refuse(
                "fingerprint mismatch "
                f"(bank {manifest.get('fingerprint')} vs process {self._fingerprint}); "
                "refusing every entry")
            return
        for sig, record in entries.items():
            entry_path = os.path.join(self.path, str(record.get("file", "")))
            try:
                with open(entry_path, "rb") as f:
                    raw = f.read()
            except OSError as exc:
                self._refuse(f"entry {sig} unreadable ({exc})")
                continue
            if hashlib.sha256(raw).hexdigest() != record.get("sha256"):
                self._refuse(f"entry {sig} digest mismatch — stale or torn payload, refused "
                             "like a corrupt snapshot shard")
                continue
            try:
                entry = json.loads(raw.decode())
                if not isinstance(entry.get("kernel"), str) or not isinstance(
                        entry.get("leaves"), list):
                    raise ValueError("not a bank entry")
            except Exception as exc:
                self._refuse(f"entry {sig} failed to deserialize ({exc})")
                continue
            self._entries[sig] = entry
            self._manifest_entries[sig] = record
        set_gauge("bank.entries", len(self._entries))

    def _refuse(self, why: str) -> None:
        inc_counter("bank.refused")
        if why not in self._warned:
            self._warned.add(why)
            logger.warning("program bank %s: %s — falling back to capture at first call",
                           self.path, why)

    def entries_for(self, kernel_id: str) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            return [(s, e) for s, e in self._entries.items() if e["kernel"] == kernel_id]

    def count_hit(self) -> None:
        inc_counter("bank.hits")

    def count_miss(self) -> None:
        inc_counter("bank.misses")

    # -- warm loads ----------------------------------------------------------
    def _timed_load(self, kernel_id: str, load: Callable[[], None]) -> bool:
        from .obs import tracing

        start = time.perf_counter()
        try:
            load()
        except Exception as exc:
            self._refuse(f"entry of {kernel_id} failed to load ({type(exc).__name__}: {exc})")
            return False
        dt = time.perf_counter() - start
        self.load_ms += dt * 1000.0
        record_time("bank.load", dt)
        inc_counter("jit.bankLoads")
        tracing.event("bank.load", kernel=kernel_id, category="cache")
        return True

    def warm_load_funnel(self) -> int:
        """Capture every banked signature of the program funnel's wrappers
        (their modules imported on demand). Returns the count loaded."""
        from .utils import lazyjit

        loaded = 0
        kernels = sorted({e["kernel"] for e in self._entries.values() if e.get("funnel")})
        for kernel_id in kernels:
            kernel = lazyjit.registered(kernel_id)
            if kernel is None:
                self._refuse(f"kernel {kernel_id} is not registered in this process")
                continue
            kernel.warmed_bank = self
            loaded += self.warm_load_kernel(kernel)
        return loaded

    def warm_load_kernel(self, kernel) -> int:
        """Capture each banked signature of one funnel wrapper."""
        loaded = 0
        for sig, entry in self.entries_for(kernel.kernel_id):
            def load(entry=entry):
                device = _device_for(entry)
                leaves = [synthetic_leaf(d, device) for d in entry["leaves"]]
                structure = _decode_structure(entry["structure"])
                statics = {k: static_value(t) for k, t in entry["statics"].items()}
                kernel.warm_load(device, leaves, structure, statics)
            loaded += self._timed_load(kernel.kernel_id, load)
        return loaded

    def warm_load_segment(self, kernel_id: str, load_one: Callable[[Dict[str, Any]], None]) -> int:
        """Capture each banked signature of one fused segment through
        `load_one(entry)` (the segment synthesizes its feed)."""
        return sum(self._timed_load(kernel_id, lambda e=e: load_one(e))
                   for _, e in self.entries_for(kernel_id))

    # -- back-fill -----------------------------------------------------------
    def offer_signature(self, kernel_id: str, sig, leaves, statics) -> None:
        """Bank one funnel signature (once)."""
        tokens = {}
        for name, value in statics.items():
            token = static_token(value)
            if token is None:
                inc_counter("bank.unbankable")
                return
            tokens[name] = token
        structure = sig[1]
        if "<" in structure:  # an operand tree holding a value without a token
            inc_counter("bank.unbankable")
            return
        digest = signature_digest(kernel_id, sig)
        if digest in self._entries:
            return
        from .utils import lazyjit

        self.offer(digest, {
            "kernel": kernel_id,
            "funnel": True,
            "leaves": [leaf_json(lazyjit.leaf_descriptor(x)) for x in leaves],
            "structure": structure,
            "statics": tokens,
            "extras": None,
        })

    def offer(self, digest: str, entry: Dict[str, Any]) -> None:
        """Persist one entry and the manifest, atomically."""
        from .ckpt.coordinator import atomic_commit

        raw = json.dumps(entry, sort_keys=True).encode()
        with self._lock:
            self._entries[digest] = entry
            inc_counter("bank.backfills")
            set_gauge("bank.entries", len(self._entries))
            fname = digest + ENTRY_SUFFIX
            atomic_commit(os.path.join(self.path, fname), lambda tmp: _write_bytes(tmp, raw),
                          site="bank.entry")
            self._manifest_entries[digest] = {"file": fname,
                                              "sha256": hashlib.sha256(raw).hexdigest(),
                                              "kernel": entry["kernel"]}
            manifest = {"fingerprint": self._fingerprint, "entries": self._manifest_entries}
            atomic_commit(os.path.join(self.path, MANIFEST),
                          lambda tmp: _write_bytes(
                              tmp, json.dumps(manifest, sort_keys=True, indent=1).encode()),
                          site="bank.manifest")

    def populate(self, programs: Iterable[Tuple[Callable, Tuple, Dict[str, Any]]]) -> int:
        """Drive each declared `(callable, args, kwargs)` program once, so
        the funnels back-fill the bank ahead of traffic. Returns the number
        of programs driven."""
        n = 0
        for fn, args, kwargs in programs:
            fn(*args, **(kwargs or {}))
            n += 1
        return n

    def stats(self) -> Dict[str, float]:
        return {"entries": float(len(self._entries)), "loadMs": self.load_ms}


def _write_bytes(path: str, raw: bytes) -> None:
    with open(path, "wb") as f:
        f.write(raw)


def leaf_json(desc) -> Dict[str, Any]:
    """A banked operand: a `lazyjit.leaf_descriptor` as JSON."""
    shape, dtype, stride, device = desc
    return {"shape": list(shape), "dtype": dtype, "stride": list(stride), "device": device}


def _device_for(entry) -> torch.device:
    types = {leaf["device"] for leaf in entry["leaves"]}
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise RuntimeError("a card's entry in a process without a card")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def synthetic_leaf(desc: Dict[str, Any], device: torch.device) -> torch.Tensor:
    """Zeros of a banked operand's shape, dtype and strides."""
    dtype = getattr(torch, desc["dtype"])
    return torch.empty_strided(tuple(desc["shape"]), tuple(desc["stride"]), dtype=dtype,
                               device=device).zero_()


def _decode_structure(token: str):
    """The funnel's tree structure for a banked call: its structure token
    parsed back (tuples, lists, dicts of leaves and static values)."""
    tree = ast.parse(token.replace("*", "__LEAF__"), mode="eval").body

    def build(node):
        if isinstance(node, ast.Name) and node.id == "__LEAF__":
            return ("*",)
        if isinstance(node, ast.Tuple):
            return ("T", tuple(build(e) for e in node.elts))
        if isinstance(node, ast.List):
            return ("L", tuple(build(e) for e in node.elts))
        if isinstance(node, ast.Dict):
            return ("D", tuple((ast.literal_eval(k), build(v))
                               for k, v in zip(node.keys, node.values)))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            cls = _NAMED_TUPLES.get(node.func.id)
            if cls is None:
                raise ValueError(f"unknown named tuple {node.func.id} in a bank entry")
            return ("N", cls, tuple(build(a) for a in node.args))
        return ("V", static_value(ast.unparse(node)))

    return build(tree)


#: named tuples that may appear in a funnel call's operands, by name
_NAMED_TUPLES: Dict[str, type] = {}


def register_named_tuple(cls: type) -> None:
    _NAMED_TUPLES[cls.__name__] = cls


# ---------------------------------------------------------------------------
# the active-bank singleton (config.program_bank_dir)
# ---------------------------------------------------------------------------

_active: Dict[str, Any] = {"path": None, "bank": None}
_active_lock = threading.RLock()


def active_bank() -> Optional[ProgramBank]:
    """The process's ProgramBank for `config.program_bank_dir`, warm-
    loaded on first use; None when the bank is off (the default)."""
    path = config.program_bank_dir
    if path is None:
        return None
    with _active_lock:
        if _active["path"] != path or _active["bank"] is None:
            _active["path"] = path
            _active["bank"] = None
            _active["bank"] = ProgramBank(path)
        return _active["bank"]


def reset_active_bank() -> None:
    """Drop the singleton; the next active_bank() loads afresh."""
    with _active_lock:
        _active["path"] = None
        _active["bank"] = None


# ---------------------------------------------------------------------------
# one banked call (the extras contract)
# ---------------------------------------------------------------------------

def banked_call(bank: ProgramBank, kernel_id: str, fn: Callable, args: Tuple,
                kwargs: Dict[str, Any], static_argnames: Tuple[str, ...] = (),
                extras_fn: Optional[Callable[[], dict]] = None,
                on_extras: Optional[Callable[[Optional[dict]], None]] = None):
    """Run `fn(*args, **kwargs)` as one banked program under `kernel_id`.
    Returns (handled, result); handled is False when a static argument has
    no token. A hit hands the entry's extras to `on_extras`; a miss
    persists `extras_fn()` with the signature and hands them over."""
    from .utils import lazyjit

    kernel = lazyjit._registry.get(kernel_id)
    if kernel is None or kernel.fn is not fn:
        kernel = lazyjit._Kernel(fn, kernel_id, tuple(static_argnames), None)
    leaves, structure, statics, _ = kernel.split(args, kwargs)
    if any(static_token(v) is None for v in statics.values()):
        inc_counter("bank.unbankable")
        return False, None
    sig = kernel.signature(leaves, structure, statics)
    digest = signature_digest(kernel_id, sig)
    entry = bank._entries.get(digest)
    result = kernel(*args, **kwargs)
    if entry is not None:
        extras = entry.get("extras")
    else:
        extras = extras_fn() if extras_fn is not None else None
        stored = dict(bank._entries.get(digest) or {})
        if stored:
            stored["extras"] = extras
            bank.offer(digest, stored)
    if on_extras is not None:
        on_extras(extras)
    return True, result
