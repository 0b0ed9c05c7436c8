"""JobSnapshot: the whole-job checkpoint format.

Port of flink_ml_tpu/ckpt/snapshot.py, file for file the same format, so a
snapshot written by one package resumes in the other. A snapshot holds
named *sections* of host pytrees:

- `model`: the training carry (coefficients or centroids, gradient, weight
  sum, epoch counter; the FTRL state of the online estimators);
- `rng`: the host generator state of a fit that keeps one (KMeans' stream
  init);
- `fleet`, `cache`: the fleet carry, the stream cache's contents.

A pytree here is a tuple, list or dict (keys in sorted order) of leaves,
with None an empty subtree: the leaf order of `jax.tree_util`, which the
manifest records positionally.

Device leaves of every section are gathered to the host in ONE packed
copy (`utils.packing.packed_bytes_get`: their bytes concatenated on the
card, one copy into page-locked memory, every dtype kept), accounted as
one host sync of kind `checkpoint`. The manifest records a sharding-spec
tag per leaf (`replicated` / `data` / `model` / `host`); on one card
`stage_section` puts every non-`host` leaf on the caller's device, and the
tags wait for the multi-card layout (ROADMAP A.10).

On disk (version 1): one `snap-<jobkey>.npz` per job key, a JSON
`manifest` entry (version, job key, epoch, criteria, per-section leaf
inventory with dtype, shape, spec and a crc32 of the leaf's bytes, free
meta) and one array entry `s_<section>_<i>` per leaf. The write is a temp
file then `os.replace`, with the `snapshot.write` fault site between the
two, so a reader never sees a torn snapshot. Meta carries the data-plane
cursors (`numBatches`, `numSegments`, `globalBatchSize`, `streamOffset`,
`cacheCursor`); `load_job_snapshot(expect_meta=...)` refuses a snapshot
whose cursors disagree with the job being resumed. With
`config.snapshot_hosts` set the cut is sharded over simulated hosts
(ckpt/coordinator.py), and a directory holding committed sharded cuts
restores from them.

Legacy migration (one way): with no snapshot, the loader reads the
carry-only `ckpt-*.npz` that `parallel.iteration.save_iteration_checkpoint`
writes.

Obs: `checkpoint.save` / `checkpoint.restore` spans, `checkpoint.bytes`,
`checkpoint.count`, `checkpoint.restore.count` and
`checkpoint.digest.mismatch` counters.
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import flow
from ..utils import metrics
from . import faults

__all__ = [
    "SNAPSHOT_VERSION",
    "JobSnapshot",
    "snapshot_file",
    "save_job_snapshot",
    "load_job_snapshot",
    "stage_section",
    "conform",
    "tree_flatten",
    "tree_unflatten",
]

SNAPSHOT_VERSION = 1

# sharding-spec tags a leaf may carry in the manifest
_SPEC_TAGS = ("replicated", "data", "model", "host")

_UNKEYED_WARNING = (
    "un-keyed job-snapshot restore: without a checkpoint_job_key, a "
    "structurally compatible snapshot from a DIFFERENT job sharing this "
    "directory would positionally cross-restore into this one. Pass "
    "checkpoint_job_key (parallel.iteration.checkpoint_job_key) to "
    "namespace the snapshot per job identity."
)


# ---------------------------------------------------------------------------
# pytrees: jax.tree_util's leaf order for tuples, lists, dicts and None
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef): tuples, lists and NamedTuples in order, dicts by
    sorted key, None holds no leaf, anything else is a leaf."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), tuple(walk(c) for c in node))
        if isinstance(node, (tuple, list)):
            return (type(node).__name__, tuple(walk(c) for c in node))
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The inverse of `tree_flatten`."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "namedtuple":
            return d[1](*(build(c) for c in d[2]))
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return tuple(children) if kind == "tuple" else children

    return build(treedef)


@dataclass
class JobSnapshot:
    """A restored snapshot. `sections` holds host pytrees (unflattened
    against the loader's templates; untemplated sections stay flat leaf
    lists); `specs` the per-leaf sharding tags in flattened order; `meta`
    the free-form JSON side channel."""

    job_key: Optional[str]
    epoch: int
    criteria: float
    sections: Dict[str, Any]
    specs: Dict[str, Sequence[str]] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)
    version: int = SNAPSHOT_VERSION
    path: Optional[str] = None


def snapshot_file(path: str, job_key: Optional[str]) -> str:
    if job_key is None:
        return os.path.join(path, "snap.npz")
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", job_key)
    return os.path.join(path, f"snap-{safe}.npz")


def _normalize_specs(specs: Union[None, str, Sequence[str]], num_leaves: int,
                     section: str) -> Sequence[str]:
    if specs is None:
        specs = "replicated"
    if isinstance(specs, str):
        specs = (specs,) * num_leaves
    specs = tuple(specs)
    if len(specs) != num_leaves:
        raise ValueError(f"section {section!r}: {len(specs)} spec tags for {num_leaves} leaves")
    for tag in specs:
        if tag not in _SPEC_TAGS:
            raise ValueError(f"unknown sharding-spec tag {tag!r} (one of {_SPEC_TAGS})")
    return specs


def leaf_crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _gather_sections(sections: Dict[str, Any], specs: Dict[str, Union[str, Sequence[str]]]):
    """Flatten every section to host arrays, the tensors of ALL sections in
    one packed copy, and build the manifest inventory (key, spec, dtype,
    shape and crc32 per leaf)."""
    from ..utils.packing import packed_bytes_get

    arrays: Dict[str, np.ndarray] = {}
    manifest_sections: Dict[str, Any] = {}
    gather: list = []
    gather_slots: list = []
    for name, tree in sections.items():
        leaves, _ = tree_flatten(tree)
        tags = _normalize_specs(specs.get(name), len(leaves), name)
        entries = []
        for i, leaf in enumerate(leaves):
            key = f"s_{name}_{i}"
            if isinstance(leaf, torch.Tensor):
                gather.append(leaf)
                gather_slots.append(key)
            else:
                arrays[key] = np.asarray(leaf)
            entries.append({"key": key, "spec": tags[i]})
        manifest_sections[name] = {"leaves": entries}
    if gather:
        for key, arr in zip(gather_slots, packed_bytes_get(*gather, sync_kind="checkpoint")):
            arrays[key] = arr
    for section in manifest_sections.values():
        for entry in section["leaves"]:
            arr = arrays[entry["key"]]
            entry["dtype"] = str(arr.dtype)
            entry["shape"] = list(arr.shape)
            entry["crc32"] = leaf_crc32(arr)
    return arrays, manifest_sections


def save_job_snapshot(
    path: str,
    job_key: Optional[str],
    sections: Dict[str, Any],
    *,
    epoch: int,
    criteria: float = 0.0,
    specs: Optional[Dict[str, Union[str, Sequence[str]]]] = None,
    meta: Optional[Dict[str, Any]] = None,
    hosts: Optional[int] = None,
    stable_sections: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Write a snapshot atomically; returns its path (the npz, or the
    committed manifest of a sharded cut), or None when a sharded cut was
    aborted by a straggler host (the previous cut stays restorable and
    training goes on).

    `hosts` (default `config.snapshot_hosts`) None is the single file;
    otherwise the two-phase sharded commit of `ckpt/coordinator.py`.
    `stable_sections` maps section names to zero-argument providers of
    immutable host-leaf tuples (the stream cache's contents), written once
    per job key and reused by later cuts; the single file ignores it."""
    from .. import config
    from ..obs import tracing
    from ..parallel import supervisor
    from . import coordinator

    specs = specs or {}
    n_hosts = hosts if hosts is not None else config.snapshot_hosts
    with tracing.span("checkpoint.save", jobKey=job_key or "", epoch=int(epoch)) as sp:
        arrays, manifest_sections = _gather_sections(sections, specs)
        nbytes = sum(a.nbytes for a in arrays.values())
        if n_hosts is not None:
            sp.set_attr("hosts", int(n_hosts))
            stable_specs = {name: tag for name, tag in specs.items()
                            if isinstance(tag, str) and name in (stable_sections or {})}
            try:
                target = coordinator.save_sharded(
                    path, job_key, arrays, manifest_sections, epoch=epoch,
                    criteria=criteria, meta=meta, hosts=int(n_hosts),
                    stable_sections=stable_sections, stable_specs=stable_specs,
                    snapshot_version=SNAPSHOT_VERSION,
                )
            except coordinator.SnapshotAborted as e:
                warnings.warn(f"snapshot cut aborted (epoch {epoch}): {e}")
                sp.set_attr("aborted", True)
                return None
            metrics.inc_counter("checkpoint.count")
            metrics.inc_counter("checkpoint.bytes", nbytes)
            sp.set_attr("bytes", nbytes)
            return target

        manifest = {
            "version": SNAPSHOT_VERSION,
            "jobKey": job_key,
            "epoch": int(epoch),
            "criteria": float(criteria),
            "sections": manifest_sections,
            "meta": meta or {},
        }
        os.makedirs(path, exist_ok=True)
        target = snapshot_file(path, job_key)
        # the supervised commit boundary: nothing is written yet, so an
        # abort here has nothing to sweep on the single-file path
        supervisor.pulse_boundary(supervisor.PHASE_COMMIT)
        # a transient write fault re-runs the whole temp-write-then-rename;
        # a fatal InjectedFault at `snapshot.write` kills the job mid-write
        coordinator.atomic_commit(
            target,
            lambda tmp: np.savez(tmp, manifest=np.asarray(json.dumps(manifest)), **arrays),
            site="snapshot.write",
        )
        metrics.inc_counter("checkpoint.count")
        metrics.inc_counter("checkpoint.bytes", nbytes)
        sp.set_attr("bytes", nbytes)
    return target


def _verify_leaf_digest(file: str, section: str, entry, arr) -> None:
    """A stored leaf's bytes against its manifest crc32 (absent in
    pre-digest snapshots). A mismatch raises `SnapshotIntegrityError`,
    which is not retried: re-reading the same bytes cannot help."""
    if "crc32" not in entry:
        return
    from .coordinator import SnapshotIntegrityError

    got = leaf_crc32(arr)
    if got != entry["crc32"]:
        metrics.inc_counter("checkpoint.digest.mismatch")
        raise SnapshotIntegrityError(
            f"snapshot {file}: leaf {entry['key']!r} (section {section!r}) "
            f"is corrupt — stored crc32 {entry['crc32']}, actual {got}. "
            "The snapshot cannot be trusted; restore refused."
        )


def _leaf_shape(leaf) -> Optional[tuple]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if hasattr(leaf, "shape"):
        return tuple(np.shape(leaf))
    return None


def _leaf_numpy_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return getattr(leaf, "dtype", None)


def _leaf_mismatch(template_leaves, entries) -> Optional[str]:
    """Why stored leaves cannot restore into the template (None when they
    can): the foreign-job structural guard."""
    if len(template_leaves) != len(entries):
        return f"{len(entries)} stored leaves vs {len(template_leaves)} expected"
    for i, (leaf, entry) in enumerate(zip(template_leaves, entries)):
        shape = _leaf_shape(leaf)
        if shape is not None and tuple(entry["shape"]) != shape:
            return f"leaf {i}: stored shape {entry['shape']} vs {shape}"
    return None


def restore_leaves(template, stored: Sequence[np.ndarray]):
    """Stored host leaves unflattened against `template`, each cast to its
    template leaf's dtype (host numpy)."""
    leaves, treedef = tree_flatten(template)
    restored = []
    for leaf, arr in zip(leaves, stored):
        dtype = _leaf_numpy_dtype(leaf)
        restored.append(np.asarray(arr, dtype=dtype) if dtype is not None else np.asarray(arr))
    return tree_unflatten(treedef, restored)


def load_job_snapshot(
    path: str,
    job_key: Optional[str],
    templates: Optional[Dict[str, Any]] = None,
    *,
    expect_meta: Optional[Dict[str, Any]] = None,
) -> Optional[JobSnapshot]:
    """Restore a JobSnapshot, or None when absent, structurally foreign,
    of a future format version or cursor-incompatible (`expect_meta`
    entries must match the stored meta where both are set).

    `templates` maps section names to pytrees of the expected structure
    (host arrays or tensors): templated sections come back unflattened
    with each leaf cast to its template's dtype, as host numpy
    (`stage_section` puts them on a device); untemplated sections come
    back as flat leaf lists. With no snapshot file and a `model` template,
    the legacy carry-only `ckpt-*.npz` is read (one-way migration).
    Committed sharded cuts, when present, are authoritative. Un-keyed
    restores warn."""
    from ..obs import tracing
    from . import coordinator

    if coordinator.has_sharded(path, job_key):
        with tracing.span("checkpoint.restore", jobKey=job_key or "", sharded=True) as sp:
            snap = coordinator.load_sharded(path, job_key, templates, expect_meta=expect_meta)
            if snap is None:
                return None
            if job_key is None:
                warnings.warn(_UNKEYED_WARNING)
            metrics.inc_counter("checkpoint.restore.count")
            sp.set_attr("epoch", int(snap.epoch))
            return snap

    file = snapshot_file(path, job_key)
    if not os.path.exists(file):
        return _load_legacy(path, job_key, templates)
    with tracing.span("checkpoint.restore", jobKey=job_key or "") as sp:

        def read():
            """The retried unit: open and parse the npz. A refusal returns
            None and is never retried; a transient read fault re-runs it."""
            faults.tick("snapshot.read")
            with np.load(file) as f:
                manifest = json.loads(str(f["manifest"]))
                version = int(manifest.get("version", -1))
                if version > SNAPSHOT_VERSION or version < 1:
                    warnings.warn(
                        f"ignoring job snapshot {file}: format version {version} "
                        f"(this build reads <= {SNAPSHOT_VERSION})")
                    return None
                if expect_meta:
                    stored = manifest.get("meta", {})
                    for k, v in expect_meta.items():
                        if k in stored and stored[k] != v:
                            warnings.warn(
                                f"ignoring job snapshot {file}: meta {k!r} is "
                                f"{stored[k]!r}, resuming job expects {v!r} (the "
                                "snapshot belongs to a different data layout)")
                            return None
                sections: Dict[str, Any] = {}
                specs: Dict[str, Sequence[str]] = {}
                for name, section in manifest["sections"].items():
                    entries = section["leaves"]
                    specs[name] = tuple(e.get("spec", "replicated") for e in entries)
                    stored_leaves = [np.asarray(f[e["key"]]) for e in entries]
                    for e, arr in zip(entries, stored_leaves):
                        _verify_leaf_digest(file, name, e, arr)
                    template = (templates or {}).get(name)
                    if template is None:
                        sections[name] = stored_leaves
                        continue
                    why = _leaf_mismatch(tree_flatten(template)[0], entries)
                    if why is not None:
                        warnings.warn(
                            f"ignoring job snapshot {file}: section {name!r} is "
                            f"structurally incompatible ({why}) — it belongs to a "
                            "different job")
                        return None
                    sections[name] = restore_leaves(template, stored_leaves)
            return manifest, sections, specs

        parsed = flow.with_retries(read, site="snapshot.read")
        if parsed is None:
            return None
        manifest, sections, specs = parsed
        if job_key is None:
            warnings.warn(_UNKEYED_WARNING)
        metrics.inc_counter("checkpoint.restore.count")
        sp.set_attr("epoch", int(manifest["epoch"]))
        return JobSnapshot(
            job_key=job_key,
            epoch=int(manifest["epoch"]),
            criteria=float(manifest["criteria"]),
            sections=sections,
            specs=specs,
            meta=manifest.get("meta", {}),
            version=int(manifest.get("version", -1)),
            path=file,
        )


def conform(snap: JobSnapshot, templates: Dict[str, Any],
            expect_meta: Optional[Dict[str, Any]] = None) -> Optional[JobSnapshot]:
    """A snapshot loaded without templates, put through the guards a
    templated load applies (meta cursors, structure) and with `templates`'
    sections unflattened and cast; None when refused. Saves reading a
    large snapshot twice (a stream fit's peek at its cache section, then
    its model)."""
    stored = snap.meta or {}
    for k, v in (expect_meta or {}).items():
        if k in stored and stored[k] != v:
            warnings.warn(f"ignoring job snapshot {snap.path}: meta {k!r} is {stored[k]!r}, "
                          f"resuming job expects {v!r} (the snapshot belongs to a different "
                          "data layout)")
            return None
    sections = dict(snap.sections)
    for name, template in templates.items():
        leaves = sections.get(name)
        if leaves is None:
            return None
        entries = [{"shape": list(np.shape(a))} for a in leaves]
        why = _leaf_mismatch(tree_flatten(template)[0], entries)
        if why is not None:
            warnings.warn(f"ignoring job snapshot {snap.path}: section {name!r} is structurally "
                          f"incompatible ({why}) — it belongs to a different job")
            return None
        sections[name] = restore_leaves(template, leaves)
    return JobSnapshot(snap.job_key, snap.epoch, snap.criteria, sections, snap.specs, snap.meta,
                       snap.version, snap.path)


def _load_legacy(path: str, job_key: Optional[str],
                 templates: Optional[Dict[str, Any]]) -> Optional[JobSnapshot]:
    """One-way migration: a carry-only checkpoint written by
    `parallel.iteration.save_iteration_checkpoint` as a JobSnapshot with
    one `model` section. A corrupt file raises."""
    template = (templates or {}).get("model")
    if template is None:
        return None
    from ..parallel.iteration import _checkpoint_file

    file = _checkpoint_file(path, job_key)
    if not os.path.exists(file):
        return None
    warnings.warn(
        f"legacy checkpoint {file}: the pre-JobSnapshot carry-only format "
        "records no integrity digests, so this restore CANNOT be verified "
        "against bit rot; the first save after resume migrates to the "
        "digest-carrying snapshot format"
    )
    with np.load(file) as f:
        leaves, _ = tree_flatten(template)
        if any(f"leaf_{i}" not in f for i in range(len(leaves))) or f"leaf_{len(leaves)}" in f:
            return None
        for i, leaf in enumerate(leaves):
            shape = _leaf_shape(leaf)
            if shape is not None and tuple(f[f"leaf_{i}"].shape) != shape:
                return None
        carry = restore_leaves(template, [f[f"leaf_{i}"] for i in range(len(leaves))])
        epoch, criteria = int(f["epoch"]), float(f["criteria"])
    if job_key is None:
        warnings.warn(_UNKEYED_WARNING)
    metrics.inc_counter("checkpoint.restore.count")
    return JobSnapshot(
        job_key=job_key,
        epoch=epoch,
        criteria=criteria,
        sections={"model": carry},
        specs={"model": ("replicated",) * len(leaves)},
        meta={"migratedFrom": os.path.basename(file)},
        version=0,
        path=file,
    )


def stage_section(snap: JobSnapshot, name: str, device: Optional[torch.device] = None,
                  specs: Union[None, str, Sequence[str]] = None,
                  category: Optional[str] = "optimizer"):
    """A restored section's leaves on `device` (default `config.device()`),
    in one accounted upload (`parallel.prefetch.stage_to_device`); leaves
    tagged `host` stay numpy. `specs` overrides the stored tags. On one
    card every other tag means the one device: the tags are kept for the
    multi-card layout (ROADMAP A.10). `category` ledgers the restored
    residency (obs/memledger.py)."""
    from .. import config

    leaves, treedef = tree_flatten(snap.sections[name])
    tags = _normalize_specs(specs if specs is not None else snap.specs.get(name),
                            len(leaves), name)
    device = device if device is not None else config.device()
    upload = [i for i, tag in enumerate(tags) if tag != "host"]
    staged = list(leaves)
    for i, t in zip(upload, stage_leaves([leaves[i] for i in upload], device, category)):
        staged[i] = t
    return tree_unflatten(treedef, staged)


def stage_leaves(arrays: Sequence[np.ndarray], device: torch.device,
                 category: Optional[str] = "optimizer") -> List[torch.Tensor]:
    """Host arrays as tensors on `device`, every dtype kept, in one
    accounted copy (`parallel.prefetch.stage_to_device`)."""
    from ..parallel.prefetch import stage_to_device

    if not arrays:
        return []
    host = [np.asarray(a) for a in arrays]
    # the stager copies rows: a 0-d leaf goes as one row
    on_device = stage_to_device(tuple(a.reshape(-1) if a.ndim == 0 else a for a in host),
                                device, category=category).wait()
    return [t.reshape(a.shape) for a, t in zip(host, on_device)]
