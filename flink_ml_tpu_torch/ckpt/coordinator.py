"""Sharded JobSnapshot cuts: per-host shard writes and a committed manifest.

Port of flink_ml_tpu/ckpt/coordinator.py, the same files and manifest, so
a cut written by one package restores in the other. The hosts are the
simulated hosts of `config.snapshot_hosts`: on one card they are a
partition of each leaf, not of devices.

Protocol (two-phase commit, one *cut* per snapshot):

1. **Per-host shard writes.** Each host writes only its own slice of each
   leaf, `snap-<key>.c<cut>.host<i>.npz`, chosen by the leaf's spec tag
   (`data`: leading axis, `model`: trailing axis, `replicated`/`host`:
   the whole array, owned by host 0; `shard_axis_for_tag`). Each shard
   write is the atomic temp + `os.replace` unit (`atomic_commit`, fault
   site `snapshot.shard.write` between the two), retried under
   `flow.with_retries` within `config.snapshot_host_deadline_s`; a host
   that cannot land its shard aborts the cut: the cut's files are
   deleted, `SnapshotAborted` is raised, the previous committed cut stays
   restorable (`checkpoint.abort`).
2. **Manifest commit.** `snap-<key>.c<cut>.manifest.json` (temp +
   `os.replace`, fault site `snapshot.commit` between) records the
   format version, host count, leaf inventory, the leaf-to-shard layout
   and each shard's crc32 and sha256. The manifest's rename is the commit
   point: a kill before it leaves only shard files of an uncommitted cut,
   which the next commit's GC or `sweep_uncommitted` removes.

Restore walks committed cuts newest first: a cut whose shard is missing
or whose digests disagree is refused with a warning (never retried, never
partly applied) and the next older cut is tried
(`checkpoint.restore.fallback`, `checkpoint.digest.mismatch`); when cuts
exist and none validates, `SnapshotIntegrityError` is raised. Leaves are
stitched back to full host arrays, so a cut written by N hosts restores
with any host count.

Retention: each commit keeps the newest `config.snapshot_retained` cuts
and deletes older ones, shards of torn or aborted cuts, stale temps and
stable shards no kept manifest names (`checkpoint.gc`). Stable sections
(the stream cache's contents) are written once per job key as
`snap-<key>.stable-<section>.host<i>.npz` and named by later manifests.

Transient read faults retry (`snapshot.manifest.read`,
`snapshot.shard.read`); refusals are decisions and never retry.

Rank cuts (`save_rank_cut`): on a mesh of ranks the hosts are the ranks.
Rank 0 picks the cut id and broadcasts it; each rank writes one shard file
(`...c<cut>.host<rank>.npz`) with the parts it owns (a `model`-tagged
leaf's slice from the ranks of data index 0, a `data`-tagged leaf's
leading block from the ranks of model index 0, whole leaves from rank 0);
the ranks gather their digests and layout parts, and rank 0 commits the
manifest, which every rank waits for. The format is the one above, so a
rank cut restores with any rank count or factorization, and through the
JAX package's loader. A rank cut records no whole-leaf crc32: no rank
holds a sharded leaf's bytes (each shard's crc32 and sha256 prove its
file, and the layout's coverage check proves the reassembly is whole).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import flow
from ..utils import metrics
from . import faults

__all__ = [
    "SHARDED_FORMAT_VERSION",
    "SnapshotAborted",
    "SnapshotIntegrityError",
    "atomic_commit",
    "manifest_file",
    "shard_file",
    "stable_shard_file",
    "committed_cuts",
    "has_sharded",
    "save_sharded",
    "load_sharded",
    "gc_snapshots",
    "sweep_uncommitted",
    "purge",
    "shard_axis_for_tag",
    "host_slice_bounds",
    "save_rank_cut",
]

#: meta keys that move from cut to cut of one job: not part of the
#: same-job guard of a stable section's reuse
CURSOR_META = ("cacheCursor", "streamOffset")

#: version of the sharded manifest CONTAINER (the per-leaf payload format
#: rides `snapshot.SNAPSHOT_VERSION` unchanged)
SHARDED_FORMAT_VERSION = 1


class SnapshotAborted(RuntimeError):
    """This cut was abandoned (straggler host exceeded the write
    deadline / retry budget). The cut's partial files are already
    cleaned; the previous committed snapshot is still restorable, so the
    caller may keep training and try again at the next boundary."""


class SnapshotIntegrityError(RuntimeError):
    """A checkpoint that exists but cannot be trusted: a digest mismatch
    on the only restorable state, or a single-file leaf whose stored
    crc32 disagrees with its bytes. Deliberately NOT a
    `flow.TransientError`: verification failure is a decision, and a
    retry would re-read the same corrupt bytes."""


# ---------------------------------------------------------------------------
# shard ownership (flink_ml_tpu/parallel/mesh.py's rule, no mesh needed)
# ---------------------------------------------------------------------------

def shard_axis_for_tag(tag: str, ndim: int) -> Optional[int]:
    """The axis a spec tag splits across hosts, or None for whole-array
    tags (`replicated` / `host`) and scalars: `data` the leading axis,
    `model` the trailing one."""
    if ndim <= 0:
        return None
    if tag == "data":
        return 0
    if tag == "model":
        return ndim - 1
    return None


def host_slice_bounds(length: int, num_hosts: int):
    """Per-host [start, stop) bounds splitting `length` over `num_hosts`
    (np.array_split's: uneven allowed, empty trailing slices when hosts
    outnumber elements)."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    base, extra = divmod(int(length), int(num_hosts))
    bounds = []
    start = 0
    for h in range(num_hosts):
        stop = start + base + (1 if h < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


# ---------------------------------------------------------------------------
# file naming
# ---------------------------------------------------------------------------

def _base(job_key: Optional[str]) -> str:
    if job_key is None:
        return "snap"
    return "snap-" + re.sub(r"[^A-Za-z0-9._-]", "_", job_key)


def manifest_file(path: str, job_key: Optional[str], cut: int) -> str:
    return os.path.join(path, f"{_base(job_key)}.c{int(cut):06d}.manifest.json")


def shard_file(path: str, job_key: Optional[str], cut: int, host: int) -> str:
    return os.path.join(path, f"{_base(job_key)}.c{int(cut):06d}.host{int(host)}.npz")


def stable_shard_file(
    path: str, job_key: Optional[str], section: str, host: int
) -> str:
    return os.path.join(
        path, f"{_base(job_key)}.stable-{section}.host{int(host)}.npz"
    )


def _cut_of(name: str, base: str) -> Optional[int]:
    m = re.match(re.escape(base) + r"\.c(\d+)\.", name)
    return int(m.group(1)) if m else None


def committed_cuts(path: str, job_key: Optional[str]) -> List[int]:
    """Cut ids with a COMMITTED manifest, ascending."""
    base = _base(job_key)
    cuts = []
    if not os.path.isdir(path):
        return cuts
    for name in os.listdir(path):
        cut = _cut_of(name, base)
        if cut is not None and name.endswith(".manifest.json"):
            cuts.append(cut)
    return sorted(cuts)


def has_sharded(path: str, job_key: Optional[str]) -> bool:
    """Does this (path, key) hold ANY committed sharded manifest? When it
    does, the sharded state is authoritative and the loader must not fall
    through to a stale single-file/legacy snapshot on a refusal."""
    return bool(committed_cuts(path, job_key))


def _next_cut(path: str, job_key: Optional[str]) -> int:
    """One past the highest cut id ANY file (manifest, shard, temp)
    claims — torn/aborted cuts burn their id, so a retried commit never
    collides with a dead cut's leftovers."""
    base = _base(job_key)
    highest = 0
    if os.path.isdir(path):
        for name in os.listdir(path):
            cut = _cut_of(name, base)
            if cut is not None:
                highest = max(highest, cut)
    return highest + 1


# ---------------------------------------------------------------------------
# THE commit primitive (the one sanctioned multi-file write sequence)
# ---------------------------------------------------------------------------

def atomic_commit(
    target: str,
    write_payload: Callable[[str], None],
    *,
    site: str,
    retries: Optional[int] = None,
    deadline_s: Optional[float] = None,
) -> None:
    """Write `target` atomically: `write_payload(tmp)` fills a temp file
    in the same directory, the `site` fault tick models a kill between
    payload and commit, and `os.replace` publishes — a reader never
    observes a torn file. The WHOLE unit retries under
    `flow.with_retries` (transient faults re-run payload+rename; nothing
    before the rename is observable, so the retry is safe), bounded by
    `retries`/`deadline_s` when given."""
    root, ext = os.path.splitext(target)
    tmp = f"{root}.tmp{ext}"  # keep the suffix so np.savez won't rename

    def unit() -> None:
        write_payload(tmp)
        # torn-write injection point: a kill here models a crash after
        # the temp payload hit disk but before the atomic commit below
        faults.tick(site)
        os.replace(tmp, target)

    flow.with_retries(unit, site=site, retries=retries, deadline_s=deadline_s)


def _read_file_bytes(path: str, site: str) -> bytes:
    """The retried read unit for manifest/shard files: transient faults
    (flaky filesystems, `faults.flaky` plans) re-run the whole read;
    whatever the caller DECIDES about the bytes (digests, versions,
    guards) happens outside and is never retried."""

    def read() -> bytes:
        faults.tick(site)
        with open(path, "rb") as f:
            return f.read()

    return flow.with_retries(read, site=site)


def _digests(data: bytes) -> Dict[str, Any]:
    return {
        "bytes": len(data),
        "crc32": zlib.crc32(data) & 0xFFFFFFFF,
        "sha256": hashlib.sha256(data).hexdigest(),
    }


def _remove_quiet(path: str) -> bool:
    """Idempotent delete for the cleanup paths (abort sweep, GC,
    uncommitted-cut sweep): these can legally race each other — a
    straggler abort racing commit-time retention GC — and losing the
    race to delete a file someone else already deleted is success, not
    an error."""
    try:
        os.remove(path)
        return True
    except FileNotFoundError:
        return False


# ---------------------------------------------------------------------------
# save: per-host shard writes + manifest commit
# ---------------------------------------------------------------------------

def _split_leaf(
    arrays: Dict[str, np.ndarray],
    key: str,
    tag: str,
    hosts: int,
    host_payloads: List[Dict[str, np.ndarray]],
    files: List[str],
) -> List[Dict[str, Any]]:
    """Assign leaf `key`'s per-host slices into `host_payloads`; returns
    the leaf's layout parts (shard basename + axis + [start, stop))."""
    arr = arrays[key]
    axis = shard_axis_for_tag(tag, arr.ndim)
    if axis is None:
        # whole-array leaf (replicated / host / scalar): host 0 owns it
        host_payloads[0][key] = np.asarray(arr)
        return [{"shard": os.path.basename(files[0]), "axis": None}]
    parts = []
    for h, (start, stop) in enumerate(
        host_slice_bounds(arr.shape[axis], hosts)
    ):
        if start == stop:
            continue  # more hosts than rows: this host owns nothing here
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(start, stop)
        host_payloads[h][key] = np.ascontiguousarray(arr[tuple(idx)])
        parts.append(
            {
                "shard": os.path.basename(files[h]),
                "axis": int(axis),
                "start": int(start),
                "stop": int(stop),
            }
        )
    return parts


def _write_host_shards(
    files: List[str],
    host_payloads: List[Dict[str, np.ndarray]],
    *,
    deadline_s: Optional[float],
    written: Optional[List[str]] = None,
) -> Dict[str, Dict[str, Any]]:
    """Phase 1: every host commits its own shard file (the per-host
    `snapshot.shard.write` kill site lives inside each commit), then the
    coordinator digests the landed bytes. A straggler host — transient
    retries/deadline exhausted — aborts the cut. Each landed target is
    appended to `written` BEFORE the next host starts, so a failure
    mid-loop can sweep exactly the files this cut put on disk. Under a
    supervised fit each host's write is also a `commit` host-health
    boundary (parallel/supervisor.py) — the mid-commit chaos axis."""
    from ..parallel import supervisor

    shards: Dict[str, Dict[str, Any]] = {}
    for h, file in enumerate(files):
        supervisor.pulse_boundary(supervisor.PHASE_COMMIT)
        payload = host_payloads[h]
        try:
            atomic_commit(
                file,
                lambda tmp, p=payload: np.savez(tmp, **p),
                site="snapshot.shard.write",
                deadline_s=deadline_s,
            )
        except flow.TransientError as e:
            raise SnapshotAborted(
                f"host {h} could not land shard {os.path.basename(file)} "
                f"within its retry budget/deadline "
                f"(attempts={getattr(e, 'retry_attempts', '?')}): {e}"
            ) from e
        if written is not None:
            written.append(file)
        data = _read_file_bytes(file, "snapshot.shard.read")
        info = _digests(data)
        info["host"] = h
        shards[os.path.basename(file)] = info
        metrics.inc_counter("checkpoint.shard.count")
        metrics.inc_counter("checkpoint.shard.bytes", info["bytes"])
    return shards


def _newest_committed_manifest(
    path: str, job_key: Optional[str]
) -> Optional[Dict[str, Any]]:
    """Best-effort read of the newest committed manifest (for stable-
    section reuse); None when absent or unreadable — reuse is an
    optimization, never a correctness dependency."""
    cuts = committed_cuts(path, job_key)
    for cut in reversed(cuts):
        try:
            with open(manifest_file(path, job_key, cut), "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            continue
    return None


def _reusable_stable(
    prev: Optional[Dict[str, Any]], name: str, path: str, meta: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """The previous manifest's (entries, layout, shards) rows for stable
    section `name`, when every referenced file still exists and the two
    cuts' metas agree on every shared key but the cursors (the same-job
    guard: a job key reused with a different data layout must rewrite,
    not alias). The cursors (`CURSOR_META`) move at every cut of one fit;
    the JAX package compares them too, so it rewrites a stream's cache
    section at every cut (ROADMAP C.22)."""
    if prev is None or name not in prev.get("sections", {}):
        return None
    prev_meta = prev.get("meta", {})
    for k, v in meta.items():
        if k not in CURSOR_META and k in prev_meta and prev_meta[k] != v:
            return None
    entries = prev["sections"][name]["leaves"]
    layout = {}
    shards = {}
    for entry in entries:
        parts = prev.get("layout", {}).get(entry["key"])
        if parts is None:
            return None
        for part in parts:
            base = part["shard"]
            info = prev.get("shards", {}).get(base)
            if info is None or not os.path.exists(os.path.join(path, base)):
                return None
            shards[base] = info
        layout[entry["key"]] = parts
    return {"entries": entries, "layout": layout, "shards": shards}


def save_sharded(
    path: str,
    job_key: Optional[str],
    arrays: Dict[str, np.ndarray],
    manifest_sections: Dict[str, Any],
    *,
    epoch: int,
    criteria: float,
    meta: Optional[Dict[str, Any]],
    hosts: int,
    stable_sections: Optional[
        Dict[str, Callable[[], Sequence[np.ndarray]]]
    ] = None,
    stable_specs: Optional[Dict[str, str]] = None,
    snapshot_version: int = 1,
) -> str:
    """Commit one snapshot cut: per-host shard writes, then the atomic
    manifest (see the module docstring for the protocol). `arrays` +
    `manifest_sections` are the gathered host leaves and their inventory
    (the same shapes `snapshot.save_job_snapshot` builds); returns the
    committed manifest path. Raises `SnapshotAborted` (cut files already
    cleaned) on a straggler host."""
    from .. import config

    os.makedirs(path, exist_ok=True)
    meta = meta or {}
    hosts = max(1, int(hosts))
    cut = _next_cut(path, job_key)
    files = [shard_file(path, job_key, cut, h) for h in range(hosts)]

    # phase 0: slice every leaf into its owners' payloads
    host_payloads: List[Dict[str, np.ndarray]] = [dict() for _ in range(hosts)]
    layout: Dict[str, List[Dict[str, Any]]] = {}
    for name, section in manifest_sections.items():
        for entry in section["leaves"]:
            layout[entry["key"]] = _split_leaf(
                arrays, entry["key"], entry["spec"], hosts, host_payloads, files
            )

    written: List[str] = []  # every target THIS call committed (sweep set)
    cut_files = list(files)  # candidates whose temps must also be swept
    try:
        # phase 1: per-host shard commits (+ digests of the landed bytes)
        shards = _write_host_shards(
            files,
            host_payloads,
            deadline_s=config.snapshot_host_deadline_s,
            written=written,
        )

        # stable sections: written once per job key, reused by reference
        prev = (
            _newest_committed_manifest(path, job_key) if stable_sections else None
        )
        for name, provider in (stable_sections or {}).items():
            tag = (stable_specs or {}).get(name, "data")
            reused = _reusable_stable(prev, name, path, meta)
            if reused is not None:
                manifest_sections[name] = {"leaves": reused["entries"]}
                layout.update(reused["layout"])
                shards.update(reused["shards"])
                metrics.inc_counter("checkpoint.stable.reused")
                continue
            leaves = [np.asarray(leaf) for leaf in provider()]
            sfiles = [
                stable_shard_file(path, job_key, name, h) for h in range(hosts)
            ]
            spayloads: List[Dict[str, np.ndarray]] = [dict() for _ in range(hosts)]
            entries = []
            sarrays = {}
            for i, leaf in enumerate(leaves):
                key = f"s_{name}_{i}"
                sarrays[key] = leaf
                entries.append(
                    {
                        "key": key,
                        "spec": tag,
                        "dtype": str(leaf.dtype),
                        "shape": list(leaf.shape),
                        "crc32": zlib.crc32(
                            np.ascontiguousarray(leaf).tobytes()
                        )
                        & 0xFFFFFFFF,
                    }
                )
                layout[key] = _split_leaf(
                    sarrays, key, tag, hosts, spayloads, sfiles
                )
            manifest_sections[name] = {"leaves": entries}
            cut_files.extend(sfiles)
            shards.update(
                _write_host_shards(
                    sfiles,
                    spayloads,
                    deadline_s=config.snapshot_host_deadline_s,
                    written=written,
                )
            )
            for base in (os.path.basename(f) for f in sfiles):
                shards[base]["stable"] = True
    except BaseException as e:
        # abort-this-cut: remove everything this cut managed to land —
        # on the planned straggler abort AND on any unexpected exception
        # mid-cut (an injected kill, a supervisor abort): partial shard
        # files must never wait for the next commit's GC. Only files
        # carrying THIS cut's id (plus temps) are ours to delete: a
        # stable TARGET this save (re)wrote lives at a cut-less shared
        # path that committed manifests reference — its atomic overwrite
        # carries the same immutable bytes, so it must survive the sweep
        # (only its temp is swept). The previous committed snapshot is
        # untouched and restorable either way.
        base = _base(job_key)
        for victim in set(written) | {_tmp_of(f) for f in cut_files}:
            name = os.path.basename(victim)
            if _cut_of(name, base) is None and ".tmp" not in name:
                continue
            _remove_quiet(victim)
        metrics.inc_counter(
            "checkpoint.abort"
            if isinstance(e, SnapshotAborted)
            else "checkpoint.sweep"
        )
        raise

    # phase 2: the manifest commit — the cut's single atomic publish
    # point. The supervised boundary sits right before it: a host that
    # dies/hangs HERE leaves the torn-2PC shape (shards landed, manifest
    # never renamed) that `sweep_uncommitted` cancels on recovery.
    from ..parallel import supervisor

    supervisor.pulse_boundary(supervisor.PHASE_COMMIT)
    manifest = {
        "formatVersion": SHARDED_FORMAT_VERSION,
        "version": int(snapshot_version),
        "jobKey": job_key,
        "cut": cut,
        "epoch": int(epoch),
        "criteria": float(criteria),
        "hosts": hosts,
        "sections": manifest_sections,
        "layout": layout,
        "shards": shards,
        "meta": meta,
    }
    target = manifest_file(path, job_key, cut)
    atomic_commit(
        target,
        lambda tmp: _dump_json(tmp, manifest),
        site="snapshot.commit",
    )
    metrics.inc_counter("checkpoint.manifest.count")
    gc_snapshots(path, job_key)
    return target


def _rank_part(local: np.ndarray, tag: str, mesh, whole_shape) -> Optional[tuple]:
    """(array, axis, start, stop) of the part of a leaf this rank writes,
    or None: the slice of a `model` leaf on a rank of data index 0, the
    leading block of a `data` leaf on a rank of model index 0, a whole leaf
    on rank 0 (axis None)."""
    from ..parallel import mesh as mesh_lib

    axis = shard_axis_for_tag(tag, local.ndim)
    if axis is None:
        return (local, None, 0, 0) if mesh.rank == 0 else None
    other = mesh_lib.DATA_AXIS if tag == "model" else mesh_lib.MODEL_AXIS
    own = mesh_lib.MODEL_AXIS if tag == "model" else mesh_lib.DATA_AXIS
    if mesh.axis_index(other) != 0:
        return None
    block = local.shape[axis]
    start = mesh.axis_index(own) * block
    stop = min(start + block, int(whole_shape[axis]))
    if stop <= start:
        return None
    idx = [slice(None)] * local.ndim
    idx[axis] = slice(0, stop - start)
    return np.ascontiguousarray(local[tuple(idx)]), axis, start, stop


def save_rank_cut(
    path: str,
    job_key: Optional[str],
    arrays: Dict[str, np.ndarray],
    manifest_sections: Dict[str, Any],
    *,
    mesh,
    shapes: Dict[str, Sequence[tuple]],
    epoch: int,
    criteria: float,
    meta: Optional[Dict[str, Any]],
    snapshot_version: int = 1,
) -> str:
    """Commit one cut written by every rank of `mesh` (module docstring):
    `arrays` are this rank's local leaves, `shapes` the whole shapes of a
    section's leaves (default: a sharded leaf's local shape times its
    axis). Every rank of the mesh calls it; returns the committed manifest
    path on every rank. A rank whose shard cannot land aborts the cut on
    every rank (`SnapshotAborted`, the cut's files removed)."""
    import torch.distributed as dist

    from .. import config
    from ..parallel import mesh as mesh_lib
    from ..parallel import supervisor

    group, rank = mesh.group, mesh.rank
    root = mesh_lib._group_to_global(group, 0)
    os.makedirs(path, exist_ok=True)
    box = [_next_cut(path, job_key) if rank == 0 else None]
    dist.broadcast_object_list(box, src=root, group=group)
    cut = int(box[0])
    file = shard_file(path, job_key, cut, rank)
    payload: Dict[str, np.ndarray] = {}
    parts: Dict[str, Dict[str, Any]] = {}
    for name, section in manifest_sections.items():
        whole_shapes = shapes.get(name)
        for i, entry in enumerate(section["leaves"]):
            key, tag, local = entry["key"], entry["spec"], arrays[entry["key"]]
            axis = shard_axis_for_tag(tag, local.ndim)
            if whole_shapes is not None:
                whole = tuple(int(x) for x in whole_shapes[i])
            else:
                whole = list(local.shape)
                if axis is not None:
                    n = mesh.shape.get(mesh_lib.MODEL_AXIS if tag == "model"
                                       else mesh_lib.DATA_AXIS, 1)
                    whole[axis] *= n
                whole = tuple(whole)
            entry["shape"] = list(whole)
            entry.pop("crc32", None)
            part = _rank_part(local, tag, mesh, whole)
            if part is None:
                continue
            payload[key], axis, start, stop = part
            parts[key] = {"shard": os.path.basename(file), "axis": axis}
            if axis is not None:
                parts[key].update(start=int(start), stop=int(stop))
    written: List[str] = []
    error = None
    infos: Dict[str, Dict[str, Any]] = {}
    try:
        infos = _write_host_shards([file], [payload], deadline_s=config.snapshot_host_deadline_s,
                                   written=written)
        for info in infos.values():
            info["host"] = rank
    except SnapshotAborted as e:
        error = f"rank {rank}: {e}"
    gathered: List[Any] = [None] * mesh.size
    dist.all_gather_object(gathered, (error, infos, parts), group=group)
    errors = [g[0] for g in gathered if g[0] is not None]
    if errors:
        for victim in written + [_tmp_of(file)]:
            _remove_quiet(victim)
        metrics.inc_counter("checkpoint.abort")
        raise SnapshotAborted("; ".join(errors))
    # rank 0 commits; every rank then reaches the one outcome broadcast, and
    # rank 0 re-raises a commit failure only after it
    outcome: List[Any] = [None]
    failure: Optional[BaseException] = None
    if rank == 0:
        layout: Dict[str, List[Dict[str, Any]]] = {}
        shards: Dict[str, Dict[str, Any]] = {}
        for _, rank_infos, rank_parts in gathered:
            shards.update(rank_infos)
            for key, part in rank_parts.items():
                layout.setdefault(key, []).append(part)
        for key in layout:
            layout[key].sort(key=lambda p: p.get("start", 0))
        manifest = {
            "formatVersion": SHARDED_FORMAT_VERSION,
            "version": int(snapshot_version),
            "jobKey": job_key,
            "cut": cut,
            "epoch": int(epoch),
            "criteria": float(criteria),
            "hosts": mesh.size,
            "sections": manifest_sections,
            "layout": layout,
            "shards": shards,
            "meta": meta or {},
        }
        target = manifest_file(path, job_key, cut)
        try:
            supervisor.pulse_boundary(supervisor.PHASE_COMMIT)
            atomic_commit(target, lambda tmp: _dump_json(tmp, manifest), site="snapshot.commit")
            metrics.inc_counter("checkpoint.manifest.count")
            gc_snapshots(path, job_key)
            outcome = [("ok", target)]
        except BaseException as e:
            outcome = [("error", f"{type(e).__name__}: {e}")]
            failure = e
    dist.broadcast_object_list(outcome, src=root, group=group)
    if failure is not None:
        raise failure
    status, value = outcome[0]
    if status != "ok":
        raise RuntimeError(f"rank 0 could not commit snapshot cut {cut}: {value}")
    return value


def _tmp_of(target: str) -> str:
    root, ext = os.path.splitext(target)
    return f"{root}.tmp{ext}"


def _dump_json(tmp: str, manifest: Dict[str, Any]) -> None:
    with open(tmp, "w") as f:
        json.dump(manifest, f)


# ---------------------------------------------------------------------------
# retention GC (on commit)
# ---------------------------------------------------------------------------

def gc_snapshots(
    path: str, job_key: Optional[str], retained: Optional[int] = None
) -> int:
    """Keep the newest `retained` (default `config.snapshot_retained`)
    committed cuts; delete older manifests+shards, orphaned shard files
    from torn/aborted cuts, stale temps, and stable shards no retained
    manifest references. Returns the number of files removed
    (`checkpoint.gc`)."""
    from .. import config

    if retained is None:
        retained = config.snapshot_retained
    retained = max(1, int(retained))
    cuts = committed_cuts(path, job_key)
    if not cuts:
        return 0
    keep = set(cuts[-retained:])
    newest = cuts[-1]

    # stable files referenced by ANY retained manifest survive
    referenced = set()
    for cut in keep:
        try:
            with open(manifest_file(path, job_key, cut), "r") as f:
                referenced.update(json.load(f).get("shards", {}).keys())
        except (OSError, ValueError):
            continue  # unreadable retained manifest: restore will refuse it
    base = _base(job_key)
    stable_re = re.compile(re.escape(base) + r"\.stable-[^.]+\.host\d+\.npz$")
    removed = 0
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        cut = _cut_of(name, base)
        if cut is not None:
            # stale temp of a finished cut, or any file of an unretained /
            # uncommitted-and-superseded cut
            dead = (".tmp" in name and cut <= newest) or (
                cut not in keep and cut < newest
            )
            if dead and name not in referenced:
                removed += _remove_quiet(full)
        elif stable_re.match(name) and name not in referenced:
            removed += _remove_quiet(full)
        elif name.startswith(base + ".stable-") and ".tmp" in name:
            removed += _remove_quiet(full)
    if removed:
        metrics.inc_counter("checkpoint.gc", removed)
    return removed


def sweep_uncommitted(path: str, job_key: Optional[str]) -> int:
    """Cancel the in-flight cut: delete every file of cuts NEWER than the
    newest committed manifest, plus stale temps — the elastic
    supervisor's abort path (`SnapshotAborted` semantics without the
    exception: whatever the aborted attempt landed is removed and the
    previous committed cut stays the restore target). Committed cuts and
    stable shards referenced by manifests are never touched. Returns the
    number of files removed (`checkpoint.sweep`)."""
    if not os.path.isdir(path):
        return 0
    base = _base(job_key)
    cuts = committed_cuts(path, job_key)
    newest = cuts[-1] if cuts else 0
    removed = 0
    for name in sorted(os.listdir(path)):
        cut = _cut_of(name, base)
        dead = cut is not None and (cut > newest or ".tmp" in name)
        if dead or (name.startswith(base + ".stable-") and ".tmp" in name):
            removed += _remove_quiet(os.path.join(path, name))
    if removed:
        metrics.inc_counter("checkpoint.sweep", removed)
    return removed


def purge(path: str, job_key: Optional[str]) -> int:
    """Delete EVERY sharded-snapshot file of this job key — manifests,
    cut shards, stable shards, temps. The completed-job cleanup twin of
    `iterate_unbounded`'s single-file removal: a finished stream's
    snapshot must not make a NEW job resume from (and skip past) a
    finished run. Returns the number of files removed."""
    if not os.path.isdir(path):
        return 0
    base = _base(job_key)
    removed = 0
    for name in sorted(os.listdir(path)):
        if _cut_of(name, base) is not None or name.startswith(base + ".stable-"):
            removed += _remove_quiet(os.path.join(path, name))
    return removed


# ---------------------------------------------------------------------------
# restore: newest committed cut that validates, else fall back
# ---------------------------------------------------------------------------

class _CutInvalid(RuntimeError):
    """This cut is refused (partial commit / digest mismatch / future
    format); restore falls back to the next older committed cut."""


def _read_manifest(path: str, job_key: Optional[str], cut: int) -> Dict[str, Any]:
    data = _read_file_bytes(
        manifest_file(path, job_key, cut), "snapshot.manifest.read"
    )
    try:
        return json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise _CutInvalid(f"manifest unparseable: {e}") from e


def _validated_blobs(path: str, manifest: Dict[str, Any]) -> Dict[str, Any]:
    """Read + digest-verify every shard the manifest references; returns
    basename -> opened npz. Refusal (missing file, digest mismatch) is a
    decision — raised as `_CutInvalid`, never retried."""
    blobs: Dict[str, Any] = {}
    for base, info in manifest.get("shards", {}).items():
        file = os.path.join(path, base)
        if not os.path.exists(file):
            raise _CutInvalid(f"shard {base} missing (partial/torn commit)")
        data = _read_file_bytes(file, "snapshot.shard.read")
        got = _digests(data)
        for field in ("crc32", "sha256", "bytes"):
            if field in info and info[field] != got[field]:
                metrics.inc_counter("checkpoint.digest.mismatch")
                raise _CutInvalid(
                    f"shard {base} {field} mismatch: manifest records "
                    f"{info[field]!r}, file has {got[field]!r} (bit rot or "
                    "tampering — refusing this cut)"
                )
        blobs[base] = np.load(io.BytesIO(data))
    return blobs


def _stitch_leaf(entry: Dict[str, Any], parts, blobs) -> np.ndarray:
    """Reassemble one FULL host array from its per-shard slices."""
    shape = tuple(entry["shape"])
    dtype = np.dtype(entry["dtype"])
    whole = [p for p in parts if p.get("axis") is None]
    if whole:
        arr = np.asarray(blobs[whole[0]["shard"]][entry["key"]], dtype=dtype)
    else:
        arr = np.empty(shape, dtype=dtype)
        covered = 0
        for part in parts:
            piece = blobs[part["shard"]][entry["key"]]
            idx = [slice(None)] * len(shape)
            idx[part["axis"]] = slice(part["start"], part["stop"])
            arr[tuple(idx)] = piece
            covered += part["stop"] - part["start"]
        axis = parts[0]["axis"] if parts else 0
        if not parts or covered != shape[axis]:
            raise _CutInvalid(
                f"leaf {entry['key']}: layout covers {covered} of "
                f"{shape[axis] if parts else '?'} along axis {axis} — the "
                "manifest's leaf→shard layout is incomplete"
            )
    # whole-leaf digest over the STITCHED bytes: per-shard digests prove
    # each file, this proves the re-assembly (layout bugs, overlapping or
    # misordered slices) — the elastic N→M restore's end-to-end check
    if "crc32" in entry:
        got = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
        if got != entry["crc32"]:
            metrics.inc_counter("checkpoint.digest.mismatch")
            raise _CutInvalid(
                f"leaf {entry['key']}: stitched crc32 {got} does not match "
                f"the recorded whole-leaf digest {entry['crc32']} — the "
                "leaf→shard layout re-assembled wrong bytes"
            )
    return arr


def load_sharded(
    path: str,
    job_key: Optional[str],
    templates: Optional[Dict[str, Any]] = None,
    *,
    expect_meta: Optional[Dict[str, Any]] = None,
):
    """Restore the newest committed cut that validates (see the module
    docstring). Returns a `snapshot.JobSnapshot`, or None when no
    committed cut exists OR the snapshot is refused by the same-job
    guards (meta cursors, structure) — and raises
    `SnapshotIntegrityError` when cuts exist but every one is torn or
    corrupt."""
    from .snapshot import JobSnapshot, _leaf_mismatch, restore_leaves, tree_flatten

    cuts = committed_cuts(path, job_key)
    if not cuts:
        return None
    invalid: List[str] = []
    for cut in reversed(cuts):
        try:
            manifest = _read_manifest(path, job_key, cut)
            fmt = int(manifest.get("formatVersion", -1))
            if fmt > SHARDED_FORMAT_VERSION or fmt < 1:
                raise _CutInvalid(
                    f"manifest format version {fmt} (this build reads <= "
                    f"{SHARDED_FORMAT_VERSION})"
                )
            from .snapshot import SNAPSHOT_VERSION

            version = int(manifest.get("version", -1))
            if version > SNAPSHOT_VERSION or version < 1:
                raise _CutInvalid(
                    f"leaf format version {version} (this build reads <= "
                    f"{SNAPSHOT_VERSION})"
                )
        except _CutInvalid as e:
            warnings.warn(f"refusing snapshot cut {cut} at {path}: {e}")
            invalid.append(f"cut {cut}: {e}")
            metrics.inc_counter("checkpoint.restore.fallback")
            continue

        # same-job guards: a refusal here applies to the JOB, not the cut
        # — older cuts of the same key share the layout, so falling back
        # would just re-refuse; mirror the single-file loader and bail
        if expect_meta:
            stored = manifest.get("meta", {})
            mismatched = [
                k
                for k, v in expect_meta.items()
                if k in stored and stored[k] != v
            ]
            if mismatched:
                k = mismatched[0]
                warnings.warn(
                    f"ignoring sharded snapshot cut {cut} at {path}: meta "
                    f"{k!r} is {stored[k]!r}, resuming job expects "
                    f"{expect_meta[k]!r} (the snapshot belongs to a "
                    "different data layout)"
                )
                return None
        structural = None
        for name, section in manifest.get("sections", {}).items():
            template = (templates or {}).get(name)
            if template is None:
                continue
            structural = _leaf_mismatch(tree_flatten(template)[0], section["leaves"])
            if structural is not None:
                warnings.warn(
                    f"ignoring sharded snapshot cut {cut} at {path}: section "
                    f"{name!r} is structurally incompatible ({structural}) — "
                    "it belongs to a different job"
                )
                return None

        try:
            blobs = _validated_blobs(path, manifest)
            sections: Dict[str, Any] = {}
            specs: Dict[str, Sequence[str]] = {}
            for name, section in manifest["sections"].items():
                entries = section["leaves"]
                specs[name] = tuple(
                    e.get("spec", "replicated") for e in entries
                )
                stitched = [
                    _stitch_leaf(e, manifest["layout"][e["key"]], blobs)
                    for e in entries
                ]
                template = (templates or {}).get(name)
                if template is None:
                    sections[name] = stitched
                    continue
                sections[name] = restore_leaves(template, stitched)
        except _CutInvalid as e:
            warnings.warn(f"refusing snapshot cut {cut} at {path}: {e}")
            invalid.append(f"cut {cut}: {e}")
            metrics.inc_counter("checkpoint.restore.fallback")
            continue

        return JobSnapshot(
            job_key=job_key,
            epoch=int(manifest["epoch"]),
            criteria=float(manifest["criteria"]),
            sections=sections,
            specs=specs,
            meta=manifest.get("meta", {}),
            version=int(manifest.get("version", -1)),
            path=manifest_file(path, job_key, cut),
        )

    raise SnapshotIntegrityError(
        f"no committed snapshot cut at {path} (job key {job_key!r}) "
        "validates — a directory that claims checkpoints but cannot "
        "produce one is an operator error, not a fresh start: "
        + "; ".join(invalid)
    )
