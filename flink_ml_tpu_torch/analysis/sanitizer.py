"""The runtime concurrency sanitizer: the dynamic twin of the static rules.

Port of flink_ml_tpu/analysis/sanitizer.py, on the port's `flow` and
`obs.tracing`. `enable()` (automatic when `FLINK_ML_TPU_SANITIZE=1` is
set before the package is imported) turns a process into a concurrency
recorder: every `flow.BoundedChannel`'s condition, the tracing lock and
`capture_lock` (the one lock that the serving worker, the lifecycle's
canary and a fitting thread all take) are wrapped so acquisitions are
observed, every `flow.pump`/`flow.spawn` worker is registered, and every
channel's open -> close lifecycle is balanced. At exit the recorder fails
(status 66) on:

- **lock-order cycles** in the observed cross-thread acquisition graph:
  the edge A -> B is recorded when a thread *attempts* B while holding A
  (so a real deadlock still leaves its evidence), and a cycle means two
  code paths disagree about the order;
- **leaked workers**: a pump/spawn thread still alive after a bounded
  join: its consumer left it without the close/cancel handshake;
- **unclosed pump channels**: a channel a producer worker was attached to
  that was never closed (by the worker) or cancelled (by the consumer);
- **collective-sequence divergence**: every accounted collective appends
  its `(op, axis, shape, dtype)` to the sequence of the current shard
  scope (`Recorder.shard_scope`), and every shard of a group must record
  the same sequence. The port has no collective yet: this ledger is host
  plumbing, whose caller comes with the multi-card slice.

The static rules (`lock-order`, `channel-protocol`) hold the code; the
sanitizer holds the executions a run really drove. Everything here is
host plumbing that imports neither torch nor the rest of the package
until `enable()`, cheap enough to leave on for a whole run (a dict update
a lock operation, under the recorder's own lock).
"""

from __future__ import annotations

import atexit
import itertools
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

ENV_FLAG = "FLINK_ML_TPU_SANITIZE"

__all__ = [
    "ENV_FLAG",
    "SanitizerError",
    "Recorder",
    "recorder",
    "enabled_by_env",
    "enable",
    "mark_exit_checked",
    "tracked_lock",
    "tracked_rlock",
    "tracked_condition",
    "record_collective",
    "collective_recording",
    "active_recorder",
    "set_process_shard",
    "compare_rank_sequences",
]


class SanitizerError(AssertionError):
    """Raised by `Recorder.check` when the recorded execution broke the
    concurrency contract (a cycle, a leaked worker, an unclosed channel,
    a collective divergence)."""


def enabled_by_env() -> bool:
    return os.environ.get(ENV_FLAG, "").strip() not in ("", "0", "false", "off")


class Recorder:
    """The acquisition graph and the worker, channel and collective
    ledgers."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # guards the ledgers; never held while blocking
        self._held = threading.local()  # per-thread stack of lock names
        # (holder, acquired) -> sample: (thread name, count)
        self.edges: Dict[Tuple[str, str], List] = {}
        self.acquisitions = 0
        self.locks: Set[str] = set()  # the names of the locks acquired
        # channel token -> [name, pumped, closed]; the token is stamped on
        # the channel, as a dead channel's id() may be a new channel's
        self._channels: Dict[int, List] = {}
        self._tokens = itertools.count()
        self._workers: List[Tuple[threading.Thread, str]] = []
        # group -> shard -> [(op, axis, shape, dtype), ...]
        self.collective_sequences: Dict[str, Dict[str, List[Tuple]]] = {}
        self.collective_count = 0
        self._shard_ctx = threading.local()  # per-thread (group, shard)

    # -- lock events ---------------------------------------------------------
    def _stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def on_attempt(self, name: str) -> None:
        """Record edges BEFORE blocking on the acquire, so a genuine
        deadlock still leaves the inversion in the ledger."""
        stack = self._stack()
        if not stack:
            return
        thread = threading.current_thread().name
        with self._mu:
            for holder in stack:
                if holder == name:
                    continue  # reentrant re-acquire, not an ordering edge
                entry = self.edges.setdefault((holder, name), [thread, 0])
                entry[1] += 1

    def on_acquired(self, name: str) -> None:
        self._stack().append(name)
        with self._mu:
            self.acquisitions += 1
            self.locks.add(name)

    def on_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- channel / worker ledger ---------------------------------------------
    def register_channel(self, channel) -> None:
        with self._mu:
            channel._sanitizer_token = token = next(self._tokens)
            self._channels[token] = [getattr(channel, "name", "channel"), False, False]

    def _entry(self, channel) -> Optional[List]:
        return self._channels.get(getattr(channel, "_sanitizer_token", None))

    def channel_pumped(self, channel) -> None:
        with self._mu:
            entry = self._entry(channel)
            if entry is not None:
                entry[1] = True

    def channel_closed(self, channel) -> None:
        with self._mu:
            entry = self._entry(channel)
            if entry is not None:
                entry[2] = True

    def register_worker(self, thread: threading.Thread, kind: str) -> None:
        with self._mu:
            self._workers.append((thread, kind))

    # -- collective-sequence ledger -------------------------------------------
    def shard_scope(self, shard, group: str = "mesh"):
        """Context manager entering a per-shard recording scope: every
        collective recorded inside appends to `group`'s sequence for
        `shard`, so divergence across shards is observable."""
        rec = self

        class _Scope:
            def __enter__(self_inner):
                prev = getattr(rec._shard_ctx, "scope", None)
                rec._shard_ctx.scope = (str(group), str(shard))
                self_inner._prev = prev
                return rec

            def __exit__(self_inner, *exc):
                rec._shard_ctx.scope = self_inner._prev
                return False

        return _Scope()

    def record_collective(self, op: str, axis, shape, dtype) -> None:
        """One accounted collective: appended to the current shard
        scope's sequence (default scope: the process-wide trace context,
        which cannot diverge against itself)."""
        scope = getattr(self._shard_ctx, "scope", None)
        if scope is None:
            scope = _process_shard or ("trace", "0")
        group, shard = scope
        event = (str(op), str(axis), tuple(shape), str(dtype))
        with self._mu:
            self.collective_sequences.setdefault(group, {}).setdefault(
                shard, []
            ).append(event)
            self.collective_count += 1

    def collective_divergences(self) -> List[str]:
        """Cross-shard sequence mismatches, one message per group."""
        with self._mu:
            groups = {
                g: {s: list(seq) for s, seq in shards.items()}
                for g, shards in self.collective_sequences.items()
            }
        out: List[str] = []
        for group, shards in sorted(groups.items()):
            if len(shards) < 2:
                continue
            names = sorted(shards)
            ref_name, ref = names[0], shards[names[0]]
            for name in names[1:]:
                seq = shards[name]
                limit = min(len(ref), len(seq))
                mismatch = next(
                    (i for i in range(limit) if ref[i] != seq[i]), None
                )
                if mismatch is None and len(ref) == len(seq):
                    continue
                if mismatch is None:
                    longer, shorter = (
                        (ref_name, name) if len(ref) > len(seq) else (name, ref_name)
                    )
                    extra = (ref if len(ref) > len(seq) else seq)[limit]
                    out.append(
                        f"collective-sequence divergence in group {group!r}: "
                        f"shard {longer!r} issued {extra} at position {limit} "
                        f"but shard {shorter!r} ended after {limit} "
                        "collective(s) — the shorter shard would deadlock "
                        "the longer one on a real mesh"
                    )
                else:
                    out.append(
                        f"collective-sequence divergence in group {group!r} "
                        f"at position {mismatch}: shard {ref_name!r} issued "
                        f"{ref[mismatch]} but shard {name!r} issued "
                        f"{seq[mismatch]} — mismatched collectives deadlock "
                        "a multi-host mesh (see the collective-divergence "
                        "lint rule for the static dual)"
                    )
                break  # one message per divergent pair is enough evidence
        return out

    # -- verdicts ------------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the recorded acquisition DAG (one
        representative per cycle, smallest node first)."""
        with self._mu:
            adjacency: Dict[str, Set[str]] = {}
            for holder, acquired in self.edges:
                adjacency.setdefault(holder, set()).add(acquired)
        out: List[List[str]] = []
        seen: Set[Tuple[str, ...]] = set()

        def dfs(start: str, current: str, path: List[str]) -> None:
            for nxt in sorted(adjacency.get(current, ())):
                if nxt == start:
                    key = tuple(path)
                    if key not in seen:
                        seen.add(key)
                        out.append(list(path))
                elif nxt not in path and nxt > start:
                    dfs(start, nxt, path + [nxt])

        for node in sorted(adjacency):
            dfs(node, node, [node])
        return out

    def problems(self, join_timeout: float = 2.0) -> List[str]:
        """Everything wrong with the recorded execution, as messages."""
        out: List[str] = []
        for cycle in self.cycles():
            order = " -> ".join(cycle + [cycle[0]])
            with self._mu:
                evidence = "; ".join(
                    f"{a}->{b} (thread {self.edges[(a, b)][0]}, x{self.edges[(a, b)][1]})"
                    for a, b in zip(cycle, cycle[1:] + [cycle[0]])
                    if (a, b) in self.edges
                )
            out.append(f"lock-order cycle: {order} [{evidence}]")
        with self._mu:
            workers = list(self._workers)
            channels = list(self._channels.values())
        for thread, kind in workers:
            if thread.is_alive():
                thread.join(join_timeout)
            if thread.is_alive():
                out.append(
                    f"leaked worker: {kind} thread {thread.name!r} still "
                    "alive at exit — its consumer never closed/cancelled "
                    "the handshake channel"
                )
        for name, pumped, closed in channels:
            if pumped and not closed:
                out.append(
                    f"unclosed pump channel {name!r}: a producer worker was "
                    "attached but close()/cancel() never ran"
                )
        out.extend(self.collective_divergences())
        return out

    def check(self, join_timeout: float = 2.0) -> None:
        found = self.problems(join_timeout)
        if found:
            raise SanitizerError(
                "concurrency sanitizer: "
                + "; ".join(found)
                + f" (after {self.acquisitions} recorded acquisitions)"
            )

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {
                "acquisitions": self.acquisitions,
                "locks": len(self.locks),
                "edges": len(self.edges),
                "channels": len(self._channels),
                "channelsClosed": sum(1 for c in self._channels.values() if c[2]),
                "workers": len(self._workers),
                "collectives": self.collective_count,
                "collectiveGroups": len(self.collective_sequences),
            }


#: the process-wide recorder (fresh instances are for unit tests)
recorder = Recorder()


# ---------------------------------------------------------------------------
# tracked lock wrappers
# ---------------------------------------------------------------------------

class _TrackedBase:
    """Context-manager and acquire/release shim over a real lock object,
    reporting to a `Recorder`."""

    def __init__(self, name: str, rec: Optional[Recorder] = None, inner=None):
        self._name = name
        self._rec = rec if rec is not None else recorder
        self._inner = inner

    def acquire(self, *args, **kwargs):
        self._rec.on_attempt(self._name)
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._rec.on_acquired(self._name)
        return got

    def release(self):
        self._rec.on_release(self._name)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


class TrackedLock(_TrackedBase):
    def __init__(self, name: str, rec: Optional[Recorder] = None, inner=None):
        super().__init__(name, rec, inner if inner is not None else threading.Lock())


class TrackedRLock(_TrackedBase):
    def __init__(self, name: str, rec: Optional[Recorder] = None, inner=None):
        super().__init__(name, rec, inner if inner is not None else threading.RLock())


class TrackedCondition(_TrackedBase):
    """Condition wrapper: the wait() internal release/re-acquire is
    reported too, so the held-stack stays truthful across waits."""

    def __init__(self, name: str, rec: Optional[Recorder] = None, inner=None):
        super().__init__(
            name, rec, inner if inner is not None else threading.Condition()
        )

    def wait(self, timeout: Optional[float] = None):
        self._rec.on_release(self._name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._rec.on_acquired(self._name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._rec.on_release(self._name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._rec.on_acquired(self._name)

    def notify(self, n: int = 1):
        return self._inner.notify(n)

    def notify_all(self):
        return self._inner.notify_all()


def tracked_lock(name: str, rec: Optional[Recorder] = None) -> TrackedLock:
    return TrackedLock(name, rec)


def tracked_rlock(name: str, rec: Optional[Recorder] = None) -> TrackedRLock:
    return TrackedRLock(name, rec)


def tracked_condition(name: str, rec: Optional[Recorder] = None) -> TrackedCondition:
    return TrackedCondition(name, rec)


# ---------------------------------------------------------------------------
# collective-sequence funnel
# ---------------------------------------------------------------------------

#: flipped by enable() (or collective_recording); keeps an un-sanitized
#: record_collective at one boolean check
_collectives_on = False
_collective_recorder: Optional[Recorder] = None


def record_collective(op: str, axis, shape, dtype) -> None:
    """The collective ledger's funnel: a no-op unless the sanitizer (or a
    scoped `collective_recording`) is active. `parallel/collectives._account`
    calls it for every accounted collective, as the JAX package's does."""
    if not _collectives_on:
        return
    active_recorder().record_collective(op, axis, shape, dtype)


def active_recorder() -> Recorder:
    """The recorder collectives record into: a scoped
    `collective_recording`'s, else the process-wide one."""
    return _collective_recorder if _collective_recorder is not None else recorder


#: the (group, shard) a rank of a mesh records under by default
_process_shard: Optional[Tuple[str, str]] = None


def set_process_shard(shard, group: str = "mesh") -> None:
    """Make (group, shard) this process's default recording scope: a rank of
    a mesh is one shard of the `mesh` group. None clears it."""
    global _process_shard
    _process_shard = None if shard is None else (str(group), str(shard))


def compare_rank_sequences(group=None, rec: Optional[Recorder] = None,
                           scope: str = "mesh", mesh=None) -> List[str]:
    """Every rank's recorded sequence of `scope` gathered to every rank over
    the process group `group` (default: the world) with `all_gather_object`
    (not itself recorded), and their divergences: one message per divergent
    pair, as `Recorder.collective_divergences` words it. Every rank of the
    group must call it.

    On a mesh with more than one axis of size > 1 (`mesh`, a 2D mesh of
    that world) the ranks of an axis group exchange other payloads than
    the ranks of another (a `model` group gathers its data row's
    activations), so the check is: every rank issued the same (op, axis)
    sequence (group `<scope>/ops`), and within each axis group the ranks
    issued the same collectives on that axis, payload shapes included
    (groups `<scope>/<axis><i>`)."""
    import torch.distributed as dist

    rec = rec if rec is not None else active_recorder()
    with rec._mu:
        mine = {shard: list(seq) for shard, seq in
                rec.collective_sequences.get(scope, {}).items()}
    gathered: List = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, mine, group=group)
    merged = Recorder()
    wide = [] if mesh is None else [a for a in mesh.axis_names if mesh.shape[a] > 1]
    if len(wide) < 2:
        for rank, shards in enumerate(gathered):
            if not shards:
                shards = {str(rank): []}
            for shard, seq in shards.items():
                merged.collective_sequences.setdefault(scope, {})[shard] = seq
        return merged.collective_divergences()
    per_rank = [[tuple(e) for seq in (shards or {}).values() for e in seq]
                for shards in gathered]
    ops = merged.collective_sequences.setdefault(f"{scope}/ops", {})
    for rank, seq in enumerate(per_rank):
        ops[str(rank)] = [(e[0], e[1]) for e in seq]
    grid = np.arange(mesh.size).reshape(tuple(mesh.shape[a] for a in mesh.axis_names))
    for a, name in enumerate(mesh.axis_names):
        if mesh.shape[name] <= 1:
            continue
        for i, line in enumerate(np.moveaxis(grid, a, -1).reshape(-1, mesh.shape[name])):
            lines = merged.collective_sequences.setdefault(f"{scope}/{name}{i}", {})
            for rank in line:
                lines[str(int(rank))] = [e for e in per_rank[int(rank)] if e[1] == name]
    return merged.collective_divergences()


class collective_recording:
    """Scoped recording into a throwaway recorder (unit tests / ad-hoc
    drivers) without globally instrumenting the flow layer."""

    def __init__(self, rec: Optional[Recorder] = None):
        self.rec = rec if rec is not None else Recorder()

    def __enter__(self) -> Recorder:
        global _collectives_on, _collective_recorder
        self._prev = (_collectives_on, _collective_recorder)
        _collectives_on = True
        _collective_recorder = self.rec
        return self.rec

    def __exit__(self, *exc):
        global _collectives_on, _collective_recorder
        _collectives_on, _collective_recorder = self._prev
        return False


# ---------------------------------------------------------------------------
# instrumentation
# ---------------------------------------------------------------------------

_enabled = False
_exit_checked = False


def enable(register_atexit: bool = True) -> None:
    """Instrument the flow layer, the tracing lock and `capture_lock`
    (idempotent). With `register_atexit` the recorder's verdict runs at
    exit and a violation ends the process with status 66; a harness that
    checks `recorder.problems()` itself passes False (or calls
    `mark_exit_checked`)."""
    global _enabled, _collectives_on
    if _enabled:
        return
    _enabled = True
    _collectives_on = True

    from .. import flow, pipeline
    from ..obs import tracing
    from ..utils import lazyjit

    orig_init = flow.BoundedChannel.__init__
    orig_close = flow.BoundedChannel.close
    orig_cancel = flow.BoundedChannel.cancel
    orig_pump = flow.pump
    orig_spawn = flow.spawn

    def init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        self._cv = TrackedCondition(
            f"flow.BoundedChannel._cv[{self.name}]", recorder, inner=self._cv
        )
        recorder.register_channel(self)

    def close(self, error=None):
        recorder.channel_closed(self)
        return orig_close(self, error=error)

    def cancel(self):
        recorder.channel_closed(self)
        return orig_cancel(self)

    def pump(items, channel, transform=None, watchdog=None):
        recorder.channel_pumped(channel)
        worker = orig_pump(items, channel, transform=transform, watchdog=watchdog)
        recorder.register_worker(worker, "pump")
        return worker

    def spawn(fn, name="worker"):
        worker = orig_spawn(fn, name=name)
        recorder.register_worker(worker, "spawn")
        return worker

    flow.BoundedChannel.__init__ = init
    flow.BoundedChannel.close = close
    flow.BoundedChannel.cancel = cancel
    flow.pump = pump
    flow.spawn = spawn
    tracing._lock = TrackedLock("obs.tracing._lock", recorder, inner=tracing._lock)
    # capture_lock has two module bindings: lazyjit's (read by capture())
    # and pipeline's (imported by lifecycle at each promote and restore);
    # both now name one tracked RLock over the original
    tracked = TrackedRLock("utils.lazyjit.capture_lock", recorder, inner=lazyjit.capture_lock)
    lazyjit.capture_lock = tracked
    pipeline.capture_lock = tracked

    if register_atexit:
        atexit.register(_atexit_check)


def mark_exit_checked() -> None:
    """A harness already ran the exit check; the atexit check becomes a
    no-op."""
    global _exit_checked
    _exit_checked = True


def _atexit_check() -> None:
    if _exit_checked:
        return
    found = recorder.problems()
    if found:
        sys.stderr.write(
            "FLINK_ML_TPU_SANITIZE: concurrency violations at exit:\n"
            + "".join(f"  - {p}\n" for p in found)
        )
        sys.stderr.flush()
        os._exit(66)  # atexit cannot change the exit status any other way
    sys.stderr.write(
        "FLINK_ML_TPU_SANITIZE: clean "
        f"({recorder.stats()['acquisitions']} acquisitions, "
        f"{recorder.stats()['workers']} workers, "
        f"{recorder.stats()['channels']} channels, "
        f"{recorder.stats()['collectives']} collectives)\n"
    )
