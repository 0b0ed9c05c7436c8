"""The supervisor: host-failure detection, the hang watchdog and automatic
resume of a checkpointed fit, in its one-card form.

Port of flink_ml_tpu/parallel/supervisor.py. A checkpointed fit (the
chunked SGD, stream SGD, out-of-core KMeans, `iterate_bounded`) runs on a
worker thread under a host-health protocol; a detected failure aborts the
attempt, cancels the in-flight snapshot cut, and re-runs the fit, which
restores its newest committed cut, within `config.recovery_budget`.

The hosts of `supervise` are the simulated hosts of `config.snapshot_hosts`
(the shards of a sharded cut). In one process a host owns no device:
"re-forming the mesh over the survivors" keeps the one device and rescopes
`snapshot_hosts` to the live host count, so the device arithmetic of a
resumed attempt is the unkilled fit's and a resume after a shrink is bit
for bit too.

The shrink over ranks (`supervise_world`): a world of R ranks
(parallel/launcher.py) in H hosts, a host being a contiguous group of
ranks (`mesh.host_groups`, so on a 2D mesh built for H hosts it owns whole
data rows). Every rank runs a checkpointed fit that restores its newest
committed cut. A dead host is a host a rank process of which exited on
its own with a failure status, whatever its code (`World.deaths`: the
injected `host.die` ends its ranks with `os._exit`, a kill or the out-of-
memory killer with a signal); its peers' collectives then fail, and the
world's job raises. A hung host is one whose ranks gave the failed job no
result while none died (`World.silent`, or the host whose injected
`host.hang` fired): it blocks at its boundary and its peers' collectives
time out (the world's `collective_timeout_s`). Any other failure is the
fit's own and is raised. On either the supervisor closes the world (the
hung ranks are killed), sweeps the cut in flight, quarantines the host
(`shrink`) or keeps it (`readmit`), and launches a new world of the
surviving rank count, which resumes from the newest committed cut, each
leaf re-sharded onto the new mesh by `snapshot.stage_section`. Each rank
stamps the wall time of its boundaries and of a fired fault in a file of
the supervisor's, so an event's `detection_ms` runs from the fault (a
fired fault's stamp, else a death as the launcher saw it, else the hung
host's last boundary) to the first failure the launcher saw, and its
`recovery_ms` from that failure to the first boundary of the relaunched
world. The shrink
is a relaunch, not a `torch.distributed.new_group` over the survivors: a
new group needs every rank of the old world to call `new_group`, the dead
ones too, and a gloo group with a dead member hangs each collective until
its timeout. A readmit resume runs the same rank count, so it equals the
unkilled fit bit for bit; a shrink resume reduces over fewer ranks, so it
is held allclose (the JAX package's tests/test_supervisor.py:1-12).

Two independent detectors, because the two failures look different:

- **Heartbeats → `HostFailure`.** Each simulated host beats on the
  supervisor's side channel (the monitor animates the senders of live
  hosts each poll). A beat older than `config.host_heartbeat_timeout_s`
  is a dead host.
- **Progress deadline → `CollectiveHang`.** A host alive but stuck keeps
  beating; what stops is progress. Every chunk dispatch, drain and
  snapshot-commit step pulses the supervisor (`pulse_boundary`); the
  deadline is `config.hang_factor` x the trailing chunk wall
  (`flow.StragglerWatchdog`), floored at `config.hang_min_deadline_s`.

On detection the abort event wakes the fit thread, which unwinds with
`SupervisorAbort`; the supervisor joins it and synchronizes the card
(the abandoned attempt's kernels finish before the retry's begin), sweeps
the uncommitted cut (`coordinator.sweep_uncommitted`), quarantines the
failed host (policy `shrink`) or readmits it (`readmit`), and runs the fit
again.

Fault sites (`ckpt/faults.py`): `host.die` / `host.hang` tick at every
supervised boundary, with phase-qualified twins (`host.die.dispatch`,
`.collective`, `.commit`, the same for hang). A fired `host.die` stops the
victim's heartbeat; a fired `host.hang`, and every boundary after a death,
blocks the fit thread until the supervisor aborts it. Detection goes only
through the two signals above.

Obs: `supervisor.detectionMs` / `supervisor.recoveryMs` / `supervisor.hosts`
gauges; `supervisor.hostFailure`, `supervisor.collectiveHang`,
`supervisor.recovery`, `supervisor.quarantine`, `supervisor.stall`,
`supervisor.cutSwept` counters; instants on the `supervisor` timeline lane.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import flow
from ..ckpt import faults
from ..obs import timeline
from ..utils import metrics

__all__ = [
    "HostFailure",
    "CollectiveHang",
    "SupervisorAbort",
    "RecoveryBudgetExhausted",
    "FailureEvent",
    "SupervisedResult",
    "HostBoard",
    "SupervisorContext",
    "supervise",
    "supervise_world",
    "pulse_boundary",
    "note_progress",
    "active",
]

#: Boundary phases a supervised fit pulses through (the chaos-matrix axes).
PHASE_DISPATCH = "dispatch"  # a chunk program was launched (mid-epoch)
PHASE_COLLECTIVE = "collective"  # a blocking drain/readback (mid-collective)
PHASE_COMMIT = "commit"  # a snapshot shard/manifest write (mid-commit)


class HostFailure(RuntimeError):
    """A (simulated) host stopped heartbeating past
    `config.host_heartbeat_timeout_s`: the host is gone, its devices are
    quarantined, and the mesh must re-form without them."""

    def __init__(self, host: int, age_s: float, phase: Optional[str] = None):
        super().__init__(
            f"host {host} heartbeat is {age_s * 1000.0:.0f}ms old "
            f"(timeout exceeded){f' at the {phase} boundary' if phase else ''}"
        )
        self.host = host
        self.age_s = age_s
        self.phase = phase


class CollectiveHang(RuntimeError):
    """The supervised fit stopped making dispatch/drain/commit progress
    past the hang deadline while every host still heartbeats — the
    blocked-in-a-collective (or wedged-commit) failure mode. `host` is
    the last boundary's non-participant when the board observed one
    (collective-entry attribution), else None."""

    def __init__(
        self,
        elapsed_s: float,
        deadline_s: float,
        host: Optional[int] = None,
        phase: Optional[str] = None,
    ):
        super().__init__(
            f"no fit progress for {elapsed_s * 1000.0:.0f}ms "
            f"(hang deadline {deadline_s * 1000.0:.0f}ms)"
            + (f"; host {host} never entered the {phase or 'pending'} boundary"
               if host is not None else "")
        )
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        self.host = host
        self.phase = phase


class SupervisorAbort(RuntimeError):
    """Control-flow unwind of an aborted supervised attempt: raised out
    of the stalled boundary in the FIT thread once the supervisor's
    monitor decided the attempt is dead. Never escapes `supervise` —
    the worker reports it and the supervisor recovers or gives up."""

    def __init__(self, phase: str):
        super().__init__(f"supervised attempt aborted at the {phase} boundary")
        self.phase = phase


class RecoveryBudgetExhausted(RuntimeError):
    """More failures than `config.recovery_budget` recoveries: the
    supervisor gives up, carrying every typed failure it observed so the
    operator sees the whole history, not just the last symptom."""

    def __init__(self, events: Sequence["FailureEvent"]):
        kinds = ", ".join(f"{e.kind}@{e.phase or '?'}" for e in events)
        super().__init__(
            f"recovery budget exhausted after {len(events)} failures ({kinds})"
        )
        self.events = list(events)


@dataclass
class FailureEvent:
    """One detected failure and what recovery cost."""

    kind: str  # "hostFailure" | "collectiveHang"
    host: Optional[int]
    phase: Optional[str]  # boundary phase the fault surfaced at (if known)
    detection_ms: float  # fault observable -> monitor detected
    recovery_ms: Optional[float] = None  # detected -> resumed fit's 1st progress
    quarantined: bool = False
    hosts_after: int = 0
    #: `supervise_world`: the wall time the failure was seen
    detected_at: Optional[float] = field(default=None, repr=False)


@dataclass
class SupervisedResult:
    """`supervise`'s return: the fit's value plus the failure ledger."""

    value: Any
    attempts: int
    events: List[FailureEvent] = field(default_factory=list)
    hosts: int = 0  # live hosts at completion
    device: Any = None  # the device the successful attempt ran on

    @property
    def recoveries(self) -> int:
        return len(self.events)


# ---------------------------------------------------------------------------
# host board: heartbeat ledger + quarantine state
# ---------------------------------------------------------------------------

class HostBoard:
    """Per-host state shared between the fit thread (boundary pulses)
    and the monitor (heartbeat refresh and age checks). On one card the
    hosts are `hosts` simulated hosts over one device; quarantine removes
    a host from every later attempt."""

    def __init__(self, hosts: int, device=None):
        self.device = device
        self.num_hosts = max(1, int(hosts))
        self.groups = [[h] for h in range(self.num_hosts)]
        self._lock = threading.Lock()
        now = time.monotonic()
        self.last_beat: Dict[int, float] = {h: now for h in range(self.num_hosts)}
        self._dead: set = set()  # heartbeat sender stopped (this attempt)
        self._hung: Optional[int] = None  # last boundary's non-participant
        self._hung_phase: Optional[str] = None
        self._quarantined: set = set()  # left out of later attempts

    # -- membership ---------------------------------------------------------
    def live(self) -> List[int]:
        with self._lock:
            return [h for h in range(self.num_hosts) if h not in self._quarantined]

    def live_count(self) -> int:
        return len(self.live())

    def form_mesh(self):
        """The device the next attempt of `supervise` runs on: in one
        process the survivors share the one device (`supervise_world`
        re-forms over fewer ranks by relaunching)."""
        from .. import config

        return self.device if self.device is not None else config.device()

    def live_ranks(self) -> List[int]:
        """The ranks (of the first world) of every live host, in host order:
        the ranks a relaunched world runs, renumbered from 0 in this order."""
        return [r for h in self.live() for r in self.groups[h]]

    # -- failure simulation hooks (called from the FIT thread) ---------------
    def mark_dead(self, host: int, phase: str) -> None:
        """The victim's heartbeat sender stops — from here on its beat
        only ages; the monitor detects through that signal alone."""
        with self._lock:
            self._dead.add(host)
            self._hung, self._hung_phase = host, phase

    def mark_hung(self, host: int, phase: str) -> None:
        """The victim never enters this boundary (collective-entry
        attribution for the hang report); its heartbeat KEEPS going."""
        with self._lock:
            self._hung, self._hung_phase = host, phase

    def any_dead(self) -> bool:
        with self._lock:
            return bool(self._dead)

    def hung_host(self):
        with self._lock:
            return self._hung, self._hung_phase

    # -- heartbeats (monitor side) ------------------------------------------
    def beat_live(self, now: float) -> None:
        """Animate the side-channel heartbeat senders: every live,
        not-dead host beats. A die-marked host's sender stopped — its
        beat ages until the timeout detector fires."""
        with self._lock:
            for h in range(self.num_hosts):
                if h not in self._quarantined and h not in self._dead:
                    self.last_beat[h] = now

    def overdue(self, now: float, timeout_s: float) -> List[tuple]:
        """(host, age_s) pairs past the heartbeat timeout."""
        with self._lock:
            out = []
            for h in range(self.num_hosts):
                if h in self._quarantined:
                    continue
                age = now - self.last_beat[h]
                if age > timeout_s:
                    out.append((h, age))
            return out

    # -- recovery ------------------------------------------------------------
    def quarantine(self, host: int) -> None:
        with self._lock:
            self._quarantined.add(host)
        metrics.inc_counter("supervisor.quarantine")

    def readmit_reset(self) -> None:
        """Start the next attempt with a clean slate for non-quarantined
        hosts: beats refreshed, death/hang marks cleared (a re-admitted
        hung host is considered recovered once the attempt restarts)."""
        now = time.monotonic()
        with self._lock:
            self._dead.clear()
            self._hung, self._hung_phase = None, None
            for h in range(self.num_hosts):
                if h not in self._quarantined:
                    self.last_beat[h] = now


# ---------------------------------------------------------------------------
# the per-attempt context + the module-level hook surface
# ---------------------------------------------------------------------------

class SupervisorContext:
    """One supervised attempt's shared state. The fit thread pulses
    boundaries and progress through the module-level hooks; the monitor
    reads timestamps and flips the abort event. Hooks are bound to the
    worker thread's ident, so a late pulse from a previous (aborted)
    attempt can never leak into the current one."""

    def __init__(self, board: HostBoard, *, victim_host: Optional[int],
                 stall_safety_s: float):
        from .. import config

        self.board = board
        self.victim_host = victim_host
        self.stall_safety_s = float(stall_safety_s)
        self._abort = threading.Event()
        self.worker_ident: Optional[int] = None
        # chunk-wall EMA — the hang deadline's basis (escalate=0: THIS
        # watchdog reports through typed failures, never by raising)
        self.watchdog = flow.StragglerWatchdog(
            "supervisor.chunk", factor=config.hang_factor, warmup=1, escalate=0
        )
        self.progress_at: Optional[float] = None
        self.first_progress_at: Optional[float] = None
        self.fault_visible_at: Optional[float] = None
        self.fault_phase: Optional[str] = None

    # -- monitor side --------------------------------------------------------
    def abort(self) -> None:
        self._abort.set()

    @property
    def aborted(self) -> bool:
        return self._abort.is_set()

    def hang_deadline_s(self) -> Optional[float]:
        """None until a first chunk-wall sample exists (a cold compile
        must not count against the deadline)."""
        from .. import config

        if self.watchdog.samples < 1 or self.progress_at is None:
            return None
        return max(
            config.hang_min_deadline_s,
            config.hang_factor * self.watchdog.trailing_mean_s,
        )

    # -- fit-thread side -----------------------------------------------------
    def _victim(self) -> int:
        live = self.board.live()
        if self.victim_host is not None and self.victim_host in live:
            return self.victim_host
        return live[-1]

    def note_progress(self, wall_s: Optional[float] = None) -> None:
        now = time.monotonic()
        self.progress_at = now
        if self.first_progress_at is None:
            self.first_progress_at = now
        if wall_s is not None:
            self.watchdog.record(wall_s)

    def _note_gap(self) -> None:
        """Fold the inter-boundary gap into the chunk-wall EMA. This is
        what arms the hang detector (samples >= 1) and what makes it
        compile-safe without special-casing: the FIRST boundary records
        nothing (the detector stays disarmed across the attempt's cold
        compile), the second folds a gap that INCLUDES any compile — a
        large first sample the EMA decays from — and steady-state gaps
        track the chunk wall."""
        now = time.monotonic()
        if self.progress_at is not None:
            self.watchdog.record(now - self.progress_at)

    def boundary(self, phase: str) -> None:
        """One supervised boundary: abort check, fault-site ticks, then a
        progress note. A fired `host.die` stops the victim's heartbeats;
        a fired `host.hang` — and every boundary while a peer is dead
        (survivors can't clear the collective without it) — stalls the
        fit thread until the monitor aborts the attempt."""
        if self._abort.is_set():
            raise SupervisorAbort(phase)
        board = self.board
        if board.any_dead():
            self._stall(phase)
        try:
            faults.tick("host.die")
            faults.tick(f"host.die.{phase}")
        except faults.InjectedFault:
            victim = self._victim()
            board.mark_dead(victim, phase)
            self._note_fault(phase)
            self._stall(phase)
        try:
            faults.tick("host.hang")
            faults.tick(f"host.hang.{phase}")
        except faults.InjectedFault:
            victim = self._victim()
            board.mark_hung(victim, phase)
            self._note_fault(phase)
            self._stall(phase)
        self._note_gap()
        self.note_progress()

    def _note_fault(self, phase: str) -> None:
        self.fault_visible_at = time.monotonic()
        self.fault_phase = phase

    def _stall(self, phase: str) -> None:
        """Block like a wedged collective until the supervisor aborts,
        then unwind. The safety timeout exists so a monitor bug can
        never deadlock a test run — hitting it is itself an error."""
        metrics.inc_counter("supervisor.stall")
        if timeline.enabled():
            timeline.record_instant(
                timeline.LANE_SUPERVISOR, "supervisor.stall", phase=phase
            )
        deadline = time.monotonic() + self.stall_safety_s
        while not self._abort.wait(0.02):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"supervised fit stalled at the {phase} boundary for "
                    f"{self.stall_safety_s}s without a supervisor abort — "
                    "the monitor is not running or its detectors are off"
                )
        raise SupervisorAbort(phase)


_active: Optional[SupervisorContext] = None


def active() -> Optional[SupervisorContext]:
    """The running attempt's context when called FROM its fit thread
    (ident-bound), else None — the hooks' fast path."""
    ctx = _active
    if ctx is None or ctx.worker_ident != threading.get_ident():
        return None
    return ctx


def pulse_boundary(phase: str) -> None:
    """Supervised-boundary hook of the checkpointed loops: before a chunk
    is dispatched, at its drain, and at each snapshot commit step. No-op
    outside a supervised fit."""
    ctx = active()
    if ctx is not None:
        ctx.boundary(phase)
    elif _rank_marks is not None:
        _rank_boundary(phase)


def note_progress(wall_s: Optional[float] = None) -> None:
    """Progress hook: stamps the hang watchdog's last-progress time and
    (when given) folds one chunk-wall sample into its EMA. No-op outside
    a supervised fit."""
    ctx = active()
    if ctx is not None:
        ctx.note_progress(wall_s)


# ---------------------------------------------------------------------------
# supervise: run a fit under the host-health protocol
# ---------------------------------------------------------------------------

def _synchronize(device) -> None:
    """Let the abandoned attempt's kernels finish: the retry must not race
    their writes into tensors it frees or reuses."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sweep_in_flight_cut(checkpoint_dir: Optional[str], job_key: Optional[str]) -> int:
    if checkpoint_dir is None:
        return 0
    from ..ckpt import coordinator

    swept = coordinator.sweep_uncommitted(checkpoint_dir, job_key)
    if swept:
        metrics.inc_counter("supervisor.cutSwept", swept)
    return swept


def supervise(
    fit: Callable[[Any], Any],
    *,
    hosts: Optional[int] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    job_key: Optional[str] = None,
    victim_host: Optional[int] = None,
    on_hang: str = "readmit",
    on_failure: str = "shrink",
    recovery_budget: Optional[int] = None,
    heartbeat_timeout_s: Optional[float] = None,
    poll_interval_s: Optional[float] = None,
    stall_safety_s: float = 60.0,
) -> SupervisedResult:
    """Run `fit(device) -> value` under the host-health protocol.

    `fit` must be a resumable checkpointed fit: it restores its own newest
    committed cut on entry, so running it again after a failure is the
    recovery. It gets the device it runs on (`device`, default
    `config.device()`; the one card of every attempt). `hosts` defaults to
    `config.snapshot_hosts` (else 1); with sharded snapshots on, each
    attempt scopes `config.snapshot_hosts` to the live host count.

    Policies: `on_hang` "readmit" (default: a hung host is stuck, not
    gone; the next attempt keeps the host count) or "shrink";
    `on_failure` "shrink" (default: a dead host is quarantined) or
    "readmit". On one card both resume bit for bit.

    Raises `RecoveryBudgetExhausted` past `recovery_budget` recoveries
    (default `config.recovery_budget`). Any error of the fit that is not a
    supervised abort (a data error, an injected kill at another site)
    propagates untouched."""
    global _active
    from .. import config

    n_hosts = hosts if hosts is not None else (config.snapshot_hosts or 1)
    budget = config.recovery_budget if recovery_budget is None else int(recovery_budget)
    hb_timeout = (config.host_heartbeat_timeout_s if heartbeat_timeout_s is None
                  else float(heartbeat_timeout_s))
    poll = config.supervisor_poll_interval_s if poll_interval_s is None else float(poll_interval_s)
    sharded = config.snapshot_hosts is not None
    if on_hang not in ("readmit", "shrink"):
        raise ValueError(f"unknown on_hang policy {on_hang!r}")
    if on_failure not in ("readmit", "shrink"):
        raise ValueError(f"unknown on_failure policy {on_failure!r}")

    board = HostBoard(n_hosts, device)
    events: List[FailureEvent] = []
    attempt = 0
    recovered_at: Optional[float] = None  # detection end of the last failure

    while True:
        attempt += 1
        board.readmit_reset()
        device_now = board.form_mesh()
        metrics.set_gauge("supervisor.hosts", board.live_count())
        ctx = SupervisorContext(board, victim_host=victim_host, stall_safety_s=stall_safety_s)
        result_ch = flow.BoundedChannel(1, name="supervisor.result")

        def run(ctx=ctx, device_now=device_now, result_ch=result_ch):
            ctx.worker_ident = threading.get_ident()
            try:
                if sharded:
                    with config.snapshot_hosts_mode(board.live_count()):
                        value = fit(device_now)
                else:
                    value = fit(device_now)
                result_ch.put(("ok", value))
            except SupervisorAbort as e:
                result_ch.put(("aborted", e))
            except BaseException as e:  # noqa: BLE001 — the channel is the error path
                result_ch.close(error=e)

        _active = ctx
        worker = flow.spawn(run, name="supervised-fit")
        failure: Optional[BaseException] = None
        outcome = None
        try:
            while outcome is None and failure is None:
                try:
                    outcome = result_ch.get(timeout=poll)
                except TimeoutError:
                    pass
                now = time.monotonic()
                board.beat_live(now)
                overdue = board.overdue(now, hb_timeout)
                if overdue:
                    host, age = overdue[0]
                    _, phase = board.hung_host()
                    failure = HostFailure(host, age, phase)
                    break
                deadline = ctx.hang_deadline_s()
                if deadline is not None and now - ctx.progress_at > deadline:
                    hung, phase = board.hung_host()
                    failure = CollectiveHang(now - ctx.progress_at, deadline, hung, phase)
                    break
        finally:
            if failure is not None or outcome is None:
                ctx.abort()
            if outcome is None:
                # wait for the aborted worker to unwind and report; a worker
                # error already propagates out of the get above, so a
                # re-raise here must not skip the join and the deactivation
                try:
                    outcome = result_ch.get(timeout=stall_safety_s)
                except BaseException:  # noqa: BLE001 — see above
                    outcome = None
            worker.join(timeout=stall_safety_s)
            _active = None
            _synchronize(device_now)

        if failure is None and outcome is not None and outcome[0] == "ok":
            if events and events[-1].recovery_ms is None and recovered_at is not None:
                first = ctx.first_progress_at
                events[-1].recovery_ms = (
                    ((first if first is not None else time.monotonic()) - recovered_at) * 1000.0)
                metrics.set_gauge("supervisor.recoveryMs", events[-1].recovery_ms)
            metrics.set_gauge("supervisor.hosts", board.live_count())
            return SupervisedResult(value=outcome[1], attempts=attempt, events=events,
                                    hosts=board.live_count(), device=device_now)
        if failure is None:
            if outcome is not None and isinstance(outcome[1], SupervisorAbort):
                raise RuntimeError(
                    "supervised fit aborted without a recorded failure — "
                    "monitor/worker handshake bug")
            raise RuntimeError("supervised fit ended without outcome or failure")
        if worker.is_alive():
            raise RuntimeError(
                f"the aborted attempt did not unwind within {stall_safety_s}s; "
                "a retry would race its device work")

        # ---- detection bookkeeping ----------------------------------------
        now = time.monotonic()
        visible = ctx.fault_visible_at if ctx.fault_visible_at is not None else (
            ctx.progress_at if ctx.progress_at is not None else now
        )
        detection_ms = max(0.0, (now - visible) * 1000.0)
        kind = "hostFailure" if isinstance(failure, HostFailure) else "collectiveHang"
        metrics.inc_counter(f"supervisor.{kind}")
        metrics.set_gauge("supervisor.detectionMs", detection_ms)
        if timeline.enabled():
            timeline.record_instant(
                timeline.LANE_SUPERVISOR,
                "supervisor.detect",
                kind=kind,
                host=-1 if failure.host is None else int(failure.host),
                phase=failure.phase or "",
                detectionMs=detection_ms,
            )

        # fill the PREVIOUS failure's recovery wall if this attempt got far
        # enough to make progress before failing again
        if events and events[-1].recovery_ms is None and recovered_at is not None:
            first = ctx.first_progress_at
            if first is not None:
                events[-1].recovery_ms = (first - recovered_at) * 1000.0

        # ---- recovery: quarantine, sweep, re-form, resume ------------------
        policy = on_failure if kind == "hostFailure" else on_hang
        quarantined = policy == "shrink" and failure.host is not None
        if quarantined:
            board.quarantine(int(failure.host))
        swept = _sweep_in_flight_cut(checkpoint_dir, job_key)
        events.append(
            FailureEvent(
                kind=kind,
                host=failure.host,
                phase=failure.phase,
                detection_ms=detection_ms,
                quarantined=quarantined,
                hosts_after=board.live_count(),
            )
        )
        if len(events) > budget:
            raise RecoveryBudgetExhausted(events) from failure
        if not board.live():
            raise RecoveryBudgetExhausted(events) from failure
        metrics.inc_counter("supervisor.recovery")
        recovered_at = time.monotonic()
        if timeline.enabled():
            timeline.record_instant(
                timeline.LANE_SUPERVISOR,
                "supervisor.recover",
                attempt=attempt,
                hosts=board.live_count(),
                swept=swept,
            )


# ---------------------------------------------------------------------------
# supervise_world: the shrink over the ranks of a world
# ---------------------------------------------------------------------------

#: the exit status of a rank whose injected `host.die` fired
DIE_EXIT_CODE = 75

#: this rank's stamp file while it runs a `supervise_world` job, else None
_rank_marks: Optional[str] = None


def _stamp(kind: str) -> None:
    """Append "kind wall-time" to this rank's stamp file."""
    with open(_rank_marks, "a") as f:
        f.write(f"{kind} {time.time()!r}\n")


def _rank_boundary(phase: str) -> None:
    """A boundary of a rank under `supervise_world`: stamped; a fired
    `host.die` ends this process (a dead host); a fired `host.hang` blocks
    it until the supervisor kills it (a hung host), each stamped first.
    Only the victim host's ranks arm a plan, so elsewhere the ticks cost
    one global load."""
    import os

    _stamp("boundary")
    try:
        faults.tick("host.die")
        faults.tick(f"host.die.{phase}")
    except faults.InjectedFault:
        _stamp("fault")
        os._exit(DIE_EXIT_CODE)
    try:
        faults.tick("host.hang")
        faults.tick(f"host.hang.{phase}")
    except faults.InjectedFault:
        _stamp("fault")
        metrics.inc_counter("supervisor.stall")
        while True:
            time.sleep(0.5)


def supervised_rank(path: str, args, plan) -> Any:
    """A rank's attempt of `supervise_world`: run the job at `path` with
    `args`, stamping its boundaries in the file `plan["marks"]` names for
    this attempt and rank, with the fault of `plan` (site, after, victim
    ranks), if any, armed on the victim ranks."""
    global _rank_marks
    import os

    import torch.distributed as dist

    from .launcher import resolve

    rank = dist.get_rank()
    _rank_marks = os.path.join(plan["marks"], f"{plan['attempt']}.{rank}")
    try:
        if plan.get("site") is not None and rank in plan["ranks"]:
            with faults.inject(plan["site"], after=plan["after"]):
                return resolve(path)(*args)
        return resolve(path)(*args)
    finally:
        _rank_marks = None


def _read_stamps(marks: str, attempt: int, ranks: int) -> List[Dict[str, List[float]]]:
    """Every rank's stamps of an attempt: kind -> wall times, in order."""
    import os

    out: List[Dict[str, List[float]]] = []
    for r in range(ranks):
        got: Dict[str, List[float]] = {}
        path = os.path.join(marks, f"{attempt}.{r}")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    kind, _, t = line.partition(" ")
                    got.setdefault(kind, []).append(float(t))
        out.append(got)
    return out


def _classify(world, stamps, host_of) -> Optional[tuple]:
    """(kind, host, fault wall time) of a failed attempt, or None when it
    is the fit's own failure: a host with a rank that died on its own
    (`world.deaths`, any code) failed; else a host whose fault fired, or the
    one host whose ranks gave no result (`world.silent`), hung."""
    if world.deaths:
        first = min(world.deaths, key=lambda r: world.deaths[r][1])
        host = host_of(first)
        ranks = [r for r in range(len(stamps)) if host_of(r) == host]
        fired = [t for r in ranks for t in stamps[r].get("fault", [])]
        seen = [world.deaths[r][1] for r in ranks if r in world.deaths]
        return "hostFailure", host, min(fired or seen)
    fired = [r for r, st in enumerate(stamps) if st.get("fault")]
    hosts = {host_of(r) for r in (fired or world.silent)}
    if len(hosts) != 1:
        return None
    (host,) = hosts
    ranks = [r for r in range(len(stamps)) if host_of(r) == host]
    times = [t for r in ranks for t in stamps[r].get("fault", [])] or \
        [stamps[r]["boundary"][-1] for r in ranks if stamps[r].get("boundary")]
    return "collectiveHang", host, min(times) if times else world.failed_at


def supervise_world(
    target,
    *args,
    world_size: int,
    hosts: int,
    fault: Optional[str] = None,
    after: int = 1,
    victim_host: Optional[int] = None,
    on_failure: str = "shrink",
    on_hang: str = "readmit",
    checkpoint_dir: Optional[str] = None,
    job_key: Optional[str] = None,
    recovery_budget: Optional[int] = None,
    world_kwargs: Optional[Dict[str, Any]] = None,
    job_timeout_s: Optional[float] = None,
) -> SupervisedResult:
    """Run the checkpointed fit `target(*args)` (a launcher target: it
    restores its newest committed cut on entry) on every rank of a world of
    `world_size` ranks in `hosts` hosts, and recover from a host's death or
    hang (module docstring). `fault` ("host.die.dispatch", "host.hang.
    collective", ...) is armed on the first attempt's ranks of
    `victim_host` (default the last host), firing at their `after`-th
    boundary. `world_kwargs` go to `launcher.World` (its `model_shards`
    must divide every attempt's rank count). Returns the SupervisedResult
    whose value is every rank's result of the successful attempt and whose
    `hosts` is the live host count."""
    from .. import config
    from . import launcher
    from . import mesh as mesh_lib

    if on_hang not in ("readmit", "shrink"):
        raise ValueError(f"unknown on_hang policy {on_hang!r}")
    if on_failure not in ("readmit", "shrink"):
        raise ValueError(f"unknown on_failure policy {on_failure!r}")
    budget = config.recovery_budget if recovery_budget is None else int(recovery_budget)
    board = HostBoard(hosts)
    board.groups = mesh_lib.host_groups(mesh_lib.Mesh((mesh_lib.DATA_AXIS,), (world_size,)),
                                   hosts)
    path = launcher.target_path(target)
    events: List[FailureEvent] = []
    attempt = 0
    marks = tempfile.mkdtemp(prefix="flink_ml_tpu_torch_supervise_")
    try:
        while True:
            attempt += 1
            ranks = board.live_ranks()
            metrics.set_gauge("supervisor.hosts", board.live_count())
            plan: Dict[str, Any] = {"marks": marks, "attempt": attempt}
            if attempt == 1 and fault is not None:
                live = board.live()
                victim = victim_host if victim_host in live else live[-1]
                plan.update(site=fault, after=int(after),
                            ranks=[ranks.index(r) for r in board.groups[victim]])
            world = launcher.World(len(ranks), **(world_kwargs or {}))
            try:
                values = world.run(supervised_rank, path, args, plan, timeout_s=job_timeout_s)
            except (launcher.RankError, TimeoutError) as e:
                failure = e
            else:
                world.close()
                _note_recovery(events, _read_stamps(marks, attempt, len(ranks)))
                return SupervisedResult(value=values, attempts=attempt, events=events,
                                        hosts=board.live_count(), device=len(ranks))
            finally:
                world.close(join_s=5.0)
            stamps = _read_stamps(marks, attempt, len(ranks))
            _note_recovery(events, stamps)

            def host_of(r, ranks=ranks):
                return next(h for h, g in enumerate(board.groups) if ranks[r] in g)
            found = _classify(world, stamps, host_of)
            if found is None:  # no host failed or hung: the fit itself failed
                raise failure
            kind, host, fault_at = found
            fired = any(st.get("fault") for r, st in enumerate(stamps) if host_of(r) == host)
            phase = fault.split(".")[2] if fired and fault and fault.count(".") >= 2 else None
            detection_ms = max(0.0, (world.failed_at - fault_at) * 1000.0)
            metrics.inc_counter(f"supervisor.{kind}")
            metrics.set_gauge("supervisor.detectionMs", detection_ms)
            policy = on_failure if kind == "hostFailure" else on_hang
            quarantined = policy == "shrink"
            if quarantined:
                board.quarantine(int(host))
            _sweep_in_flight_cut(checkpoint_dir, job_key)
            events.append(FailureEvent(kind=kind, host=host, phase=phase,
                                       detection_ms=detection_ms, quarantined=quarantined,
                                       hosts_after=board.live_count(),
                                       detected_at=world.failed_at))
            if len(events) > budget or not board.live():
                raise RecoveryBudgetExhausted(events) from failure
            metrics.inc_counter("supervisor.recovery")
            if timeline.enabled():
                timeline.record_instant(timeline.LANE_SUPERVISOR, "supervisor.recover",
                                        attempt=attempt, hosts=board.live_count())
    finally:
        shutil.rmtree(marks, ignore_errors=True)


def _note_recovery(events: List[FailureEvent], stamps) -> None:
    """The last event's `recovery_ms`, from its detection to the first
    boundary any rank of the next attempt stamped, once there is one."""
    if not events or events[-1].recovery_ms is not None:
        return
    first = [st["boundary"][0] for st in stamps if st.get("boundary")]
    if first:
        events[-1].recovery_ms = max(0.0, (min(first) - events[-1].detected_at) * 1000.0)
        metrics.set_gauge("supervisor.recoveryMs", events[-1].recovery_ms)
