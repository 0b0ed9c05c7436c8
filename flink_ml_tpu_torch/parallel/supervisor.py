"""The supervisor: host-failure detection, the hang watchdog and automatic
resume of a checkpointed fit, in its one-card form.

Port of flink_ml_tpu/parallel/supervisor.py. A checkpointed fit (the
chunked SGD, stream SGD, out-of-core KMeans, `iterate_bounded`) runs on a
worker thread under a host-health protocol; a detected failure aborts the
attempt, cancels the in-flight snapshot cut, and re-runs the fit, which
restores its newest committed cut, within `config.recovery_budget`.

The hosts are the simulated hosts of `config.snapshot_hosts` (the shards
of a sharded cut). On one card a host owns no device: "re-forming the mesh
over the survivors" keeps the one device and rescopes `snapshot_hosts` to
the live host count, so the device arithmetic of a resumed attempt is the
unkilled fit's and a resume after a shrink is bit for bit too. Re-forming
over fewer devices is the multi-card port's (ROADMAP A.10).

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
        """The device the next attempt runs on: on one card the survivors
        share the one device (re-forming over fewer devices is ROADMAP
        A.10)."""
        from .. import config

        return self.device if self.device is not None else config.device()

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
