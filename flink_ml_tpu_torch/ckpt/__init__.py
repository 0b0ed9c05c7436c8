"""Checkpointing: the JobSnapshot format (`snapshot.py`), the sharded-cut
coordinator (`coordinator.py`) and the fault sites that test them
(`faults.py`). Port of flink_ml_tpu/ckpt/."""

from .coordinator import SnapshotAborted, SnapshotIntegrityError
from .faults import FaultPlan, InjectedFault, failing_map, flaky, inject, tick
from .snapshot import (
    SNAPSHOT_VERSION,
    JobSnapshot,
    load_job_snapshot,
    save_job_snapshot,
    snapshot_file,
    stage_section,
)

__all__ = [
    "SNAPSHOT_VERSION",
    "JobSnapshot",
    "load_job_snapshot",
    "save_job_snapshot",
    "snapshot_file",
    "stage_section",
    "SnapshotAborted",
    "SnapshotIntegrityError",
    "FaultPlan",
    "InjectedFault",
    "failing_map",
    "flaky",
    "inject",
    "tick",
]
