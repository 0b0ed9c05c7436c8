"""flink_ml_tpu_torch/parallel/supervisor.py, the one-card supervisor, on
the CPU.

Case for case the JAX package's tests/test_supervisor.py: `host.die`
(the heartbeat stops; detection rides the heartbeat timeout) and
`host.hang` (the fit thread wedges; detection rides the progress
deadline) at each supervised boundary phase (`dispatch`, `collective`,
`commit`). Every cell recovers within `config.recovery_budget`, sweeps
the in-flight cut, and lands on the unkilled checkpointed fit BIT FOR
BIT: on one card a shrink keeps the one device, so the arithmetic is the
unkilled fit's after a death too (the JAX package, re-forming over fewer
devices, holds a shrink allclose). Also: the stream SGD, the out-of-core
KMeans and `iterate_bounded` under supervision, the typed budget
exhaustion, errors that are not host failures, and the board.
"""

import os
import time

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch import StreamTable, Table, config
from flink_ml_tpu_torch.ckpt import InjectedFault, coordinator, faults
from flink_ml_tpu_torch.ops import losses
from flink_ml_tpu_torch.ops.optimizer import SGD
from flink_ml_tpu_torch.parallel import supervisor
from flink_ml_tpu_torch.parallel.iteration import iterate_bounded
from flink_ml_tpu_torch.utils import metrics

FAST = dict(heartbeat_timeout_s=0.25, poll_interval_s=0.01, stall_safety_s=30.0)
HANG = dict(heartbeat_timeout_s=10.0, poll_interval_s=0.01, stall_safety_s=30.0)


@pytest.fixture(autouse=True)
def on_cpu():
    with config.use_device("cpu"):
        yield


def _dense_problem(n=384, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ np.linspace(1, -1, d) > 0).astype(np.float32)
    return X, y


def _sgd_fit(X, y, ckpt, key="sup", max_iter=12):
    def fit(device):
        assert device == torch.device("cpu")  # the one device of every attempt
        return SGD(max_iter=max_iter, global_batch_size=96, tol=0.0, checkpoint_dir=ckpt,
                   checkpoint_key=key).optimize(np.zeros(X.shape[1]), X, y, None,
                                                losses.BINARY_LOGISTIC_LOSS)

    return fit


@pytest.fixture(scope="module")
def problem():
    return _dense_problem()


@pytest.fixture(scope="module")
def reference(problem, tmp_path_factory):
    X, y = problem
    with config.use_device("cpu"):
        coeff, _, epochs = _sgd_fit(X, y, str(tmp_path_factory.mktemp("ref")))(
            torch.device("cpu"))
    assert epochs == 12
    return coeff


def _no_uncommitted(path, key):
    cuts = coordinator.committed_cuts(path, key)
    newest = cuts[-1] if cuts else 0
    stray = [n for n in os.listdir(path)
             if (coordinator._cut_of(n, coordinator._base(key)) or 0) > newest or ".tmp" in n]
    assert stray == [], f"in-flight cut not cancelled: {stray}"


# ---------------------------------------------------------------------------
# single scenarios
# ---------------------------------------------------------------------------

def test_host_death_detected_quarantined_and_shrink_resumed(problem, reference, tmp_path):
    X, y = problem
    d = str(tmp_path)
    before = metrics.get_counter("supervisor.hostFailure", 0)
    with config.snapshot_hosts_mode(4):
        with faults.inject("host.die.dispatch", after=4):
            res = supervisor.supervise(_sgd_fit(X, y, d), hosts=4, checkpoint_dir=d,
                                       job_key="sup", **FAST)
    assert res.attempts == 2 and res.recoveries == 1
    (ev,) = res.events
    assert ev.kind == "hostFailure" and ev.phase == "dispatch"
    assert ev.quarantined and res.hosts == 3
    assert 0.0 < ev.detection_ms < 5000.0
    assert ev.recovery_ms is not None and ev.recovery_ms < 30000.0
    assert metrics.get_counter("supervisor.hostFailure", 0) == before + 1
    coeff, _, epochs = res.value
    assert epochs == 12
    np.testing.assert_array_equal(coeff, reference)  # one card: a shrink keeps the arithmetic
    _no_uncommitted(d, "sup")


def test_collective_hang_detected_readmit_resume_bit_identical(problem, reference, tmp_path):
    X, y = problem
    d = str(tmp_path)
    with config.snapshot_hosts_mode(4):
        with faults.inject("host.hang.collective", after=4):
            res = supervisor.supervise(_sgd_fit(X, y, d), hosts=4, checkpoint_dir=d,
                                       job_key="sup", **HANG)
    (ev,) = res.events
    assert ev.kind == "collectiveHang" and ev.phase == "collective"
    assert not ev.quarantined and res.hosts == 4
    coeff, _, epochs = res.value
    assert epochs == 12
    np.testing.assert_array_equal(coeff, reference)
    _no_uncommitted(d, "sup")


def test_recovery_budget_exhausted_raises_typed(problem, tmp_path):
    X, y = problem
    d = str(tmp_path)
    with config.snapshot_hosts_mode(4):
        with faults.inject("host.die", after=2):
            with pytest.raises(supervisor.RecoveryBudgetExhausted) as ei:
                supervisor.supervise(_sgd_fit(X, y, d), hosts=4, checkpoint_dir=d, job_key="sup",
                                     recovery_budget=0, **FAST)
    assert isinstance(ei.value.__cause__, supervisor.HostFailure)
    assert len(ei.value.events) == 1


def test_the_budget_comes_from_the_config(problem, tmp_path):
    X, y = problem
    d = str(tmp_path)
    with config.recovery_budget_mode(0), config.snapshot_hosts_mode(2):
        with faults.inject("host.die", after=2):
            with pytest.raises(supervisor.RecoveryBudgetExhausted):
                supervisor.supervise(_sgd_fit(X, y, d), checkpoint_dir=d, job_key="sup", **FAST)
    assert config.recovery_budget == 2


def test_non_supervised_errors_propagate_untouched():
    def bad_fit(device):
        raise ValueError("data bug")

    with pytest.raises(ValueError, match="data bug"):
        supervisor.supervise(bad_fit, hosts=2, **FAST)
    assert supervisor.active() is None


def test_injected_crash_at_other_sites_is_not_laundered(problem, tmp_path):
    X, y = problem
    with faults.inject("chunk", after=2):
        with pytest.raises(InjectedFault):
            supervisor.supervise(_sgd_fit(X, y, str(tmp_path)), hosts=2, **FAST)


def test_pulses_are_noops_outside_supervision():
    supervisor.pulse_boundary(supervisor.PHASE_DISPATCH)
    supervisor.pulse_boundary(supervisor.PHASE_COMMIT)
    supervisor.note_progress(0.01)
    assert supervisor.active() is None


def test_unknown_policies_are_refused():
    with pytest.raises(ValueError, match="on_hang"):
        supervisor.supervise(lambda device: None, on_hang="retry")
    with pytest.raises(ValueError, match="on_failure"):
        supervisor.supervise(lambda device: None, on_failure="retry")


# ---------------------------------------------------------------------------
# the board
# ---------------------------------------------------------------------------

def test_the_survivors_keep_the_one_device():
    board = supervisor.HostBoard(4)
    assert board.live() == [0, 1, 2, 3]
    board.quarantine(2)
    assert board.live() == [0, 1, 3] and board.live_count() == 3
    assert board.form_mesh() == torch.device("cpu")


def test_overdue_tracks_only_stopped_senders():
    board = supervisor.HostBoard(3)
    board.mark_dead(1, "dispatch")
    time.sleep(0.02)
    board.beat_live(time.monotonic())
    assert board.overdue(time.monotonic(), 0.5) == []
    time.sleep(0.06)
    board.beat_live(time.monotonic())
    assert [h for h, _ in board.overdue(time.monotonic(), 0.05)] == [1]


# ---------------------------------------------------------------------------
# the chaos matrix: kill and hang, mid-epoch / mid-collective / mid-commit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["dispatch", "collective", "commit"])
@pytest.mark.parametrize("kind", ["die", "hang"])
def test_sgd_chaos_matrix(problem, reference, tmp_path, kind, phase):
    X, y = problem
    d = str(tmp_path)
    after = 6 if phase == "commit" else 4
    with config.snapshot_hosts_mode(4):
        with faults.inject(f"host.{kind}.{phase}", after=after) as plan:
            res = supervisor.supervise(_sgd_fit(X, y, d), hosts=4, checkpoint_dir=d,
                                       job_key="sup", **(HANG if kind == "hang" else FAST))
    assert plan.fired
    assert res.recoveries == 1 and res.attempts == 2
    (ev,) = res.events
    assert ev.phase == phase
    assert ev.kind == ("hostFailure" if kind == "die" else "collectiveHang")
    assert 0.0 < ev.detection_ms < 10000.0
    coeff, _, epochs = res.value
    assert epochs == 12
    assert res.hosts == (4 if kind == "hang" else 3) and ev.quarantined == (kind == "die")
    np.testing.assert_array_equal(coeff, reference)
    _no_uncommitted(d, "sup")


@pytest.mark.parametrize("kind", ["die", "hang"])
def test_single_file_snapshots_recover_too(problem, reference, tmp_path, kind):
    X, y = problem
    d = str(tmp_path)
    with faults.inject(f"host.{kind}", after=5):
        res = supervisor.supervise(_sgd_fit(X, y, d), hosts=2, checkpoint_dir=d, job_key="sup",
                                   **(HANG if kind == "hang" else FAST))
    assert res.recoveries == 1
    np.testing.assert_array_equal(res.value[0], reference)


def test_stream_sgd_host_death_resumes(tmp_path):
    X, y = _dense_problem(n=480, seed=3)

    def chunks():
        return iter([(X[i:i + 120], y[i:i + 120], None) for i in range(0, 480, 120)])

    def make_fit(ckpt):
        def fit(device):
            return SGD(max_iter=8, global_batch_size=120, tol=0.0, checkpoint_dir=ckpt,
                       checkpoint_key="sup-stream").optimize_stream(
                None, chunks(), losses.BINARY_LOGISTIC_LOSS)

        return fit

    expected, _, _, _ = make_fit(None)(torch.device("cpu"))
    d = str(tmp_path)
    with config.snapshot_hosts_mode(4):
        with faults.inject("host.die", after=6):
            res = supervisor.supervise(make_fit(d), hosts=4, checkpoint_dir=d,
                                       job_key="sup-stream", **FAST)
    assert res.recoveries == 1 and res.events[0].kind == "hostFailure"
    coeff, _, epochs, _ = res.value
    assert epochs == 8
    np.testing.assert_array_equal(coeff, expected)


def test_kmeans_out_of_core_hang_resumes_bit_identical(tmp_path):
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

    rng = np.random.RandomState(7)
    X = np.concatenate([rng.randn(200, 4) + 3.0, rng.randn(200, 4) - 3.0])
    rng.shuffle(X)

    def fit(device):
        return KMeans().set_k(3).set_seed(11).set_max_iter(6).fit(StreamTable.from_batches(
            [Table({"features": X[i:i + 80]}) for i in range(0, 400, 80)]))

    full = fit(torch.device("cpu"))
    d = str(tmp_path)
    with config.iteration_checkpointing(d):
        with faults.inject("host.hang", after=5):
            res = supervisor.supervise(fit, hosts=4, checkpoint_dir=d, **HANG)
    assert res.recoveries == 1 and res.events[0].kind == "collectiveHang"
    np.testing.assert_array_equal(res.value.centroids, full.centroids)
    np.testing.assert_array_equal(res.value.weights, full.weights)


def test_iterate_bounded_hang_resumes_bit_identical(tmp_path):
    def body(carry, epoch):
        new = carry * 0.9 + 1.0
        return new, torch.max(torch.abs(new - carry))

    def make_fit(ckpt):
        def fit(device):
            return iterate_bounded(body, torch.zeros(4), max_iter=10, tol=None,
                                   checkpoint_dir=ckpt, checkpoint_interval=2, chunk_size=2,
                                   job_key="sup-it")

        return fit

    ref = make_fit(None)(None)
    d = str(tmp_path)
    with faults.inject("host.hang", after=3):
        res = supervisor.supervise(make_fit(d), hosts=2, checkpoint_dir=d, job_key="sup-it", **HANG)
    assert res.recoveries == 1
    assert res.value.num_epochs == ref.num_epochs == 10
    assert torch.equal(res.value.carry, ref.carry)
