"""Checkpointed fits of the port, killed and resumed, on the CPU.

Case for case the JAX package's tests/test_fault_injection.py and the
fit half of tests/test_checkpointing.py, where the subject exists in the
port. A fit killed at a `chunk`, `epoch`, `batch`, snapshot-write, shard
or commit site (ckpt/faults.py) resumes from its last snapshot and lands
on the unkilled fit BIT FOR BIT: dense and sparse SGD, stream SGD (with
and without the cache's contents), out-of-core KMeans, OnlineLogistic-
Regression and OnlineKMeans, the fleet and the lifecycle. A checkpointed
SGD fit equals the unchecked whole fit bit for bit, and a fit whose tol
fires inside a chunk stops at the JAX package's epoch.

Against the JAX package, on the same seeded numpy inputs, at
test_torch_sgd.py's tolerances (rtol 1e-4, atol 1e-6; the same epoch
count): the checkpointed fits, and resumes across packages both ways (a
JAX fit killed at `chunk` resumed by the port, and the reverse, each
within tolerance of the unkilled JAX fit).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import config as jax_config
from flink_ml_tpu.ckpt import faults as jax_faults
from flink_ml_tpu.linalg import DenseVector as JaxDenseVector
from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.table import StreamTable as JaxStreamTable
from flink_ml_tpu_torch import StreamTable, Table, config
from flink_ml_tpu_torch.ckpt import InjectedFault, SnapshotIntegrityError, coordinator, faults
from flink_ml_tpu_torch.ckpt.faults import TransientFault
from flink_ml_tpu_torch.ckpt import snapshot as port_snapshot
from flink_ml_tpu_torch.linalg import DenseVector
from flink_ml_tpu_torch.ops import losses
from flink_ml_tpu_torch.ops.optimizer import SGD
from flink_ml_tpu_torch.utils import metrics

SGD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _dense_problem(n=384, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ np.linspace(1, -1, d) > 0).astype(np.float32)
    return X, y


def _sparse_problem(seed=1, n=384, d=24, nnz=4):
    rng = np.random.RandomState(seed)
    indices = np.full((n, nnz), -1, np.int32)
    values = np.zeros((n, nnz), np.float32)
    for i in range(n):
        indices[i] = np.sort(rng.choice(d, size=nnz, replace=False))
        values[i] = rng.rand(nnz)
    dense = np.zeros((n, d), np.float32)
    np.put_along_axis(dense, indices, values, axis=1)
    y = (dense @ (rng.rand(d) - 0.5) > 0).astype(np.float32)
    return (indices, values), y, d


def _sgd(ckpt=None, max_iter=12, key="fault", tol=0.0, **kw):
    return SGD(max_iter=max_iter, global_batch_size=96, tol=tol, checkpoint_dir=ckpt,
               checkpoint_key=key, **kw)


def _jax_sgd(ckpt=None, max_iter=12, key="fault", tol=0.0, **kw):
    return jax_optimizer.SGD(max_iter=max_iter, global_batch_size=96, tol=tol,
                             checkpoint_dir=ckpt, checkpoint_key=key, **kw)


LOSS = losses.BINARY_LOGISTIC_LOSS
SPARSE_LOSS = losses.sparse_variant(LOSS.name)
JAX_LOSS = jax_losses.BINARY_LOGISTIC_LOSS
JAX_SPARSE_LOSS = jax_losses.SPARSE_VARIANTS[JAX_LOSS.name]


def _chunks(X, y, rows=120):
    return iter([(X[i:i + rows], y[i:i + rows], None) for i in range(0, X.shape[0], rows)])


def _replayable_stream(X, y=None, chunk=60, table=Table, stream=StreamTable):
    batches = []
    for i in range(0, X.shape[0], chunk):
        cols = {"features": X[i:i + chunk]}
        if y is not None:
            cols["label"] = y[i:i + chunk]
        batches.append(table(cols))
    return stream.from_batches(batches)


# ---------------------------------------------------------------------------
# the checkpointed fit is the whole fit, cut at the boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_name", ["binary_logistic", "hinge", "least_square"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("interval", [1, 5])
def test_checkpointed_fit_equals_the_unchecked_whole_fit(tmp_path, loss_name, sparse, interval):
    if sparse:
        X, y, d = _sparse_problem()
        loss = losses.sparse_variant(loss_name)
    else:
        X, y = _dense_problem()
        d = X.shape[1]
        loss = {"binary_logistic": losses.BINARY_LOGISTIC_LOSS, "hinge": losses.HINGE_LOSS,
                "least_square": losses.LEAST_SQUARE_LOSS}[loss_name]
    kw = dict(reg=0.05, elastic_net=0.5)
    want = _sgd(**kw).optimize(np.zeros(d), X, y, None, loss)
    got = _sgd(str(tmp_path), checkpoint_interval=interval, **kw).optimize(
        np.zeros(d), X, y, None, loss)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("interval", [1, 4, 50])
def test_a_tol_stop_inside_a_chunk_stops_at_the_jax_epoch(tmp_path, interval):
    X, y = _dense_problem(seed=9)
    tol = 0.45  # fires at epoch 26
    want = _sgd(max_iter=50, tol=tol).optimize(np.zeros(8), X, y, None, LOSS)
    got = _sgd(str(tmp_path / "p"), max_iter=50, tol=tol, checkpoint_interval=interval).optimize(
        np.zeros(8), X, y, None, LOSS)
    ref = _jax_sgd(str(tmp_path / "j"), max_iter=50, tol=tol, checkpoint_interval=interval).optimize(
        np.zeros(8), X, y, None, JAX_LOSS)
    assert 1 < got[2] < 50
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[2] == ref[2]
    np.testing.assert_allclose(got[0], ref[0], **SGD_TOL)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_checkpointed_fit_matches_the_jax_checkpointed_fit(tmp_path, sparse):
    if sparse:
        X, y, d = _sparse_problem(seed=2)
        port_loss, jax_loss = SPARSE_LOSS, JAX_SPARSE_LOSS
    else:
        X, y = _dense_problem(seed=2)
        d, port_loss, jax_loss = 8, LOSS, JAX_LOSS
    got = _sgd(str(tmp_path / "p"), checkpoint_interval=3).optimize(np.zeros(d), X, y, None, port_loss)
    ref = _jax_sgd(str(tmp_path / "j"), checkpoint_interval=3).optimize(np.zeros(d), X, y, None,
                                                                      jax_loss)
    assert got[2] == ref[2] == 12
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), **SGD_TOL)


# ---------------------------------------------------------------------------
# dense and sparse SGD: kill at a chunk boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kill_after", [2, 7])
def test_dense_sgd_kill_resume_bit_identical(tmp_path, kill_after):
    X, y = _dense_problem()
    expected, _, _ = _sgd(str(tmp_path / "ref")).optimize(np.zeros(8), X, y, None, LOSS)
    ckpt = str(tmp_path / "kill")
    with faults.inject("chunk", after=kill_after) as plan:
        with pytest.raises(InjectedFault):
            _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert plan.fired and plan.hits == kill_after
    got, _, epochs = _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("hosts", [None, 4])
def test_sparse_sgd_kill_resume_bit_identical(tmp_path, hosts):
    Xs, y, d = _sparse_problem()
    expected, _, _ = _sgd(str(tmp_path / "ref")).optimize(np.zeros(d), Xs, y, None, SPARSE_LOSS)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(hosts):
        with faults.inject("chunk", after=5):
            with pytest.raises(InjectedFault):
                _sgd(ckpt).optimize(np.zeros(d), Xs, y, None, SPARSE_LOSS)
        got, _, epochs = _sgd(ckpt).optimize(np.zeros(d), Xs, y, None, SPARSE_LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_sgd_checkpoint_resume_exact(tmp_path):
    X, y = _dense_problem(n=1000, seed=0)
    expected, _, _ = SGD(max_iter=20, global_batch_size=100, tol=0.0).optimize(
        np.zeros(8), X, y, None, LOSS)
    ckpt = str(tmp_path / "ckpt")
    with pytest.warns(UserWarning, match="un-keyed"):
        SGD(max_iter=7, global_batch_size=100, tol=0.0, checkpoint_dir=ckpt).optimize(
            np.zeros(8), X, y, None, LOSS)
        got, _, epochs = SGD(max_iter=20, global_batch_size=100, tol=0.0,
                             checkpoint_dir=ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert epochs == 20
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("estimator", ["LogisticRegression", "LinearSVC", "LinearRegression"])
def test_estimator_level_checkpointing(tmp_path, estimator):
    from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
    from flink_ml_tpu_torch.models.regression.linearregression import LinearRegression

    cls = {"LogisticRegression": LogisticRegression, "LinearSVC": LinearSVC,
           "LinearRegression": LinearRegression}[estimator]
    X, y = _dense_problem(n=1000, seed=0)
    t = Table({"features": X.astype(np.float64), "label": y.astype(np.float64)})

    def est(max_iter):
        return cls().set_max_iter(max_iter).set_global_batch_size(100).set_tol(0.0)

    expected = est(15).fit(t).coefficient
    ckpt = str(tmp_path / "est_ckpt")
    with config.iteration_checkpointing(ckpt):
        est(5).fit(t)
        model = est(15).fit(t)
        assert [n.startswith(f"snap-{estimator}-") for n in os.listdir(ckpt)] == [True]
    np.testing.assert_array_equal(model.coefficient, expected)
    assert config.iteration_checkpoint_dir is None


def test_corrupt_checkpoint_is_not_a_fresh_start(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "ckpt.npz"), "wb") as f:
        f.write(b"not a checkpoint")
    X, y = _dense_problem()
    with pytest.raises(Exception):
        SGD(max_iter=3, global_batch_size=96, tol=0.0, checkpoint_dir=ckpt).optimize(
            np.zeros(8), X, y, None, LOSS)


# ---------------------------------------------------------------------------
# resumes across packages (the same files, both ways)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [None, 4])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("killer", ["jax", "port"])
def test_a_fit_killed_in_one_package_resumes_in_the_other(tmp_path, killer, sparse, hosts):
    if sparse:
        X, y, d = _sparse_problem(seed=3)
        port_loss, jax_loss = SPARSE_LOSS, JAX_SPARSE_LOSS
    else:
        X, y = _dense_problem(seed=3)
        d, port_loss, jax_loss = 8, LOSS, JAX_LOSS
    expected, _, _ = _jax_sgd().optimize(np.zeros(d), X, y, None, jax_loss)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(hosts), jax_config.snapshot_hosts_mode(hosts):
        if killer == "jax":
            with jax_faults.inject("chunk", after=5):
                with pytest.raises(jax_faults.InjectedFault):
                    _jax_sgd(ckpt).optimize(np.zeros(d), X, y, None, jax_loss)
            restores = metrics.get_counter("checkpoint.restore.count")
            got, _, epochs = _sgd(ckpt).optimize(np.zeros(d), X, y, None, port_loss)
            assert metrics.get_counter("checkpoint.restore.count") == restores + 1
        else:
            with faults.inject("chunk", after=5):
                with pytest.raises(InjectedFault):
                    _sgd(ckpt).optimize(np.zeros(d), X, y, None, port_loss)
            got, _, epochs = _jax_sgd(ckpt).optimize(np.zeros(d), X, y, None, jax_loss)
    assert epochs == 12
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), **SGD_TOL)


# ---------------------------------------------------------------------------
# stream SGD
# ---------------------------------------------------------------------------

def test_stream_sgd_failing_map_record_kill_then_rerun(tmp_path):
    X, y = _dense_problem(n=480)
    expected, _, _, _ = _sgd(max_iter=8).optimize_stream(None, _chunks(X, y), LOSS)
    ckpt = str(tmp_path / "stream")
    with pytest.raises(InjectedFault):
        _sgd(ckpt, max_iter=8).optimize_stream(
            None, faults.failing_map(_chunks(X, y), after_records=300), LOSS)
    got, _, _, _ = _sgd(ckpt, max_iter=8).optimize_stream(None, _chunks(X, y), LOSS)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("interval", [1, 3])
def test_stream_sgd_epoch_kill_resume_bit_identical(tmp_path, interval):
    X, y = _dense_problem(n=480)
    expected, _, _, _ = _sgd(max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
    ckpt = str(tmp_path / "stream")
    with faults.inject("epoch", after=4):
        with pytest.raises(InjectedFault):
            _sgd(ckpt, max_iter=10, checkpoint_interval=interval).optimize_stream(
                None, _chunks(X, y), LOSS)
    got, _, epochs, _ = _sgd(ckpt, max_iter=10, checkpoint_interval=interval).optimize_stream(
        None, _chunks(X, y), LOSS)
    assert epochs == 10
    np.testing.assert_array_equal(got, expected)


def test_stream_sgd_equals_its_jax_twin_killed_and_resumed(tmp_path):
    X, y = _dense_problem(n=480, seed=4)
    ref, _, ref_epochs, _ = _jax_sgd(max_iter=10).optimize_stream(None, _chunks(X, y), JAX_LOSS)
    ckpt = str(tmp_path / "stream")
    with faults.inject("epoch", after=4):
        with pytest.raises(InjectedFault):
            _sgd(ckpt, max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
    got, _, epochs, _ = _sgd(ckpt, max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
    assert epochs == ref_epochs == 10
    np.testing.assert_allclose(got, np.asarray(ref), **SGD_TOL)


@pytest.mark.parametrize("killer", ["jax", "port"])
def test_mh_stream_sgd_kill_resumes_without_reingest(tmp_path, killer):
    """Stream SGD with the cache's contents in the sharded cut: the
    resumed fit is fed an EMPTY stream. Port to port bit for bit; across
    packages within the SGD tolerance of the unkilled JAX fit."""
    X, y = _dense_problem(n=480)
    expected, _, _, _ = _sgd(max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
    jax_expected, _, _, _ = _jax_sgd(max_iter=10).optimize_stream(None, _chunks(X, y), JAX_LOSS)
    ckpt = str(tmp_path / "stream")
    with config.snapshot_hosts_mode(4), jax_config.snapshot_hosts_mode(4):
        if killer == "port":
            with faults.inject("snapshot.shard.write", after=4 * 3 + 2):
                with pytest.raises(InjectedFault):
                    _sgd(ckpt, max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
        else:
            with jax_faults.inject("epoch", after=4):
                with pytest.raises(jax_faults.InjectedFault):
                    _jax_sgd(ckpt, max_iter=10).optimize_stream(None, _chunks(X, y), JAX_LOSS)
        before = metrics.get_counter("devicecache.contents.restored", 0)
        got, _, epochs, stats = _sgd(ckpt, max_iter=10).optimize_stream(None, iter([]), LOSS)
        assert metrics.get_counter("devicecache.contents.restored", 0) == before + 5
        assert stats["restoredCache"] and epochs == 10
        if killer == "port":
            np.testing.assert_array_equal(got, expected)
            # and the JAX package resumes the port's cut the same way
            jax_got, _, _, _ = _jax_sgd(ckpt, max_iter=10).optimize_stream(
                None, iter([]), JAX_LOSS)
            np.testing.assert_allclose(np.asarray(jax_got), np.asarray(jax_expected), **SGD_TOL)
        else:
            np.testing.assert_allclose(got, np.asarray(jax_expected), **SGD_TOL)


def test_a_sharded_stream_fit_writes_its_cache_section_once(tmp_path):
    """ROADMAP C.22: the port keeps the stream cache's stable section from
    cut to cut of one fit (only the moving cursors differ); the JAX
    package's same-job guard compares `cacheCursor` too, so it writes the
    section again at every cut. The cuts restore the same either way."""
    from flink_ml_tpu.utils import metrics as jax_metrics

    X, y = _dense_problem(n=480, seed=7)
    writes = {}
    with config.snapshot_hosts_mode(2), jax_config.snapshot_hosts_mode(2):
        for pkg, fit, reg in (("port", _sgd, metrics), ("jax", _jax_sgd, jax_metrics)):
            before = reg.get_counter("checkpoint.stable.reused", 0)
            loss = LOSS if pkg == "port" else JAX_LOSS
            fit(str(tmp_path / pkg), max_iter=6, checkpoint_interval=1).optimize_stream(
                None, _chunks(X, y), loss)
            writes[pkg] = reg.get_counter("checkpoint.stable.reused", 0) - before
        got, _, _, stats = _sgd(str(tmp_path / "jax"), max_iter=9).optimize_stream(
            None, iter([]), LOSS)
    assert writes == {"port": 5, "jax": 0}  # 6 cuts: written once, then named 5 times
    assert stats["restoredCache"]
    want, _, _, _ = _sgd(max_iter=9).optimize_stream(None, _chunks(X, y), LOSS)
    np.testing.assert_allclose(got, want, **SGD_TOL)


def test_mh_stream_sgd_model_cut_bit_rot_falls_back_bit_identical(tmp_path):
    X, y = _dense_problem(n=480, seed=3)
    expected, _, _, _ = _sgd(max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
    ckpt = str(tmp_path / "stream")
    with config.snapshot_hosts_mode(4):
        with faults.inject("epoch", after=6):
            with pytest.raises(InjectedFault):
                _sgd(ckpt, max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
        newest = coordinator.committed_cuts(ckpt, "fault")[-1]
        with open(coordinator.shard_file(ckpt, "fault", newest, 1), "r+b") as f:
            f.seek(40)
            f.write(b"\xde\xad\xbe\xef")
        with pytest.warns(UserWarning, match="mismatch"):
            got, _, epochs, _ = _sgd(ckpt, max_iter=10).optimize_stream(None, iter([]), LOSS)
    assert epochs == 10
    np.testing.assert_array_equal(got, expected)


def test_mh_stream_sgd_corrupt_stable_cache_shard_fails_loudly(tmp_path):
    X, y = _dense_problem(n=480, seed=5)
    ckpt = str(tmp_path / "stream")
    with config.snapshot_hosts_mode(4):
        with faults.inject("epoch", after=4):
            with pytest.raises(InjectedFault):
                _sgd(ckpt, max_iter=10).optimize_stream(None, _chunks(X, y), LOSS)
        with open(coordinator.stable_shard_file(ckpt, "fault", "cache", 0), "r+b") as f:
            f.seek(40)
            f.write(b"\xde\xad\xbe\xef")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(SnapshotIntegrityError):
                _sgd(ckpt, max_iter=10).optimize_stream(None, iter([]), LOSS)


def test_stream_end_snapshot_resume_extends_max_iter(tmp_path):
    X, y = _dense_problem(n=480)
    expected, _, _, _ = _sgd(max_iter=12).optimize_stream(None, _chunks(X, y), LOSS)
    ckpt = str(tmp_path / "stream_end")
    _sgd(ckpt, max_iter=6, key="swf", checkpoint_interval=6).optimize_stream(
        None, _chunks(X, y), LOSS)
    got = _sgd(ckpt, max_iter=12, key="swf", checkpoint_interval=12).optimize_stream(
        None, _chunks(X, y), LOSS)
    assert got[2] == 12
    np.testing.assert_array_equal(got[0], expected)


def test_flaky_datacache_read_inside_stream_fit_bit_identical(tmp_path):
    X, y = _dense_problem(n=480, seed=6)
    clean, _, _, _ = _sgd(max_iter=6).optimize_stream(None, _chunks(X, y), LOSS)
    with config.transient_retry_mode(4):
        with faults.flaky("datacache.read", times=3) as plan:
            got, _, _, _ = _sgd(max_iter=6).optimize_stream(None, _chunks(X, y), LOSS)
    assert plan.failures == 3
    np.testing.assert_array_equal(got, clean)
    with config.transient_retry_mode(0):
        with faults.flaky("datacache.read", times=1):
            with pytest.raises(TransientFault):
                _sgd(max_iter=6).optimize_stream(None, _chunks(X, y), LOSS)


def test_flaky_datacache_append_appends_once(tmp_path):
    from flink_ml_tpu_torch.native.datacache import DataCache

    cache = DataCache(1 << 20, str(tmp_path))
    try:
        with config.transient_retry_mode(3):
            with faults.flaky("datacache.append", times=2) as plan:
                seg = cache.append_array(np.arange(6.0))
        assert plan.failures == 2 and seg == 0 and cache.num_segments == 1
        np.testing.assert_array_equal(cache.read_array(0), np.arange(6.0))
        with faults.inject("datacache.append"):
            with pytest.raises(InjectedFault):
                cache.append_array(np.ones(2))
        assert cache.num_segments == 1
    finally:
        cache.close()


# ---------------------------------------------------------------------------
# whole-fit cadences (a snapshot only at the fit's end)
# ---------------------------------------------------------------------------

def test_fit_end_snapshot_kill_resumes_bit_identical(tmp_path):
    X, y = _dense_problem()
    expected, _, _ = _sgd(str(tmp_path / "ref"), key="wf", checkpoint_interval=12).optimize(
        np.zeros(8), X, y, None, LOSS)
    ckpt = str(tmp_path / "kill")
    with faults.inject("chunk", after=1) as plan:
        with pytest.raises(InjectedFault):
            _sgd(ckpt, key="wf", checkpoint_interval=12).optimize(np.zeros(8), X, y, None, LOSS)
    assert plan.fired
    got, _, epochs = _sgd(ckpt, key="wf", checkpoint_interval=12).optimize(
        np.zeros(8), X, y, None, LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_fit_end_snapshot_resume_extends_max_iter(tmp_path):
    X, y = _dense_problem()
    expected, _, _ = _sgd(str(tmp_path / "ref"), key="wf", checkpoint_interval=12).optimize(
        np.zeros(8), X, y, None, LOSS)
    ckpt = str(tmp_path / "resume")
    _sgd(ckpt, max_iter=6, key="wf", checkpoint_interval=6).optimize(np.zeros(8), X, y, None, LOSS)
    got, _, epochs = _sgd(ckpt, key="wf", checkpoint_interval=12).optimize(
        np.zeros(8), X, y, None, LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


# ---------------------------------------------------------------------------
# the sharded chaos matrix on dense SGD
# ---------------------------------------------------------------------------

def _dense_ref(tmp_path):
    X, y = _dense_problem()
    expected, _, _ = _sgd(str(tmp_path / "ref")).optimize(np.zeros(8), X, y, None, LOSS)
    return X, y, expected


def test_mh_dense_kill_mid_shard_write_resume_bit_identical(tmp_path):
    X, y, expected = _dense_ref(tmp_path)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(4):
        with faults.inject("snapshot.shard.write", after=4 * 4 + 3) as plan:
            with pytest.raises(InjectedFault):
                _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
        assert plan.fired
        got, _, epochs = _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_mh_dense_kill_mid_manifest_commit_resume_bit_identical(tmp_path):
    X, y, expected = _dense_ref(tmp_path)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(4):
        with faults.inject("snapshot.commit", after=5) as plan:
            with pytest.raises(InjectedFault):
                _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
        assert plan.fired and 5 not in coordinator.committed_cuts(ckpt, "fault")
        got, _, epochs = _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_mh_dense_straggler_abort_then_kill_resume_bit_identical(tmp_path):
    X, y, expected = _dense_ref(tmp_path)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(4), config.transient_retry_mode(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with faults.flaky("snapshot.shard.write", times=3):
                with faults.inject("chunk", after=4):
                    with pytest.raises(InjectedFault):
                        _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
        assert any("aborted" in str(w.message) for w in caught)
        got, _, epochs = _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_mh_dense_digest_mismatch_falls_back_resume_bit_identical(tmp_path):
    X, y, expected = _dense_ref(tmp_path)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(4):
        with faults.inject("chunk", after=7):
            with pytest.raises(InjectedFault):
                _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
        newest = coordinator.committed_cuts(ckpt, "fault")[-1]
        with open(coordinator.shard_file(ckpt, "fault", newest, 0), "r+b") as f:
            f.seek(40)
            f.write(b"\xde\xad\xbe\xef")
        mismatches = metrics.get_counter("checkpoint.digest.mismatch", 0)
        with pytest.warns(UserWarning, match="mismatch"):
            got, _, epochs = _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
        assert metrics.get_counter("checkpoint.digest.mismatch", 0) == mismatches + 1
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_mh_dense_flaky_reads_on_resume_bit_identical(tmp_path):
    X, y, expected = _dense_ref(tmp_path)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(4):
        with faults.inject("chunk", after=6):
            with pytest.raises(InjectedFault):
                _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
        with config.transient_retry_mode(3):
            with faults.flaky("snapshot.shard.read", times=2) as plan:
                got, _, epochs = _sgd(ckpt).optimize(np.zeros(8), X, y, None, LOSS)
    assert plan.failures == 2 and epochs == 12
    np.testing.assert_array_equal(got, expected)


def test_mh_sparse_sgd_kill_mid_commit_resume_bit_identical(tmp_path):
    Xs, y, d = _sparse_problem()
    expected, _, _ = _sgd(str(tmp_path / "ref")).optimize(np.zeros(d), Xs, y, None, SPARSE_LOSS)
    ckpt = str(tmp_path / "kill")
    with config.snapshot_hosts_mode(4):
        with faults.inject("snapshot.commit", after=5):
            with pytest.raises(InjectedFault):
                _sgd(ckpt).optimize(np.zeros(d), Xs, y, None, SPARSE_LOSS)
        got, _, epochs = _sgd(ckpt).optimize(np.zeros(d), Xs, y, None, SPARSE_LOSS)
    assert epochs == 12
    np.testing.assert_array_equal(got, expected)


# ---------------------------------------------------------------------------
# snapshot I/O faults
# ---------------------------------------------------------------------------

def _save_snap(path, epoch, scale=1.0, key="flaky"):
    return port_snapshot.save_job_snapshot(
        str(path), key, {"model": (np.full(4, scale), torch.full((4,), scale))}, epoch=epoch)


def _load_snap(path, key="flaky"):
    return port_snapshot.load_job_snapshot(
        str(path), key, templates={"model": (np.zeros(4), np.zeros(4, np.float32))})


def test_flaky_snapshot_read_retried_to_success(tmp_path):
    _save_snap(tmp_path, epoch=5)
    before = metrics.get_counter("flow.retry.snapshot.read", 0)
    with config.transient_retry_mode(3):
        with faults.flaky("snapshot.read", times=2) as plan:
            got = _load_snap(tmp_path)
    assert plan.failures == 2 and got.epoch == 5
    np.testing.assert_array_equal(got.sections["model"][0], np.full(4, 1.0))
    assert metrics.get_counter("flow.retry.snapshot.read", 0) == before + 2


def test_flaky_snapshot_read_budget_exhausted_reraises_original(tmp_path):
    _save_snap(tmp_path, epoch=3)
    with config.transient_retry_mode(2):
        with faults.flaky("snapshot.read", times=10):
            with pytest.raises(TransientFault) as ei:
                _load_snap(tmp_path)
    assert ei.value.site == "snapshot.read" and ei.value.retry_attempts == 3


def test_flaky_snapshot_write_retried_then_readable(tmp_path):
    with config.transient_retry_mode(3):
        with faults.flaky("snapshot.write", times=2) as plan:
            _save_snap(tmp_path, epoch=7, scale=2.5)
    assert plan.failures == 2
    got = _load_snap(tmp_path)
    assert got.epoch == 7
    np.testing.assert_array_equal(got.sections["model"][1], np.full(4, 2.5, np.float32))
    with config.transient_retry_mode(1):
        with faults.flaky("snapshot.write", times=5):
            with pytest.raises(TransientFault) as ei:
                _save_snap(tmp_path, epoch=8)
    assert ei.value.retry_attempts == 2


def test_midwrite_kill_then_flaky_reads_still_restore_previous(tmp_path):
    _save_snap(tmp_path, epoch=4, scale=1.0)
    with faults.inject("snapshot.write", after=1):
        with pytest.raises(InjectedFault):
            _save_snap(tmp_path, epoch=9, scale=9.0)
    with config.transient_retry_mode(3):
        with faults.flaky("snapshot.read", times=2) as plan:
            got = _load_snap(tmp_path)
    assert plan.failures == 2 and got.epoch == 4
    np.testing.assert_array_equal(got.sections["model"][0], np.full(4, 1.0))


def test_injected_write_kill_not_retried(tmp_path):
    with config.transient_retry_mode(10):
        with faults.inject("snapshot.write", after=1) as plan:
            with pytest.raises(InjectedFault):
                _save_snap(tmp_path, epoch=1)
    assert plan.hits == 1


# ---------------------------------------------------------------------------
# out-of-core KMeans
# ---------------------------------------------------------------------------

def _kmeans_data():
    rng = np.random.RandomState(7)
    X = np.concatenate([rng.randn(200, 4) + 3.0, rng.randn(200, 4) - 3.0])
    rng.shuffle(X)
    return X


def _port_kmeans():
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

    return KMeans().set_k(3).set_seed(11).set_max_iter(6)


@pytest.mark.parametrize("site,after,hosts", [("epoch", 3, None), ("epoch", 5, 4),
                                               ("snapshot.commit", 3, 4),
                                               ("snapshot.write", 2, None)])
def test_kmeans_out_of_core_kill_resume_bit_identical(tmp_path, site, after, hosts):
    X = _kmeans_data()
    full = _port_kmeans().fit(_replayable_stream(X, chunk=80))
    ckpt = str(tmp_path / "km")
    with config.iteration_checkpointing(ckpt), config.snapshot_hosts_mode(hosts):
        with faults.inject(site, after=after):
            with pytest.raises(InjectedFault):
                _port_kmeans().fit(_replayable_stream(X, chunk=80))
        resumed = _port_kmeans().fit(_replayable_stream(X, chunk=80))
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    np.testing.assert_array_equal(resumed.weights, full.weights)


def test_kmeans_out_of_core_resumes_a_jax_snapshot(tmp_path):
    from flink_ml_tpu.models.clustering.kmeans import KMeans as JaxKMeans

    X = _kmeans_data()
    ref = JaxKMeans().set_k(3).set_seed(11).set_max_iter(6).fit(
        _replayable_stream(X, chunk=80, table=JaxTable, stream=JaxStreamTable))
    ckpt = str(tmp_path / "km")
    with jax_config.iteration_checkpointing(ckpt), config.iteration_checkpointing(ckpt):
        with jax_faults.inject("epoch", after=3):
            with pytest.raises(jax_faults.InjectedFault):
                JaxKMeans().set_k(3).set_seed(11).set_max_iter(6).fit(
                    _replayable_stream(X, chunk=80, table=JaxTable, stream=JaxStreamTable))
        restores = metrics.get_counter("checkpoint.restore.count")
        got = _port_kmeans().fit(_replayable_stream(X, chunk=80))
        assert metrics.get_counter("checkpoint.restore.count") == restores + 1
    np.testing.assert_allclose(got.centroids, ref.centroids, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.weights, ref.weights)


# ---------------------------------------------------------------------------
# the online estimators
# ---------------------------------------------------------------------------

def _olr(pkg="port"):
    if pkg == "jax":
        from flink_ml_tpu.models.classification.onlinelogisticregression import (
            OnlineLogisticRegression,
        )

        init = JaxTable({"coefficient": [JaxDenseVector(np.zeros(8))]})
    else:
        from flink_ml_tpu_torch.models.classification.onlinelogisticregression import (
            OnlineLogisticRegression,
        )

        init = Table({"coefficient": [DenseVector(np.zeros(8))]})
    return OnlineLogisticRegression().set_global_batch_size(100).set_reg(0.1) \
        .set_elastic_net(0.5).set_initial_model_data(init)


def _olr_stream(X, y, pkg="port"):
    if pkg == "jax":
        return _replayable_stream(X, y, table=JaxTable, stream=JaxStreamTable)
    return _replayable_stream(X, y)


@pytest.mark.parametrize("after", [1, 3, 5])
def test_online_lr_batch_kill_resume_bit_identical(tmp_path, after):
    X, y = _dense_problem(n=600, seed=2)
    full = _olr().fit(_olr_stream(X, y))
    full.process_updates()
    assert full.model_version == 6
    ckpt = str(tmp_path / "online")
    with config.iteration_checkpointing(ckpt):
        part = _olr().fit(_olr_stream(X, y))
        with faults.inject("batch", after=after):
            with pytest.raises(InjectedFault):
                part.process_updates()
        assert part.model_version == after - 1
        res = _olr().fit(_olr_stream(X, y))
        assert res.process_updates(max_batches=1) == after  # the republished version
        res.process_updates()
    assert res.model_version == 6
    np.testing.assert_array_equal(res.coefficient, full.coefficient)
    assert os.listdir(ckpt) == []  # a completed stream clears its snapshot


def test_online_lr_checkpoint_resume_and_republish(tmp_path):
    X, y = _dense_problem(n=600, seed=1)
    full = _olr().fit(_olr_stream(X, y))
    full.process_updates()
    ckpt = str(tmp_path / "online_lr")
    with config.iteration_checkpointing(ckpt):
        part = _olr().fit(_olr_stream(X, y))
        part.process_updates(max_batches=4)
        res = _olr().fit(_olr_stream(X, y))
        res.process_updates(max_batches=1)
        assert res.model_version == 4
        np.testing.assert_array_equal(res.coefficient, part.coefficient)
        res.process_updates()
    assert res.model_version == 6
    np.testing.assert_array_equal(res.coefficient, full.coefficient)


@pytest.mark.parametrize("killer", ["jax", "port"])
def test_online_lr_resumes_across_packages(tmp_path, killer):
    X, y = _dense_problem(n=600, seed=5)
    ref = _olr("jax").fit(_olr_stream(X, y, "jax"))
    ref.process_updates()
    resumer = "port" if killer == "jax" else "jax"
    ckpt = str(tmp_path / "online")
    with config.iteration_checkpointing(ckpt), jax_config.iteration_checkpointing(ckpt):
        part = _olr(killer).fit(_olr_stream(X, y, killer))
        part.process_updates(max_batches=3)
        res = _olr(resumer).fit(_olr_stream(X, y, resumer))
        res.process_updates(max_batches=1)
        assert res.model_version == 3
        np.testing.assert_allclose(res.coefficient, part.coefficient, rtol=1e-6, atol=1e-7)
        res.process_updates()
    assert res.model_version == 6
    np.testing.assert_allclose(res.coefficient, ref.coefficient, rtol=1e-5, atol=1e-6)


def test_online_kmeans_checkpoint_resume(tmp_path):
    from flink_ml_tpu_torch.models.clustering.onlinekmeans import (
        OnlineKMeans,
        generate_random_model_data,
    )

    rng = np.random.RandomState(7)
    X = np.concatenate([rng.randn(300, 4) + 3.0, rng.randn(300, 4) - 3.0])
    rng.shuffle(X)
    init = generate_random_model_data(k=2, dim=4, weight=1.0, seed=0)

    def est():
        return OnlineKMeans().set_global_batch_size(150).set_decay_factor(0.5) \
            .set_initial_model_data(init)

    full = est().fit(_replayable_stream(X, chunk=90))
    full.process_updates()
    assert full.model_version == 4
    ckpt = str(tmp_path / "online_km")
    with config.iteration_checkpointing(ckpt):
        part = est().fit(_replayable_stream(X, chunk=90))
        with faults.inject("batch", after=3):
            with pytest.raises(InjectedFault):
                part.process_updates()
        res = est().fit(_replayable_stream(X, chunk=90))
        res.process_updates()
    assert res.model_version == 4
    np.testing.assert_array_equal(res.centroids, full.centroids)
    np.testing.assert_array_equal(res.weights, full.weights)


def test_unbounded_explicit_interval_wins_over_config(tmp_path):
    from flink_ml_tpu_torch.parallel.iteration import iterate_unbounded

    ckpt = str(tmp_path / "interval")
    with config.iteration_checkpointing(ckpt, interval=1):
        seen = []
        for version, _ in iterate_unbounded(iter([1.0, 2.0, 3.0]), lambda s, b: s + b, 0.0,
                                            checkpoint_interval=5, job_key="job-x"):
            seen.append(version)
            assert not os.path.isdir(ckpt) or not os.listdir(ckpt)
    assert seen == [1, 2, 3]


# ---------------------------------------------------------------------------
# the lifecycle
# ---------------------------------------------------------------------------

def _olr_model(pkg="port", coeff=None):
    if pkg == "jax":
        from flink_ml_tpu.models.classification.onlinelogisticregression import (
            OnlineLogisticRegressionModel,
        )
    else:
        from flink_ml_tpu_torch.models.classification.onlinelogisticregression import (
            OnlineLogisticRegressionModel,
        )
    m = OnlineLogisticRegressionModel()
    m.publish_model_arrays((np.zeros(6) if coeff is None else coeff,), 0)
    return m


@pytest.mark.parametrize("hosts", [None, 3])
def test_lifecycle_kill_during_promote_resume_republishes_same_version(tmp_path, hosts):
    from flink_ml_tpu_torch.lifecycle import ModelLifecycle

    ckpt = str(tmp_path / "lifecycle")
    with config.snapshot_hosts_mode(hosts):
        model = _olr_model()
        lc = ModelLifecycle(model, checkpoint_dir=ckpt, job_key="tws-kill")
        lc.promote((np.full(6, 0.5),))
        lc.record_serve_ok()
        killed = np.linspace(-1.0, 1.0, 6) / 3.0
        with faults.inject("lifecycle.swap", after=1):
            with pytest.raises(InjectedFault):
                lc.promote((killed,))
        assert model.model_version == 1
        resumed = _olr_model()
        lc2 = ModelLifecycle(resumed, checkpoint_dir=ckpt, job_key="tws-kill")
    assert resumed.model_version == 2
    np.testing.assert_array_equal(resumed.coefficient, killed)
    assert lc2.last_good == 1 and lc2.current.source == "restore"
    assert [e.kind for e in lc2.events] == ["restored"]
    with config.snapshot_hosts_mode(hosts):
        assert lc2.promote((np.full(6, 1.0),)).version_id == 3


def test_lifecycle_rollback_is_persisted(tmp_path):
    from flink_ml_tpu_torch.lifecycle import ModelLifecycle

    ckpt = str(tmp_path / "lifecycle")
    model = _olr_model()
    lc = ModelLifecycle(model, checkpoint_dir=ckpt, job_key="rb")
    lc.promote((np.full(6, 0.5),))
    lc.record_serve_ok()
    lc.promote((np.full(6, 0.7),))
    lc.rollback("manual")
    resumed = _olr_model()
    ModelLifecycle(resumed, checkpoint_dir=ckpt, job_key="rb")
    assert resumed.model_version == 1
    np.testing.assert_array_equal(resumed.coefficient, np.full(6, 0.5))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_lifecycle_restores_the_other_packages_persisted_version(tmp_path, writer, reader):
    from flink_ml_tpu import lifecycle as jax_lifecycle
    from flink_ml_tpu_torch import lifecycle as port_lifecycle

    lib = {"jax": jax_lifecycle, "port": port_lifecycle}
    ckpt = str(tmp_path / "lifecycle")
    lc = lib[writer].ModelLifecycle(_olr_model(writer), checkpoint_dir=ckpt, job_key="x")
    lc.promote((np.full(6, 0.25),))
    lc.record_serve_ok()
    lc.promote((np.linspace(0, 1, 6),), version=7)
    resumed = _olr_model(reader)
    lc2 = lib[reader].ModelLifecycle(resumed, checkpoint_dir=ckpt, job_key="x")
    assert resumed.model_version == 7 and lc2.last_good == 1
    np.testing.assert_array_equal(resumed.coefficient, np.linspace(0, 1, 6))


def test_a_restored_lifecycle_serves_its_version(tmp_path):
    from flink_ml_tpu_torch.lifecycle import ModelLifecycle

    ckpt = str(tmp_path / "lifecycle")
    coeff = np.linspace(-1, 1, 6)
    lc = ModelLifecycle(_olr_model(), checkpoint_dir=ckpt, job_key="serve")
    lc.promote((coeff,))
    resumed = _olr_model()
    resumed.set_features_col("features").set_prediction_col("pred")
    ModelLifecycle(resumed, checkpoint_dir=ckpt, job_key="serve")
    X = np.random.default_rng(3).standard_normal((10, 6))
    out = resumed.transform(Table({"features": torch.as_tensor(X, dtype=torch.float32)}))[0]
    pred = out.column("pred")
    want = (torch.as_tensor(X, dtype=torch.float32) @ torch.as_tensor(coeff, dtype=torch.float32)
            >= 0).to(pred.dtype)
    assert torch.equal(pred, want)
    assert int(out.column(resumed.get_model_version_col())[0]) == 1


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def _fleet_makers(sparse=False):
    from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression

    def lr(max_iter, rate, reg=0.0):
        return LogisticRegression().set_max_iter(max_iter).set_tol(0.0) \
            .set_learning_rate(rate).set_global_batch_size(96).set_reg(reg).set_elastic_net(0.5)

    return [lambda: lr(10, 0.1), lambda: lr(10, 0.02, 0.01), lambda: lr(5, 0.2)]


def _fleet_table(seed, sparse):
    from flink_ml_tpu_torch.table import SparseBatch

    if sparse:
        (idx, val), y, d = _sparse_problem(seed=seed)
        return Table({"features": SparseBatch(d, idx, val), "label": y.astype(np.float64)})
    X, y = _dense_problem(seed=seed)
    return Table({"features": X, "label": y})


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kill_after", [1, 2])
def test_fleet_kill_at_chunk_boundary_resume_bit_identical(tmp_path, kill_after, sparse):
    from flink_ml_tpu_torch.fleet import FitFleet

    table = _fleet_table(31, sparse)
    makers = _fleet_makers()
    expected = FitFleet([m() for m in makers]).fit(table)
    with config.iteration_checkpointing(str(tmp_path / "fleet"), interval=3):
        with faults.inject("chunk", after=kill_after) as plan:
            with pytest.raises(InjectedFault):
                FitFleet([m() for m in makers]).fit(table)
        assert plan.fired
        resumed = FitFleet([m() for m in makers]).fit(table)
    for got, want in zip(resumed, expected):
        np.testing.assert_array_equal(got.coefficient, want.coefficient)


def test_fleet_kill_mid_snapshot_commit_resume_bit_identical(tmp_path):
    from flink_ml_tpu_torch.fleet import FitFleet

    table = _fleet_table(32, False)
    makers = _fleet_makers()
    expected = FitFleet([m() for m in makers]).fit(table)
    with config.iteration_checkpointing(str(tmp_path / "commit"), interval=3), \
            config.snapshot_hosts_mode(4):
        with faults.inject("snapshot.commit", after=2) as plan:
            with pytest.raises(InjectedFault):
                FitFleet([m() for m in makers]).fit(table)
        assert plan.fired
        resumed = FitFleet([m() for m in makers]).fit(table)
    for got, want in zip(resumed, expected):
        np.testing.assert_array_equal(got.coefficient, want.coefficient)


@pytest.mark.parametrize("killer", ["jax", "port"])
def test_fleet_resumes_across_packages(tmp_path, killer):
    from flink_ml_tpu import fleet as jax_fleet
    from flink_ml_tpu.models.classification.logisticregression import (
        LogisticRegression as JaxLR,
    )
    from flink_ml_tpu_torch.fleet import FitFleet

    X, y = _dense_problem(seed=33)

    def jax_members():
        return [JaxLR().set_max_iter(10).set_tol(0.0).set_learning_rate(0.02 * (i + 1))
                .set_global_batch_size(96) for i in range(3)]

    def port_members():
        from flink_ml_tpu_torch.models.classification.logisticregression import (
            LogisticRegression,
        )

        return [LogisticRegression().set_max_iter(10).set_tol(0.0)
                .set_learning_rate(0.02 * (i + 1)).set_global_batch_size(96) for i in range(3)]

    expected = jax_fleet.FitFleet(jax_members()).fit(JaxTable({"features": X, "label": y}))
    assert FitFleet(port_members())._job_key() == jax_fleet.FitFleet(jax_members())._job_key()
    ckpt = str(tmp_path / "fleet")
    with config.iteration_checkpointing(ckpt, interval=3), \
            jax_config.iteration_checkpointing(ckpt, interval=3):
        if killer == "jax":
            with jax_faults.inject("chunk", after=2):
                with pytest.raises(jax_faults.InjectedFault):
                    jax_fleet.FitFleet(jax_members()).fit(JaxTable({"features": X, "label": y}))
            got = FitFleet(port_members()).fit(Table({"features": X, "label": y}))
        else:
            with faults.inject("chunk", after=2):
                with pytest.raises(InjectedFault):
                    FitFleet(port_members()).fit(Table({"features": X, "label": y}))
            got = jax_fleet.FitFleet(jax_members()).fit(JaxTable({"features": X, "label": y}))
    for g, w in zip(got, expected):
        np.testing.assert_allclose(np.asarray(g.coefficient), np.asarray(w.coefficient), **SGD_TOL)


# ---------------------------------------------------------------------------
# the iteration runtime
# ---------------------------------------------------------------------------

def _iteration_body(lib):
    def body(carry, epoch):
        x, s = carry
        x = x + 0.5 * (3.0 - x) + 0.01 * lib.sin(x * epoch)
        return (x, s + epoch), lib.abs(x - 3.0)

    return body


@pytest.mark.parametrize("chunk_size", [None, 1, 3])
@pytest.mark.parametrize("interval", [2, 5])
@pytest.mark.parametrize("tol", [None, 1e-2])
def test_iterate_bounded_kill_resume_and_the_jax_loop(tmp_path, chunk_size, interval, tol):
    import jax.numpy as jnp

    from flink_ml_tpu.parallel import iteration as jax_iteration
    from flink_ml_tpu_torch.parallel import iteration

    init = (torch.tensor(0.0), torch.tensor(0))
    want = iteration.iterate_bounded(_iteration_body(torch), init, 10, tol=tol)
    ckpt = str(tmp_path / "it")
    with faults.inject("chunk", after=2):
        with pytest.raises(InjectedFault):
            iteration.iterate_bounded(_iteration_body(torch), init, 10, tol=tol, checkpoint_dir=ckpt,
                                      checkpoint_interval=interval, chunk_size=chunk_size,
                                      job_key="it")
    got = iteration.iterate_bounded(_iteration_body(torch), init, 10, tol=tol, checkpoint_dir=ckpt,
                                    checkpoint_interval=interval, chunk_size=chunk_size,
                                    job_key="it")
    assert (got.num_epochs, got.final_criteria) == (want.num_epochs, want.final_criteria)
    assert torch.equal(got.carry[0], want.carry[0]) and int(got.carry[1]) == int(want.carry[1])
    ref = jax_iteration.iterate_bounded(_iteration_body(jnp), (jnp.float32(0.0), jnp.int32(0)), 10,
                                        tol=tol, checkpoint_dir=str(tmp_path / "jax"),
                                        checkpoint_interval=interval, chunk_size=chunk_size,
                                        job_key="it")
    assert got.num_epochs == ref.num_epochs
    np.testing.assert_allclose(float(got.carry[0]), float(ref.carry[0]), rtol=1e-6)


def test_iterate_bounded_resumes_a_jax_snapshot(tmp_path):
    import jax.numpy as jnp

    from flink_ml_tpu.parallel import iteration as jax_iteration
    from flink_ml_tpu_torch.parallel import iteration

    ckpt = str(tmp_path)
    jax_iteration.iterate_bounded(_iteration_body(jnp), (jnp.float32(0.0), jnp.int32(0)), 4,
                                  checkpoint_dir=ckpt, checkpoint_interval=2, chunk_size=2,
                                  job_key="x")
    got = iteration.iterate_bounded(_iteration_body(torch), (torch.tensor(0.0),
                                                             torch.tensor(0, dtype=torch.int32)),
                                    10, checkpoint_dir=ckpt, checkpoint_interval=2, job_key="x")
    want = jax_iteration.iterate_bounded(_iteration_body(jnp), (jnp.float32(0.0), jnp.int32(0)), 10)
    assert got.num_epochs == 10
    np.testing.assert_allclose(float(got.carry[0]), float(want.carry[0]), rtol=1e-6)
    assert int(got.carry[1]) == int(want.carry[1])


def test_a_listener_and_checkpoints_resume_together(tmp_path):
    """A listener forces the host-driven loop; with a checkpoint directory
    it snapshots every `checkpoint_interval` epochs and resumes, each
    resumed epoch reported to the listener once."""
    from flink_ml_tpu_torch.parallel import iteration

    class Seen(iteration.IterationListener):
        def __init__(self):
            self.epochs = []

        def on_epoch_watermark_incremented(self, epoch, carry):
            self.epochs.append(epoch)

    init = (torch.tensor(0.0), torch.tensor(0))
    want = iteration.iterate_bounded(_iteration_body(torch), init, 8, listener=Seen())
    ckpt = str(tmp_path)
    with faults.inject("chunk", after=5):
        with pytest.raises(InjectedFault):
            iteration.iterate_bounded(_iteration_body(torch), init, 8, listener=Seen(),
                                      checkpoint_dir=ckpt, checkpoint_interval=2, job_key="l")
    seen = Seen()
    got = iteration.iterate_bounded(_iteration_body(torch), init, 8, listener=seen,
                                    checkpoint_dir=ckpt, checkpoint_interval=2, job_key="l")
    assert seen.epochs == [5, 6, 7, 8] and got.num_epochs == 8
    assert torch.equal(got.carry[0], want.carry[0]) and int(got.carry[1]) == int(want.carry[1])
