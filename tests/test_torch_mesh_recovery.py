"""Sharded stream fits, checkpointed fits on a mesh of ranks and the
supervisor's shrink over ranks in flink_ml_tpu_torch, against the port's
one-rank fits and the JAX package's fits on its R-device CPU mesh: the
mesh cases of tests/test_stream_training.py, tests/test_multihost_snapshot.py
and tests/test_supervisor.py.

The module opens one world of 2 and one of 4 gloo ranks on the CPU for the
fits; each supervised run (`supervisor.supervise_world`) launches its own
worlds, as the supervisor does, with a 3 s collective timeout so a hung
host is seen in seconds. Held to:

- a stream fit on R ranks (each rank caching its rows of every batch):
  LR within rtol 2e-5 / atol 2e-6 of the one-rank stream fit and of the
  JAX stream fit on R devices (tests/test_torch_mesh.py's sharded-fit
  tolerance), KMeans centroids within rtol 1e-5 / atol 1e-6 and the
  counts equal; every rank ends with the same model bit for bit;
- a checkpointed fit or stream fit on ranks killed and resumed on the
  same rank count equals the unkilled fit bit for bit; a cut resumed on
  another rank count is within the sharded-fit tolerance of it, the same
  epochs;
- the supervisor: a hung host readmitted resumes bit for bit; a dead host
  quarantined shrinks the world to the surviving ranks, whose resume is
  within the sharded-fit tolerance of the unkilled fit (the JAX package's
  tests/test_supervisor.py:1-12 contract), on the data mesh and on a 2D
  mesh.
"""

import jax
import numpy as np
import pytest

from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu_torch import StreamTable, Table, config
from flink_ml_tpu_torch.ckpt import coordinator
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import launcher, supervisor
from flink_ml_tpu_torch.utils import metrics

JOB_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 60.0
SGD_TOL = dict(rtol=2e-5, atol=2e-6)
KMEANS_TOL = dict(rtol=1e-5, atol=1e-6)
SUPERVISED_WORLD = dict(device="cpu", timeout_s=JOB_TIMEOUT_S, collective_timeout_s=3.0)


@pytest.fixture(scope="module")
def world():
    opened = {}

    def get(ranks):
        if ranks not in opened:
            opened[ranks] = launcher.World(ranks, device="cpu", timeout_s=JOB_TIMEOUT_S,
                                           collective_timeout_s=COLLECTIVE_TIMEOUT_S)
        return opened[ranks]
    yield get
    for w in opened.values():
        w.close()


def _data(seed=0, n=500, d=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, (X @ rng.standard_normal(d) > 0).astype(np.float32)


def _chunks(columns, chunk):
    n = len(next(iter(columns.values())))
    return [{k: v[i:i + chunk] for k, v in columns.items()} for i in range(0, n, chunk)]


def _jax_mesh(ranks):
    return jax_mesh.create_mesh(("data",), devices=jax.devices()[:ranks])


# ---------------------------------------------------------------------------
# stream fits on ranks
# ---------------------------------------------------------------------------

class TestShardedStream:
    LR = {"max_iter": 12, "global_batch_size": 100}

    @pytest.mark.parametrize("ranks", [2, 4])
    @pytest.mark.parametrize("chunk", [96, 250])
    def test_stream_lr_on_ranks(self, world, ranks, chunk):
        """Chunks of 96 or 250 rows re-cut into batches of 100; a rank
        caches its 100 / R rows of each batch."""
        X, y = _data(seed=ranks)
        chunks = _chunks({"features": X, "label": y}, chunk)
        out = world(ranks).run("torch_mesh2d_jobs:stream_fit", None, "lr", chunks, self.LR)
        for r in out[1:]:
            np.testing.assert_array_equal(r["coefficient"], out[0]["coefficient"])
        est = LogisticRegression().set_max_iter(12).set_global_batch_size(100)
        with config.use_device("cpu"):
            one = est.fit(StreamTable.from_batches([Table(c) for c in chunks]))
        jest = jax_lr.LogisticRegression().set_max_iter(12).set_global_batch_size(100)
        with jax_mesh.use_mesh(_jax_mesh(ranks)):
            ref = jest.fit(JaxStreamTable.from_batches([JaxTable(c) for c in chunks]))
        np.testing.assert_allclose(out[0]["coefficient"], one.coefficient, **SGD_TOL)
        np.testing.assert_allclose(out[0]["coefficient"], ref.coefficient, **SGD_TOL)

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_stream_kmeans_on_ranks(self, world, ranks):
        rng = np.random.default_rng(1)
        X = np.vstack([rng.standard_normal((100, 5)) + c * 4 for c in range(3)]).astype(
            np.float32)
        chunks = _chunks({"features": X}, 64)
        params = {"k": 3, "seed": 11, "max_iter": 8}
        out = world(ranks).run("torch_mesh2d_jobs:stream_fit", None, "kmeans", chunks, params)
        for r in out[1:]:
            np.testing.assert_array_equal(r["centroids"], out[0]["centroids"])
        with config.use_device("cpu"):
            one = KMeans().set_k(3).set_seed(11).set_max_iter(8).fit(
                StreamTable.from_batches([Table(c) for c in chunks]))
        with jax_mesh.use_mesh(_jax_mesh(ranks)):
            ref = jax_kmeans.KMeans().set_k(3).set_seed(11).set_max_iter(8).fit(
                JaxStreamTable.from_batches([JaxTable(c) for c in chunks]))
        for want in (one, ref):
            np.testing.assert_allclose(out[0]["centroids"], want.centroids, **KMEANS_TOL)
            np.testing.assert_array_equal(out[0]["weights"], want.weights)

    @pytest.mark.parametrize("kind", ["lr", "kmeans"])
    def test_a_checkpointed_stream_fit_on_ranks_resumes_bit_for_bit(self, world, kind,
                                                                    tmp_path):
        X, y = _data(seed=7, n=400)
        columns = {"features": X, "label": y} if kind == "lr" else {"features": X}
        params = self.LR if kind == "lr" else {"k": 3, "seed": 2, "max_iter": 8}
        chunks = _chunks(columns, 100)
        want = world(4).run("torch_mesh2d_jobs:stream_fit", None, kind, chunks, params,
                            str(tmp_path / "whole"))
        got = world(4).run("torch_mesh2d_jobs:stream_fit", None, kind, chunks, params,
                           str(tmp_path / "killed"), 5)
        key = "coefficient" if kind == "lr" else "centroids"
        for r in got:
            np.testing.assert_array_equal(r[key], want[0][key])
        assert any(f.name.endswith(".manifest.json") for f in (tmp_path / "killed").iterdir())

    def test_shard_features_stream_is_refused_as_jax(self):
        with pytest.raises(NotImplementedError, match="stream mode is data-parallel only"):
            optimizer.SGD(shard_features=True).optimize_stream(None, iter([]),
                                                               losses.BINARY_LOGISTIC_LOSS)


# ---------------------------------------------------------------------------
# checkpointed fits across rank counts
# ---------------------------------------------------------------------------

class TestShardedCheckpoint:
    KW = dict(max_iter=10, global_batch_size=64, tol=0.0, checkpoint_interval=2)

    @pytest.mark.parametrize("resume_ranks", [4, 2, 1])
    def test_a_rank_cut_resumes_on_any_rank_count(self, world, tmp_path, resume_ranks):
        """A 4-rank data-parallel fit killed after its third chunk (a cut at
        epoch 6, written by 4 ranks) resumes on 4 ranks bit for bit, on 2 or
        one within the sharded-fit tolerance."""
        X, y = _data(seed=3, n=300)
        ckpt = str(tmp_path)
        assert world(4).run("torch_mesh2d_jobs:checkpointed_fit", (4,), X, y, 6, self.KW, ckpt,
                            "rk", 3) == ["killed"] * 4
        manifest = coordinator._read_manifest(ckpt, "rk", coordinator.committed_cuts(ckpt, "rk")[-1])
        assert manifest["hosts"] == 4 and manifest["epoch"] == 6
        if resume_ranks == 1:
            with config.use_device("cpu"):
                got = optimizer.SGD(checkpoint_dir=ckpt, checkpoint_key="rk", **self.KW).optimize(
                    np.zeros(6), X, y, None, losses.BINARY_LOGISTIC_LOSS)
        else:
            got = world(resume_ranks).run("torch_mesh2d_jobs:checkpointed_fit", (resume_ranks,), X,
                                          y, 6, self.KW, ckpt, "rk")[0]
        want = world(4).run("torch_mesh2d_jobs:checkpointed_fit", (4,), X, y, 6, self.KW,
                            str(tmp_path / "whole"), "rk")[0]
        if resume_ranks == 4:
            np.testing.assert_array_equal(got[0], want[0])
        else:
            np.testing.assert_allclose(got[0], want[0], **SGD_TOL)
        assert got[2] == want[2] == 10


# ---------------------------------------------------------------------------
# the supervisor over ranks
# ---------------------------------------------------------------------------

#: the cut a supervised fit (a cut every epoch) resumes from when its fault
#: fires at the third boundary of its phase: the one of epoch 2
RESTORED = 2


class TestSupervisorOverRanks:
    KW = dict(max_iter=8, global_batch_size=32, tol=0.0, learning_rate=0.1)

    def _supervise(self, tmp_path, X, y, d, fault, after=3, model_shards=None, **policy):
        ckpt = str(tmp_path / "ckpt")
        before = metrics.snapshot()
        res = supervisor.supervise_world(
            "torch_mesh2d_jobs:supervised_fit", X, y, d, self.KW, ckpt, "sup",
            world_size=4, hosts=2, fault=fault, after=after, checkpoint_dir=ckpt,
            job_key="sup", world_kwargs=dict(SUPERVISED_WORLD, model_shards=model_shards),
            job_timeout_s=60.0, **policy)
        return res, metrics.snapshot_delta(before, metrics.snapshot())["counters"]

    def test_a_dead_host_is_quarantined_and_the_world_shrinks(self, world, tmp_path):
        X, y = _data(seed=5, n=192)
        res, counters = self._supervise(tmp_path, X, y, 6, "host.die.dispatch")
        (event,) = res.events
        assert (event.kind, event.host, event.phase, event.quarantined, event.hosts_after) == (
            "hostFailure", 1, "dispatch", True, 1)
        # from the victim's exit to the first failure seen: its peers'
        # collectives fail at once, well inside the collective timeout
        assert 0.0 <= event.detection_ms < 1000.0 * SUPERVISED_WORLD["collective_timeout_s"]
        assert event.recovery_ms > 0.0
        assert res.attempts == 2 and res.hosts == 1 and len(res.value) == 2
        assert counters["supervisor.hostFailure"] == 1 and counters["supervisor.quarantine"] == 1
        assert all(v[2] == {"data": 2} for v in res.value)
        want = world(4).run("torch_mesh2d_jobs:supervised_fit", X, y, 6, self.KW,
                            str(tmp_path / "whole"), "sup")[0]
        assert want[3] == 0
        for coeff, epochs, _, restored in res.value:
            np.testing.assert_allclose(coeff, want[0], **SGD_TOL)
            assert epochs == want[1] == 8
            assert restored == RESTORED  # the last cut before the fault, not a refit

    def test_a_hung_host_is_readmitted_bit_for_bit(self, world, tmp_path):
        X, y = _data(seed=6, n=192)
        res, counters = self._supervise(tmp_path, X, y, 6, "host.hang.collective")
        (event,) = res.events
        assert (event.kind, event.host, event.phase, event.quarantined, event.hosts_after) == (
            "collectiveHang", 1, "collective", False, 2)
        # from the hang to the peers' collective timeout
        assert 500.0 * SUPERVISED_WORLD["collective_timeout_s"] < event.detection_ms < 60000.0
        assert event.recovery_ms > 0.0
        assert res.hosts == 2 and len(res.value) == 4
        assert counters["supervisor.collectiveHang"] == 1
        want = world(4).run("torch_mesh2d_jobs:supervised_fit", X, y, 6, self.KW,
                            str(tmp_path / "whole"), "sup")[0]
        for coeff, epochs, _, restored in res.value:
            np.testing.assert_array_equal(coeff, want[0])
            assert epochs == 8 and restored == RESTORED

    def test_a_rank_killed_without_a_plan_is_a_dead_host(self, tmp_path):
        """A rank that dies by a signal, with no fault armed, is a host
        failure of its host, whatever its exit code; the survivors resume
        from the cut before it died."""
        X, y = _data(seed=5, n=192)
        ckpt = str(tmp_path / "ckpt")
        res = supervisor.supervise_world(
            "torch_mesh2d_jobs:killed_at_epoch", X, y, 6, self.KW, ckpt, "sup", 3,
            world_size=4, hosts=2, checkpoint_dir=ckpt, job_key="sup",
            world_kwargs=SUPERVISED_WORLD, job_timeout_s=60.0)
        (event,) = res.events
        assert (event.kind, event.host, event.phase, event.quarantined) == (
            "hostFailure", 0, None, True)
        assert event.detection_ms < 1000.0 * SUPERVISED_WORLD["collective_timeout_s"]
        assert len(res.value) == 2 and all(v[3] == 3 for v in res.value)

    def test_a_2d_world_shrinks_to_its_surviving_data_row(self, world, tmp_path):
        """A feature-sharded fit on 2 x 2 (hosts = data rows) loses host 1;
        the survivors resume the 2 x 2 cut on a 1 x 2 mesh."""
        rng = np.random.default_rng(9)
        idx = rng.integers(0, 24, size=(128, 4)).astype(np.int32)
        vals = rng.random((128, 4))
        y = (rng.random(128) > 0.5).astype(np.float64)
        res, _ = self._supervise(tmp_path, (idx, vals), y, 24, "host.die.dispatch",
                                 model_shards=2)
        assert res.events[0].quarantined and len(res.value) == 2
        assert all(v[2] == {"data": 1, "model": 2} for v in res.value)
        want = world(4).run("torch_mesh2d_jobs:checkpointed_fit", (2, 2), (idx, vals), y, 24,
                            self.KW, str(tmp_path / "whole"), "sup")[0]
        for coeff, epochs, _, restored in res.value:
            np.testing.assert_allclose(coeff, want[0], rtol=3e-5, atol=3e-6)
            assert epochs == 8 and restored == RESTORED

    def test_form_mesh_over_survivors(self, world):
        assert world(2).run("torch_mesh2d_jobs:form_mesh_over", [[0], [1]]) == [{"data": 2}] * 2
        for message in world(2).run("torch_mesh2d_jobs:form_mesh_over", [[0, 1], [2, 3]]):
            assert "relaunched" in message
        for message in world(2).run("torch_mesh2d_jobs:form_mesh_over", [[], []]):
            assert "zero surviving" in message

    def test_rank_pulses_are_noops_outside_supervision(self, world):
        assert world(2).run("torch_mesh2d_jobs:pulse_outside_supervision") == [True, True]

    def test_policies_are_checked(self):
        with pytest.raises(ValueError, match="on_hang"):
            supervisor.supervise_world("torch_mesh2d_jobs:supervised_fit", world_size=2,
                                       hosts=1, on_hang="retry")
