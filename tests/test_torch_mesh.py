"""flink_ml_tpu_torch/parallel/mesh.py, launcher.py and dispatch.py, the
data-axis placement of data/devicecache.py and the sharded fits of SGD,
the linear estimators and KMeans against the JAX package.

The module starts one world of 2 and one of 4 gloo ranks on the CPU
(`parallel.launcher.World`, each at the first test that needs it) and
runs every world case inside them, through the jobs of
tests/torch_mesh_jobs.py. The JAX side runs on
`create_mesh(("data",), devices=jax.devices()[:R])`. Tolerances:

- the placement of rows (which rows a rank holds, with which padding)
  equals the JAX layout's shard of that device exactly;
- a sharded fit against the port's flat fit and the JAX R-device fit:
  coefficients within rtol 2e-5 / atol 2e-6 and the loss within 1e-5
  (tests/test_linear_models.py:140-170, whose cases these are), the same
  epochs; KMeans centroids within rtol 1e-5 / atol 1e-6 and the same
  counts; every rank ends with the same model bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import linearsvc as jax_svc
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.models.regression import linearregression as jax_linreg
from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import dispatch as jax_dispatch
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu_torch import SparseBatch, StreamTable, Table, config
from flink_ml_tpu_torch.data import devicecache
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import dispatch, launcher, mesh
from flink_ml_tpu_torch.utils import metrics

JOB_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 60.0
SGD_TOL = dict(rtol=2e-5, atol=2e-6)
KMEANS_TOL = dict(rtol=1e-5, atol=1e-6)


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


@pytest.fixture
def on_cpu():
    with config.use_device("cpu"):
        yield


def _jax_mesh(ranks):
    return jax_mesh.create_mesh(("data",), devices=jax.devices()[:ranks])


# ---------------------------------------------------------------------------
# the mesh and its layout helpers (no world)
# ---------------------------------------------------------------------------

class TestMesh:
    def test_default_mesh_is_one_rank_without_a_world(self, on_cpu):
        m = mesh.create_mesh()
        assert m.shape == {"data": 1} and m.group is None and m.rank == 0
        assert m.device == torch.device("cpu")
        two = mesh.create_mesh(("data", "model"))
        assert two.shape == {"data": 1, "model": 1}
        assert mesh.num_data_shards(two) == 1 == mesh.num_model_shards(two)
        with pytest.raises(ValueError, match="does not match"):
            mesh.create_mesh(shape=[2])

    def test_use_mesh_and_set_default_mesh(self):
        other = mesh.Mesh(("data",), (1,), device="cpu")
        before = mesh.default_mesh()
        with mesh.use_mesh(other) as m:
            assert mesh.default_mesh() is m is other
        assert mesh.default_mesh() is before
        mesh.set_default_mesh(other)
        try:
            assert mesh.default_mesh() is other
        finally:
            mesh.set_default_mesh(None)
        assert mesh.default_mesh().shape == {"data": 1}

    @pytest.mark.parametrize("n,multiple", [(10, 4), (8, 4), (1, 3), (0, 2)])
    def test_pad_to_multiple_as_jax(self, n, multiple):
        arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        got, got_n = mesh.pad_to_multiple(arr, multiple, pad_value=7)
        want, want_n = jax_mesh.pad_to_multiple(arr, multiple, pad_value=7)
        np.testing.assert_array_equal(got, want)
        assert got_n == want_n == n

    @pytest.mark.parametrize("length,hosts", [(10, 4), (3, 5), (8, 1), (0, 2)])
    def test_host_slice_bounds_as_jax(self, length, hosts):
        assert mesh.host_slice_bounds(length, hosts) == jax_mesh.host_slice_bounds(length, hosts)
        with pytest.raises(ValueError):
            mesh.host_slice_bounds(4, 0)

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_shard_batch_holds_the_rows_of_the_jax_data_sharding(self, ranks):
        arr = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
        jax_arr, jax_n = jax_mesh.shard_batch(_jax_mesh(ranks), arr)
        shards = {s.device: np.asarray(s.data) for s in jax_arr.addressable_shards}
        for r, device in enumerate(jax.devices()[:ranks]):
            m = mesh.Mesh(("data",), (ranks,), rank=r, device="cpu")
            for source in (arr, torch.from_numpy(arr)):
                got, n = mesh.shard_batch(m, source)
                assert n == jax_n == 10
                np.testing.assert_array_equal(got.numpy(), shards[device])
        np.testing.assert_array_equal(
            mesh.replicate(mesh.Mesh(("data",), (1,), device="cpu"), arr).numpy(), arr)

    @pytest.mark.parametrize("ranks", [2, 4])
    @pytest.mark.parametrize("n,batch", [(50, 16), (50, 18), (10, 16)])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_a_rank_holds_its_device_shard_of_the_jax_batch_layout(self, ranks, n, batch,
                                                                   weighted):
        """`SGD._batchify` on rank r gives exactly the slots device r holds
        in the JAX package's (batches, b_pad, ...) layout: X, y and the
        weights, dense and sparse (the port pads sparse slots with index
        -1, JAX with 0; both with value 0 and weight 0)."""
        rng = np.random.default_rng(7)
        X = rng.random((n, 3), dtype=np.float32)
        y = (rng.random(n) > 0.5).astype(np.float32)
        w = rng.random(n, dtype=np.float32) if weighted else None
        idx = rng.integers(0, 20, (n, 4)).astype(np.int32)
        vals = rng.random((n, 4), dtype=np.float32)
        sgd_j = jax_optimizer.SGD(global_batch_size=batch)
        jm = _jax_mesh(ranks)
        X_j, y_j, w_j = sgd_j._batchify(jm, X, y, w)
        (ji, jv), _, _ = sgd_j._batchify(jm, (idx, vals), y, w)

        def shard_of(arr, device):
            return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)
        sgd = optimizer.SGD(global_batch_size=batch, max_iter=100)
        with config.use_device("cpu"):
            for r, device in enumerate(jax.devices()[:ranks]):
                m = mesh.Mesh(("data",), (ranks,), rank=r, device="cpu")
                X_b, y_b, w_b, y_all = sgd._batchify(m, X, y, w)
                np.testing.assert_array_equal(X_b.numpy(), shard_of(X_j, device))
                np.testing.assert_array_equal(y_b.numpy(), shard_of(y_j, device))
                np.testing.assert_array_equal(y_all.numpy(), shard_of(y_j, device))
                np.testing.assert_array_equal(w_b.numpy(), shard_of(w_j, device))
                (pi, pv), _, _, _ = sgd._batchify(m, (idx, vals), y, w)
                pad = pi.numpy() < 0
                np.testing.assert_array_equal(pv.numpy(), shard_of(jv, device))
                np.testing.assert_array_equal(np.where(pad, 0, pi.numpy()), shard_of(ji, device))
                assert not np.any(shard_of(jv, device)[pad])

    def test_data_axis_rows(self):
        rows = devicecache.data_axis_rows(n=10, batch=6, shards=4, rank=1, batches=2)
        # b_pad = 8, two slots a rank: rank 1 holds slots 2, 3 of each batch
        np.testing.assert_array_equal(rows, [[2, 3], [8, 9]])
        last = devicecache.data_axis_rows(n=10, batch=6, shards=4, rank=3, batches=2)
        np.testing.assert_array_equal(last, [[-1, -1], [-1, -1]])  # slots 6, 7: padding
        got = devicecache.stage_rank_rows(np.arange(10.0), rows, 10, -5.0, "cpu")
        np.testing.assert_array_equal(got.numpy(), [[2.0, 3.0], [8.0, 9.0]])

    def test_the_2d_layout_and_the_fleet_regime_wait_for_a10b(self):
        """They waited for A.10b until it was ported: without a world the
        2D mesh is one rank, the shardings are a rank's blocks, and the
        fleet rule is the JAX package's at any rank count (the 2D layout is
        held on ranks in tests/test_torch_mesh2d.py)."""
        one = mesh.create_mesh_2d(1)
        assert one.shape == {"data": 1, "model": 1} and one.group is None
        with pytest.raises(ValueError, match="does not divide"):
            mesh.create_mesh_2d(2)
        assert mesh.model_sharding(mesh.default_mesh()).spec == ()
        assert mesh.data_model_sharding(one).spec == ("data", "model")
        assert mesh.fleet_sharding(one).spec == ("data", None)
        assert mesh.host_groups(one, 1) == [[0]]
        assert mesh.shard_axis_for_tag("model", 2) == 1
        for shards, members in ((1, 8), (2, 8), (2, 3), (4, 8)):
            assert mesh.fleet_axis_shardable(mesh.Mesh(("data",), (shards,)), members) is \
                jax_mesh.fleet_axis_shardable(_jax_mesh(shards), members)


class TestBackendRule:
    """No fallback: NCCL on a shared card or on the CPU raises, naming the
    cause; nothing switches backend (the device check mocked by keys)."""

    @pytest.mark.parametrize("requested,device,keys,want", [
        (None, "cuda", ["h:cuda:a", "h:cuda:b"], "nccl"),
        ("nccl", "cuda", ["h:cuda:a", "h:cuda:b"], "nccl"),
        ("gloo", "cuda", ["h:cuda:a", "h:cuda:a"], "gloo"),
        ("gloo", "cuda", ["h:cuda:a", "h:cuda:b"], "gloo"),
        (None, "cpu", ["h:cpu", "h:cpu"], "gloo"),
        ("gloo", "cpu", ["h:cpu"], "gloo"),
    ])
    def test_the_backend_chosen(self, requested, device, keys, want):
        assert mesh.choose_backend(requested, device, keys) == want

    @pytest.mark.parametrize("requested,device,keys,match", [
        ("nccl", "cuda", ["h:cuda:a", "h:cuda:a"], "share"),
        (None, "cuda", ["h:cuda:a", "h:cuda:a", "h:cuda:b"], "name backend='gloo'"),
        ("nccl", "cpu", ["h:cpu"], "needs a CUDA device"),
        ("mpi", "cpu", ["h:cpu"], "unknown backend"),
    ])
    def test_refused(self, requested, device, keys, match):
        with pytest.raises(ValueError, match=match):
            mesh.choose_backend(requested, device, keys)

    def test_nccl_on_the_cpu_raises_in_init_distributed(self, tmp_path):
        import torch.distributed as dist

        assert mesh.init_distributed(None) is None
        with pytest.raises(ValueError, match="needs a CUDA device"):
            mesh.init_distributed("file://" + str(tmp_path / "rdv"), world_size=1, rank=0,
                                  backend="nccl", device="cpu", timeout_s=10)
        assert not dist.is_initialized()

    def test_the_device_key_names_the_host(self):
        assert mesh.device_key(torch.device("cpu")).endswith(":cpu")


class TestDispatch:
    def test_a_mesh_fit_counts_its_fallback(self):
        before = metrics.snapshot()
        assert dispatch.whole_fit_plan(start_epoch=0, max_iter=5, ranks=4) == (False, "mesh")
        assert dispatch.whole_fit_plan(start_epoch=0, max_iter=5) == (True, None)
        delta = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
        assert delta == {"dispatch.whole_fit_fallback": 1, "dispatch.whole_fit_fallback.mesh": 1}
        with config.whole_fit_mode("off"):
            assert dispatch.whole_fit_plan(start_epoch=0, max_iter=5, ranks=4) == (False, None)
        assert "mesh" in dispatch.WHOLE_FIT_FALLBACK_REASONS
        assert set(jax_dispatch.WHOLE_FIT_FALLBACK_REASONS) < set(
            dispatch.WHOLE_FIT_FALLBACK_REASONS)

    @pytest.mark.parametrize("kwargs", [
        dict(start_epoch=0, max_iter=10, checkpoint_interval=3),
        dict(start_epoch=9, max_iter=10, checkpoint_interval=10),
        dict(start_epoch=0, max_iter=10, uniform_batches=False),
        dict(start_epoch=0, max_iter=10, listener=True, checkpoint_interval=2),
        dict(start_epoch=0, max_iter=10, data_bytes=10)])
    def test_the_jax_reasons_in_the_jax_order(self, kwargs):
        assert dispatch.whole_fit_plan(**kwargs) == jax_dispatch.whole_fit_plan(**kwargs)


class TestWhatWaitsForA10b:
    """Options that waited for A.10b raised naming it until it was ported;
    on one rank they now take the flat fit, and a hand-made mesh of ranks
    with no world behind it is refused before any collective."""

    def test_a_model_axis_is_refused_by_the_estimators(self, on_cpu):
        X = np.random.default_rng(0).random((20, 3))
        y = (X[:, 0] > 0.5).astype(float)
        idx = np.tile(np.arange(3, dtype=np.int32), (20, 1))
        sparse = Table({"features": SparseBatch(3, idx, X), "label": y})
        flat = LogisticRegression().fit(sparse).coefficient
        with mesh.use_mesh(mesh.Mesh(("data", "model"), (1, 1))):
            np.testing.assert_array_equal(LogisticRegression().fit(sparse).coefficient, flat)
            KMeans().set_k(2).fit(Table({"features": X}))
        centroids = KMeans().set_k(2).fit(Table({"features": X})).centroids
        with mesh.use_mesh(mesh.Mesh(("data", "model"), (1, 2))):
            # the sparse fit splits its features over `model`, and a dense
            # fit splits its rows over both ranks (C.36): each needs the group
            with pytest.raises(ValueError, match="no process group"):
                LogisticRegression().fit(sparse)
            with pytest.raises(ValueError, match="no process group"):
                LogisticRegression().fit(Table({"features": X, "label": y}))
            # KMeans reduces over `data` only (one shard here)
            np.testing.assert_array_equal(
                KMeans().set_k(2).fit(Table({"features": X})).centroids, centroids)

    def test_sharded_stream_checkpoint_and_feature_sharding(self, on_cpu, tmp_path):
        two = mesh.Mesh(("data",), (2,))
        X = np.random.default_rng(1).random((40, 3))
        y = (X[:, 0] > 0.5).astype(float)
        plain = optimizer.SGD().optimize(np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS)
        with pytest.raises(ValueError, match="no process group"):
            optimizer.SGD(checkpoint_dir=str(tmp_path)).optimize(
                np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS, mesh=two)
        featured = optimizer.SGD(shard_features=True).optimize(
            np.zeros(3), X, y, None, losses.BINARY_LOGISTIC_LOSS)
        np.testing.assert_array_equal(featured[0], plain[0])
        with pytest.raises(ValueError, match="no process group"):
            optimizer.SGD().optimize_stream(None, iter([(X, y, None)]),
                                            losses.BINARY_LOGISTIC_LOSS, mesh=two)
        with mesh.use_mesh(two):
            with pytest.raises(ValueError, match="no process group"):
                KMeans().set_k(2).fit(StreamTable.from_batches([Table({"features": X})]))

    def test_a_rank_imports_its_target_by_module_path(self):
        assert launcher.target_path(optimizer.SGD) == "flink_ml_tpu_torch.ops.optimizer:SGD"
        assert launcher.resolve("flink_ml_tpu_torch.ops.optimizer:SGD") is optimizer.SGD
        for bad in (lambda: 0, "no_colon"):
            with pytest.raises(ValueError):
                launcher.target_path(bad)


# ---------------------------------------------------------------------------
# worlds of ranks
# ---------------------------------------------------------------------------

def _sgd_case(n, with_weights, batch=16):
    rng = np.random.default_rng(3)
    X = rng.random((n, 5), dtype=np.float32)
    y = (X @ np.arange(1, 6, dtype=np.float32) > 7.5).astype(np.float32)
    w = rng.random(n, dtype=np.float32) if with_weights else None
    return X, y, w, dict(max_iter=7, learning_rate=0.05, global_batch_size=batch, tol=0.0)


@pytest.mark.parametrize("ranks", [2, 4])
def test_every_rank_sees_its_mesh(world, ranks):
    info = world(ranks).run("torch_mesh_jobs:rank_info")
    assert [i["rank"] for i in info] == list(range(ranks))
    assert all(i["shape"] == {"data": ranks} and i["threads"] == 1 and i["device"] == "cpu"
               for i in info)


class TestShardedSgd:
    """The sharded SGD against the flat fit and the JAX R-device fit
    (tests/test_linear_models.py TestFlatTrainPath's cases)."""

    @pytest.mark.parametrize("ranks", [2, 4])
    @pytest.mark.parametrize("with_weights", [False, True])
    @pytest.mark.parametrize("n", [64, 50, 10])  # even, ragged, n < batch
    def test_matches_flat_and_jax(self, world, ranks, n, with_weights):
        X, y, w, kw = _sgd_case(n, with_weights)
        out = world(ranks).run("torch_mesh_jobs:sgd_fit", X, y, w, 5, "binary_logistic", kw)
        coeff, loss, epochs, counters, seq = out[0]
        for r in out[1:]:
            np.testing.assert_array_equal(r[0], coeff)
            assert r[4] == seq
        assert epochs == 7
        assert counters["dispatch.whole_fit_fallback.mesh"] == 1
        assert counters["collective.psum.calls"] == 7
        with config.use_device("cpu"):
            flat = optimizer.SGD(**kw).optimize(np.zeros(5), X, y, w,
                                                losses.BINARY_LOGISTIC_LOSS)
        jc, jl, je = jax_optimizer.SGD(**kw).optimize(
            np.zeros(5, np.float32), X, y, w, jax_losses.BINARY_LOGISTIC_LOSS,
            mesh=_jax_mesh(ranks))
        for ref_c, ref_l, ref_e in ((flat[0], flat[1], flat[2]), (np.asarray(jc), jl, je)):
            np.testing.assert_allclose(coeff, ref_c, **SGD_TOL)
            assert abs(loss - ref_l) < 1e-5 and epochs == ref_e


def _jax_fit(kind, table, params, ranks):
    cls = {"lr": jax_lr.LogisticRegression, "svc": jax_svc.LinearSVC,
           "linreg": jax_linreg.LinearRegression, "kmeans": jax_kmeans.KMeans}[kind]
    est = cls()
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
    with jax_mesh.use_mesh(_jax_mesh(ranks)):
        return est.fit(table)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("kind", ["lr", "svc", "linreg"])
def test_linear_estimators_on_a_default_mesh(world, ranks, kind):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((90, 6))
    dots = X @ rng.standard_normal(6)
    y = dots + 0.1 * rng.standard_normal(90) if kind == "linreg" else (dots > 0).astype(float)
    w = rng.random(90) + 0.5
    params = {"max_iter": 8, "global_batch_size": 32, "weight_col": "w"}
    out = world(ranks).run("torch_mesh_jobs:estimator_fit", kind,
                           {"features": X, "label": y, "w": w}, params)
    for r in out[1:]:
        np.testing.assert_array_equal(r["coefficient"], out[0]["coefficient"])
    ref = _jax_fit(kind, JaxTable({"features": X, "label": y, "w": w}), params, ranks)
    np.testing.assert_allclose(out[0]["coefficient"], ref.coefficient, **SGD_TOL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sparse_logistic_regression_on_a_default_mesh(world, ranks):
    rng = np.random.default_rng(12)
    n, dim, nnz = 120, 40, 5
    idx = rng.integers(0, dim, (n, nnz)).astype(np.int32)
    idx[rng.random((n, nnz)) < 0.2] = -1
    vals = rng.random((n, nnz))
    y = (rng.random(n) > 0.5).astype(float)
    params = {"max_iter": 6, "global_batch_size": 32}
    out = world(ranks).run("torch_mesh_jobs:estimator_fit", "lr",
                           {"features": ("sparse", dim, idx, vals), "label": y}, params)
    for r in out[1:]:
        np.testing.assert_array_equal(r["coefficient"], out[0]["coefficient"])
    ref = _jax_fit("lr", JaxTable({"features": JaxSparseBatch(dim, idx, vals), "label": y}),
                   params, ranks)
    np.testing.assert_allclose(out[0]["coefficient"], ref.coefficient, **SGD_TOL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_kmeans_on_a_default_mesh(world, ranks):
    rng = np.random.RandomState(5)
    X = np.concatenate([rng.randn(40, 4) + 4, rng.randn(41, 4) - 4, rng.randn(40, 4)])
    params = {"k": 3, "seed": 3, "max_iter": 6}
    out = world(ranks).run("torch_mesh_jobs:estimator_fit", "kmeans", {"features": X}, params)
    for r in out[1:]:
        np.testing.assert_array_equal(r["centroids"], out[0]["centroids"])
    ref = _jax_fit("kmeans", JaxTable({"features": X}), params, ranks)
    np.testing.assert_allclose(out[0]["centroids"], ref.centroids, **KMEANS_TOL)
    np.testing.assert_array_equal(out[0]["weights"], ref.weights)
    with config.use_device("cpu"):
        flat = KMeans().set_k(3).set_seed(3).set_max_iter(6).fit(Table({"features": X}))
    np.testing.assert_allclose(out[0]["centroids"], flat.centroids, **KMEANS_TOL)


class TestSanitizerOnAMesh:
    """The sanitizer's mesh case (tests/test_sanitizer.py:230-275) with real
    ranks: each records its own sequence, and the ranks compare them."""

    def test_equal_sequences_are_clean(self, world):
        for problems, raised in world(2).run("torch_mesh_jobs:skip_a_collective", -1, 30.0):
            assert problems == [] and not raised

    def test_a_rank_that_skips_a_collective_is_reported(self, world):
        """Rank 1 skips the second reduce; rank 0's waits out its group's
        3 s timeout and raises (no hang), and both ranks report the
        divergence as the JAX ledger words it."""
        out = world(2).run("torch_mesh_jobs:skip_a_collective", 1, 3.0)
        (p0, raised0), (p1, raised1) = out
        assert raised0 and not raised1
        assert p0 == p1 and len(p0) == 1
        assert "collective-sequence divergence" in p0[0] and "deadlock" in p0[0]


def test_a_failing_rank_fails_the_job_and_closes_the_world(world):
    """Last in the module: a rank's exception comes back with its traceback,
    and the world runs nothing more."""
    w = world(2)
    with pytest.raises(launcher.RankError, match="rank 1 fails on purpose"):
        w.run("torch_mesh_jobs:raise_on", 1)
    with pytest.raises(RuntimeError, match="closed"):
        w.run("torch_mesh_jobs:rank_info")
