"""flink_ml_tpu_torch/parallel/overlap.py (the carry-delayed reduction)
against the plain sharded loops and the JAX package's overlap programs,
on worlds of 2 and 4 gloo ranks on the CPU.

The module starts one world of each size and runs every case inside it
(the jobs of tests/torch_mesh_jobs.py). The JAX side runs on
`create_mesh(("data",), devices=jax.devices()[:R])`. The cases follow
tests/test_collective_chunks.py (TestOverlapSgdParity, TestOverlapKMeans).
Tolerances (ROADMAP C.26):

- at 2 ranks overlap equals plain bit for bit (coefficients, loss, epochs,
  centroids, counts), the dense and the pair routes of a sparse fit too;
- at 4 ranks the bucketed reduce associates by other segments than the
  monolithic one: coefficients within rtol 2e-5 / atol 2e-6 (the JAX
  package's sharded-against-flat tolerance, tests/test_linear_models.py:
  168), the same epochs, the loss within 1e-5 relative; KMeans centroids
  within rtol 1e-5 / atol 1e-6 and the same counts;
- against the JAX overlap program on R devices: the same tolerances at
  both sizes (XLA's psum and the backend's reduce associate differently);
- every rank ends with the same model, bit for bit, and records the same
  collective sequence.
"""

import jax
import numpy as np
import pytest

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import config as jax_config
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.parallel import launcher, mesh, overlap

JOB_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 60.0
SGD_TOL = dict(rtol=2e-5, atol=2e-6)
KMEANS_TOL = dict(rtol=1e-5, atol=1e-6)
JOB = "torch_mesh_jobs:sgd_fit"


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


def _jax_mesh(ranks):
    return jax_mesh.create_mesh(("data",), devices=jax.devices()[:ranks])


def _jax_fit(ranks, X, y, loss, d, overlap_on, **kw):
    sgd = jax_optimizer.SGD(collective_overlap=overlap_on, **kw)
    return sgd.optimize(np.zeros(d, np.float32), X, y, None, loss, mesh=_jax_mesh(ranks))


def _same_on_every_rank(out):
    for r in out[1:]:
        np.testing.assert_array_equal(r[0], out[0][0])
        assert r[1:3] == out[0][1:3]
        assert r[4] == out[0][4]  # the recorded collective sequence


def _hold(ranks, got, want):
    if ranks == 2:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:3] == want[1:3]
    else:
        np.testing.assert_allclose(got[0], want[0], **SGD_TOL)
        assert got[2] == want[2] and abs(got[1] - want[1]) <= 1e-5 * abs(want[1])


def _dense_data(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(256, 10).astype(np.float32)
    y = (X @ np.linspace(1, -1, 10) > 0).astype(np.float32)
    return X, y


def _sparse_data(dim=500, n=256, nnz=5):
    rng = np.random.RandomState(1)
    indices = rng.randint(0, dim, size=(n, nnz)).astype(np.int32)
    indices[::7, -1] = -1  # padded-CSR empty slots
    values = rng.rand(n, nnz).astype(np.float32)
    y = (rng.rand(n) > 0.5).astype(np.float32)
    return (indices, values), y


class TestOverlapSgdParity:
    @pytest.mark.parametrize("ranks", [2, 4])
    @pytest.mark.parametrize("loss_name", ["binary_logistic", "least_square"])
    def test_dense(self, world, ranks, loss_name):
        X, y = _dense_data(0)
        kw = dict(max_iter=12, global_batch_size=64, tol=0.0, reg=0.05, elastic_net=0.3)
        plain = world(ranks).run(JOB, X, y, None, 10, loss_name, kw)
        over = world(ranks).run(JOB, X, y, None, 10, loss_name,
                                dict(kw, collective_overlap=True))
        _same_on_every_rank(plain)
        _same_on_every_rank(over)
        _hold(ranks, over[0], plain[0])
        loss = {"binary_logistic": jax_losses.BINARY_LOGISTIC_LOSS,
                "least_square": jax_losses.LEAST_SQUARE_LOSS}[loss_name]
        jc, jl, je = _jax_fit(ranks, X, y, loss, 10, True, **kw)
        np.testing.assert_allclose(over[0][0], np.asarray(jc), **SGD_TOL)
        assert over[0][2] == je and abs(over[0][1] - jl) <= 1e-5 * abs(jl)
        counters = over[0][3]
        assert counters["collective.chunked.calls"] == kw["max_iter"] + 1
        assert counters["collective.psum.calls"] == kw["max_iter"]  # the (loss, weight) scalars
        assert plain[0][3]["collective.psum.calls"] == kw["max_iter"]
        assert "collective.chunked.calls" not in plain[0][3]

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_tol_early_stop(self, world, ranks):
        X, y = _dense_data(3)
        kw = dict(max_iter=50, global_batch_size=64, tol=0.4)
        plain = world(ranks).run(JOB, X, y, None, 10, "binary_logistic", kw)
        over = world(ranks).run(JOB, X, y, None, 10, "binary_logistic",
                                dict(kw, collective_overlap=True))
        assert plain[0][2] < 50  # the tol stop engaged
        _hold(ranks, over[0], plain[0])
        jc, jl, je = _jax_fit(ranks, X, y, jax_losses.BINARY_LOGISTIC_LOSS, 10, True, **kw)
        assert over[0][2] == je
        np.testing.assert_allclose(over[0][0], np.asarray(jc), **SGD_TOL)

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_sparse(self, world, ranks):
        """A sparse gradient at the default threshold: at 2 ranks its pairs
        (32 rows x 5 slots x 8 B = 1,280 B) lose to half the dense payload
        (1,000 B) and it rides the chunked dense reduce; at 4 ranks (640 B)
        the pair exchange, as at the JAX package's 8 shards."""
        X, y = _sparse_data()
        kw = dict(max_iter=10, global_batch_size=64, tol=0.0)
        plain = world(ranks).run(JOB, X, y, None, 500, "binary_logistic", kw)
        over = world(ranks).run(JOB, X, y, None, 500, "binary_logistic",
                                dict(kw, collective_overlap=True))
        _same_on_every_rank(over)
        _hold(ranks, over[0], plain[0])
        pairs = ranks == 4
        assert ("collective.sparse_allreduce.calls" in over[0][3]) is pairs
        assert ("collective.chunked.calls" in over[0][3]) is not pairs
        jc, jl, je = _jax_fit(ranks, X, y, jax_losses.SPARSE_BINARY_LOGISTIC_LOSS, 500, True,
                              **kw)
        np.testing.assert_allclose(over[0][0], np.asarray(jc), **SGD_TOL)

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_sparse_pairs_route(self, world, ranks):
        """With the threshold raised the gradient rides the pair exchange:
        at 2 ranks still bit for bit the plain fit (each rank's partial is
        the plain gradient's scatter, then a + b)."""
        X, y = _sparse_data()
        kw = dict(max_iter=10, global_batch_size=64, tol=0.0)
        plain = world(ranks).run(JOB, X, y, None, 500, "binary_logistic", kw)
        pairs = world(ranks).run(JOB, X, y, None, 500, "binary_logistic",
                                 dict(kw, collective_overlap=True), 100.0)
        _same_on_every_rank(pairs)
        _hold(ranks, pairs[0], plain[0])
        counters = pairs[0][3]
        assert counters["collective.sparse_allreduce.calls"] == kw["max_iter"] + 1
        assert "collective.chunked.calls" not in counters
        assert counters["collective.sparse.bytes"] == (kw["max_iter"] + 1) * (64 // ranks) * 5 * 8

    def test_sparse_pairs_route_engages(self):
        """The router picks pairs exactly when this rank's pair bytes beat
        the threshold at the mesh's shard count (the JAX package's cases:
        a 64-row batch of 5 slots over d = 500)."""
        import torch

        def local(shards):
            return (torch.zeros((4, 64 // shards, 5), dtype=torch.int32),
                    torch.zeros((4, 64 // shards, 5)))
        mesh8, mesh2 = mesh.Mesh(("data",), (8,)), mesh.Mesh(("data",), (2,))
        assert overlap.sgd_use_sparse_pairs(local(8), 500, mesh8)  # 320 B < 1 KB
        assert not overlap.sgd_use_sparse_pairs(local(2), 500, mesh2)  # 1280 B > 1 KB
        assert not overlap.sgd_use_sparse_pairs(local(1), 500, mesh.Mesh(("data",), (1,)))
        assert not overlap.sgd_use_sparse_pairs(torch.zeros((4, 8, 5)), 500, mesh8)
        jax_b = (np.zeros((4, 64, 5), np.int32), np.zeros((4, 64, 5), np.float32))
        from flink_ml_tpu.parallel import overlap as jax_overlap

        assert jax_overlap.sgd_use_sparse_pairs(jax_b, 500, _jax_mesh(8))
        assert not jax_overlap.sgd_use_sparse_pairs(jax_b, 500, _jax_mesh(2))
        assert not overlap.fleet_overlap_supported()
        overlap.clear_program_cache()


class TestOverlapKMeans:
    @pytest.mark.parametrize("ranks", [2, 4])
    def test_lloyd_against_plain_and_jax(self, world, ranks):
        rng = np.random.RandomState(0)
        X = np.concatenate([rng.randn(64, 6) + 3, rng.randn(64, 6) - 3, rng.randn(3, 6)])
        params = {"k": 3, "seed": 2, "max_iter": 7}
        plain = world(ranks).run("torch_mesh_jobs:estimator_fit", "kmeans", {"features": X},
                                 params)
        over = world(ranks).run("torch_mesh_jobs:estimator_fit", "kmeans", {"features": X},
                                {**params, "_overlap": True})
        for r in over:
            np.testing.assert_array_equal(r["centroids"], over[0]["centroids"])
        if ranks == 2:
            np.testing.assert_array_equal(over[0]["centroids"], plain[0]["centroids"])
        else:
            np.testing.assert_allclose(over[0]["centroids"], plain[0]["centroids"], **KMEANS_TOL)
        np.testing.assert_array_equal(over[0]["weights"], plain[0]["weights"])
        with jax_mesh.use_mesh(_jax_mesh(ranks)), jax_config.collective_overlap_mode(True):
            ref = jax_kmeans.KMeans().set_k(3).set_seed(2).set_max_iter(7).fit(
                JaxTable({"features": X}))
        np.testing.assert_allclose(over[0]["centroids"], ref.centroids, **KMEANS_TOL)
        np.testing.assert_array_equal(over[0]["weights"], ref.weights)
        assert config.collective_overlap is False
