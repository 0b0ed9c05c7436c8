"""flink_ml_tpu_torch/parallel/collectives.py against the JAX package's
collectives, on worlds of 2 and 4 gloo ranks on the CPU.

The module starts one world of each size (`parallel.launcher.World`, the
first test that needs it) and runs every case inside it; each rank runs
the jobs of tests/torch_mesh_jobs.py. The JAX side runs on
`create_mesh(("data",), devices=jax.devices()[:R])` of the eight CPU
devices tests/conftest.py forces. The cases follow
tests/test_collective_chunks.py. Tolerances (ROADMAP C.26, C.3):

- at 2 ranks every reduce gives the same bits (a + b = b + a): the
  chunked, ring, async and sparse reduces equal the monolithic reduce and
  the JAX psum bit for bit;
- at 4 ranks the backend's all-reduce associates by segment, so the
  chunked reduce is held within `SUM_ULPS` float32 rounding steps of the
  sum of the magnitudes (|got - want| <= 2^-21 x sum_r |x_r|, above the
  3 x 2^-23 x sum |x_r| any order of four float32 additions can err by);
  the async reduce equals the sync one of the same route bit for bit;
- the sparse pair reduce at 4 ranks is held allclose (rtol 1e-6,
  atol 1e-6) to the densified reduce, as C.3 holds the JAX one.
"""

import jax
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from flink_ml_tpu.obs import tracing as jax_tracing
from flink_ml_tpu.parallel import collectives as jax_coll
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.obs import tracing
from flink_ml_tpu_torch.parallel import collectives as coll
from flink_ml_tpu_torch.parallel import launcher
from flink_ml_tpu_torch.utils import metrics

#: a job's bound and each collective's (seconds): a hung rank fails its test
JOB_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 60.0
#: the four-rank bound of a reordered float32 sum, in units of sum_r |x_r|
SUM_BOUND = 2.0 ** -21


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


def _flat(tree):
    return np.concatenate([tree["a"].reshape(-1), tree["b"][0].reshape(-1),
                           tree["b"][1].reshape(-1)])


def _close_to_sum(got, want, per_rank):
    bound = SUM_BOUND * np.abs(per_rank).sum(axis=0)
    assert np.all(np.abs(got - want) <= bound), float(np.max(np.abs(got - want) - bound))


class TestChunkedParity:
    """all_reduce_sum_chunked against the monolithic reduce and the JAX psum."""

    @pytest.mark.parametrize("ranks", [2, 4])
    @pytest.mark.parametrize("chunk_bytes", [1024, 32 * 1024, None])
    @pytest.mark.parametrize("ring", [False, True])
    def test_chunked_against_monolithic(self, world, ranks, chunk_bytes, ring):
        rng = np.random.default_rng(0)
        # wide dynamic range so any reassociation of the sum would show
        x = (rng.standard_normal((ranks, 4096)).astype(np.float32)
             * np.logspace(-6, 6, 4096, dtype=np.float32))
        out = world(ranks).run("torch_mesh_jobs:reduce_tree", x, chunk_bytes, ring)
        f = jax_coll.shard_map_over(_jax_mesh(ranks), in_specs=P("data", None),
                                    out_specs=P("data", None))(lambda v: lax.psum(v, "data"))
        psum = np.asarray(jax.jit(f)(x))[0]
        for whole, chunked, pending in out:
            np.testing.assert_array_equal(_flat(pending), _flat(chunked))
            if ranks == 2:
                np.testing.assert_array_equal(_flat(chunked), _flat(whole))
                np.testing.assert_array_equal(_flat(whole), psum)
            else:
                _close_to_sum(_flat(chunked), _flat(whole), x)
                _close_to_sum(_flat(whole), psum, x)
        for whole, chunked, _ in out[1:]:
            np.testing.assert_array_equal(_flat(whole), _flat(out[0][0]))

    def test_bucket_count_follows_chunk_bytes(self, world):
        """1 KB buckets over a 16 KB payload really decompose, and the
        accounted chunk count and bytes say so (the JAX package's counters)."""
        x = np.ones((4, 4096), np.float32)
        counters = world(4).run("torch_mesh_jobs:chunk_counters", x, 1024)[0]
        assert counters.get("collective.chunked.chunks", 0) >= 16
        assert counters.get("collective.chunked.bytes", 0) == 4096 * 4
        assert counters.get("collective.chunked.calls") == 1

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_heterogeneous_dtypes(self, world, ranks):
        """float32 and int32 leaves group into per-dtype buckets, exactly."""
        xf = np.arange(ranks * 64, dtype=np.float32).reshape(ranks, 64)
        xi = np.arange(ranks * 32, dtype=np.int32).reshape(ranks, 32)
        for out_f, out_i in world(ranks).run("torch_mesh_jobs:reduce_mixed_dtypes", xf, xi, 128):
            np.testing.assert_array_equal(out_f, xf.sum(0))
            np.testing.assert_array_equal(out_i, xi.sum(0))
            assert out_i.dtype == np.int32


class TestSparseParity:
    """sparse_all_reduce_sum against the densified reduce and JAX's."""

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_matches_densified_reduce(self, world, ranks):
        dim, m = 512, 64
        rng = np.random.default_rng(1)
        idx = rng.integers(0, dim, size=(ranks, m)).astype(np.int32)
        idx[:, -3:] = -1  # padding entries drop on both paths
        idx[:, 0] = dim + 5  # out of range: dropped too
        val = rng.standard_normal((ranks, m)).astype(np.float32)
        out = world(ranks).run("torch_mesh_jobs:sparse_vs_dense", idx, val, dim)
        in_specs = (P("data", None), P("data", None))
        f = jax_coll.shard_map_over(_jax_mesh(ranks), in_specs=in_specs, out_specs=P())(
            lambda i, v: jax_coll.sparse_all_reduce_sum(i[0], v[0], dim))
        # JAX's scatter wraps a negative index (numpy indexing) before it
        # drops; its SGD feeds padding as column 0 with value 0 (`sparse_dot`'s
        # `safe`), and so does this side
        pad = idx < 0
        jax_sum = np.asarray(jax.jit(f)(np.where(pad, 0, idx), np.where(pad, 0.0, val)))
        for sparse, dense, _, _ in out:
            if ranks == 2:
                np.testing.assert_array_equal(sparse, dense)
                np.testing.assert_array_equal(sparse, jax_sum)
            else:
                np.testing.assert_allclose(sparse, dense, rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(sparse, jax_sum, rtol=1e-6, atol=1e-6)

    def test_wire_bytes_scale_with_nnz(self, world):
        """The acceptance shape (dim 1M, 39 non-zeros a row): the pair bytes
        sit >= 10x below the dense-equivalent payload, and the ratio gauge
        is below 1, as in the JAX package."""
        dim, rows, nnz = 1_000_000, 128, 39
        idx = np.zeros((2, rows * nnz), np.int32)
        val = np.zeros((2, rows * nnz), np.float32)
        _, _, counters, ratio = world(2).run("torch_mesh_jobs:sparse_vs_dense", idx, val, dim)[0]
        assert counters["collective.sparse.bytes"] == rows * nnz * 8
        assert counters["collective.sparse.bytes"] * 10 <= \
            counters["collective.sparse.dense_equiv_bytes"]
        assert 0 < ratio < 1

    def test_threshold_routing(self):
        assert coll.sparse_reduce_wins(128 * 39, 1_000_000, itemsize=4)
        assert not coll.sparse_reduce_wins(900, 1000, itemsize=4)
        for args in ((128 * 39, 1_000_000, 4), (900, 1000, 4), (5_000, 12_000, 4)):
            assert coll.sparse_reduce_wins(*args) == jax_coll.sparse_reduce_wins(*args)
        with config.collective_sparse_threshold_mode(4.0):
            assert coll.sparse_reduce_wins(25_000 * 39, 1_000_000, itemsize=4)
        assert not coll.sparse_reduce_wins(25_000 * 39, 1_000_000, itemsize=4)


class TestPrimitives:
    """Every wrapper against its definition (the lax op it stands for)."""

    @pytest.mark.parametrize("ranks", [2, 4])
    def test_each_wrapper_holds_its_definition(self, world, ranks):
        x = np.arange(ranks * ranks * 2 * 3, dtype=np.float32).reshape(ranks, ranks * 2, 3)
        out = world(ranks).run("torch_mesh_jobs:primitives", x)
        total = x.sum(0)
        for r, got in enumerate(out):
            assert (got["size"], got["index"], got["rank"]) == (ranks, r, r)
            np.testing.assert_array_equal(got["sum"], total)
            np.testing.assert_allclose(got["mean"], total / ranks, rtol=1e-7)
            np.testing.assert_array_equal(got["max"], x.max(0))
            np.testing.assert_array_equal(got["min"], x.min(0))
            np.testing.assert_array_equal(got["gather0"], np.concatenate(list(x), axis=0))
            np.testing.assert_array_equal(got["gather1"], np.concatenate(list(x), axis=1))
            np.testing.assert_array_equal(got["stacked"], x)
            np.testing.assert_array_equal(got["scatter"], total.reshape(ranks, 2, 3)[r])
            np.testing.assert_array_equal(got["ring"], x[(r - 1) % ranks])
            np.testing.assert_array_equal(got["ring2"], x[(r - 2) % ranks])

    def test_the_same_definitions_as_jax(self):
        """The JAX wrappers on a 2-device mesh give what the port's
        definitions above say (psum_scatter tiles, ppermute shifts up)."""
        x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
        specs = dict(in_specs=P("data", None, None), out_specs=P("data", None, None))
        f = jax_coll.shard_map_over(_jax_mesh(2), **specs)(
            lambda v: jax_coll.reduce_scatter(v[0], "data")[None])
        np.testing.assert_array_equal(np.asarray(jax.jit(f)(x)), x.sum(0).reshape(2, 2, 3))
        g = jax_coll.shard_map_over(_jax_mesh(2), **specs)(
            lambda v: jax_coll.ppermute_ring(v, "data"))
        np.testing.assert_array_equal(np.asarray(jax.jit(g)(x)), x[::-1])

    def test_a_mesh_of_one_rank_is_the_identity(self):
        from flink_ml_tpu_torch.parallel import mesh

        m = mesh.Mesh(("data",), (1,))
        t = np.arange(6, dtype=np.float32)
        import torch

        x = torch.from_numpy(t)
        for fn in (coll.all_reduce_sum, coll.all_reduce_mean, coll.all_reduce_max,
                   coll.reduce_scatter, coll.ppermute_ring):
            assert torch.equal(fn(x, mesh=m), x)
        assert torch.equal(coll.all_gather(x, tiled=False, mesh=m), x[None])
        assert torch.equal(coll.all_reduce_sum_chunked(x, mesh=m), x)
        assert coll.axis_size(mesh=m) == 1 and coll.axis_index(mesh=m) == 0


class TestGlooStaging:
    """The gloo branch stages through pinned host copies only the
    operations gloo has no CUDA form of (C.27); NCCL and CPU tensors never."""

    class _Fake:
        def __init__(self, is_cuda):
            self.is_cuda = is_cuda

    @pytest.mark.parametrize("backend,op,cuda,staged", [
        ("gloo", "p2p", True, True), ("gloo", "all_reduce", True, False),
        ("gloo", "all_gather", True, False), ("gloo", "reduce_scatter", True, False),
        ("gloo", "p2p", False, False), ("nccl", "p2p", True, False),
        ("nccl", "all_reduce", True, False)])
    def test_staging_rule(self, monkeypatch, backend, op, cuda, staged):
        import torch.distributed as dist

        monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
        assert coll._staged(object(), [self._Fake(cuda)], op) is staged


class TestHostReduce:
    def test_counts_each_call_and_captures_nothing(self):
        """host_all_reduce_sum sums the partials on the rank's device; each
        call is counted (calls, bytes) and nothing is captured (the JAX
        package's compile-once contract has no compile to count here)."""
        from flink_ml_tpu_torch.parallel import mesh

        m = mesh.Mesh(("data",), (1,), device="cpu")
        partials = [np.full((37,), float(i), np.float32) for i in range(8)]
        before = metrics.snapshot()
        for _ in range(3):
            out = coll.host_all_reduce_sum(m, partials)
        delta = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
        np.testing.assert_array_equal(out.numpy(), np.full((37,), 28.0))
        assert delta["collective.host_all_reduce_sum.calls"] == 3
        assert delta["collective.host_all_reduce_sum.bytes"] == 3 * 8 * 37 * 4
        assert "jit.compiles" not in delta


class TestAccounting:
    def test_payload_bytes_counts_nested_pairs(self):
        import torch

        tree = {"dense": np.zeros((10,), np.float32),
                "sparse": (torch.zeros((6,), dtype=torch.int32), torch.zeros((6,)))}
        assert coll.payload_bytes(tree) == 40 + 48
        assert coll.payload_bytes([tree, tree]) == 2 * (40 + 48)
        jtree = {"dense": np.zeros((10,), np.float32),
                 "sparse": (np.zeros((6,), np.int32), np.zeros((6,), np.float32))}
        assert coll.payload_bytes(tree) == jax_coll.payload_bytes(jtree)

    def test_sparse_ratio_gauge_as_jax(self):
        """The port's account_collective moves the same counters and gauge
        the JAX one does."""
        deltas = []
        for registry, account in ((metrics, tracing.account_collective),
                                  (jax_metrics, jax_tracing.account_collective)):
            before = registry.snapshot()
            account("sparse_allreduce", 100, 1, "data", dense_equiv_bytes=1000)
            account("chunked", 64, 3, "data")
            deltas.append(registry.snapshot_delta(before, registry.snapshot())["counters"])
        assert deltas[0] == deltas[1]
        ratio = metrics.snapshot()["gauges"]["collective.sparse_ratio"]
        assert ratio == metrics.get_counter("collective.sparse.bytes") / \
            metrics.get_counter("collective.sparse.dense_equiv_bytes")

    def test_axis_wire_bytes(self):
        delta = {"counters": {"collective.axis.data.bytes": 12, "collective.psum.bytes": 3}}
        assert coll.axis_wire_bytes(delta) == {"data": 12} == jax_coll.axis_wire_bytes(delta)

    def test_the_knobs_keep_the_jax_names_and_defaults(self):
        from flink_ml_tpu import config as jax_config

        for name in ("collective_chunk_bytes", "collective_sparse_threshold", "collective_ring",
                     "collective_overlap"):
            assert getattr(config, name) == getattr(jax_config, name), name
        for arg in (None, 0, -1, 1024):
            assert config.resolve_chunk_bytes(arg) == jax_config.resolve_chunk_bytes(arg)
        with config.collective_overlap_mode(True):
            assert config.collective_overlap is True
        assert config.collective_overlap is False

    def test_a_model_axis_collective_waits_for_the_2d_layout(self):
        from flink_ml_tpu_torch.parallel import mesh

        m = mesh.Mesh(("data", "model"), (1, 2))
        import torch

        # the 2D layout is ported: over a world a model-axis collective runs
        # (tests/test_torch_mesh2d.py); a hand-made mesh of ranks without one
        # is refused, and an axis of one is the identity
        with pytest.raises(ValueError, match="no process group"):
            coll.all_reduce_sum(torch.zeros(2), axis_name="model", mesh=m)
        x = torch.arange(2.0)
        assert coll.all_reduce_sum(x, axis_name="model", mesh=mesh.Mesh(("data", "model"),
                                                                        (1, 1))) is x
        with pytest.raises(ValueError, match="not an axis"):
            coll.all_reduce_sum(torch.zeros(2), axis_name="fleet", mesh=mesh.Mesh(("data",), (1,)))
