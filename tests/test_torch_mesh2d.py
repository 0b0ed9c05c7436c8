"""The 2D `(data, model)` layout of flink_ml_tpu_torch: `mesh.create_mesh_2d`
and the rank shardings, the per-axis collectives and their accounting, the
feature-sharded losses and the 2D SGD loop (`overlap.sgd2d_*`), the
budget admission of a model-axis slice and the 2D checkpoints, against
the JAX package's tests/test_sparse_2d_mesh.py.

The module opens one world of 4 gloo ranks and one of 2 on the CPU
(`parallel.launcher.World`, each at the first test that needs it) and runs
every world case inside them, through the jobs of
tests/torch_mesh2d_jobs.py; a job makes its 2D mesh with
`create_mesh_2d`. The JAX side runs on `create_mesh_2d(m,
devices=jax.devices()[:R])` of its 8-device CPU mesh. Tolerances:

- placements (which block of an array a rank holds) equal the JAX
  sharding's shard of that device exactly; the per-axis counters of one
  call equal the JAX package's exactly;
- a one-model-shard 2D fit equals the port's 1D sharded fit on the same
  ranks bit for bit (the same reduce, ops/losses.py `_feature_sharded`);
- a 2D fit on 2 x 2 and 1 x 4, and the `sparse_2d="off"` reference, are
  within rtol 3e-5 / atol 3e-6 of the JAX 2D (or off) fit on the same
  factorization and of the port's flat fit (the JAX package's
  multi-shard tolerance, test_sparse_2d_mesh.py:218), the same epochs;
- every rank of a model column ends with the same slice and every rank
  with the same model, bit for bit;
- a checkpointed 2D fit equals the unchecked one bit for bit; a cut
  resumed onto another factorization or rank count is within the
  multi-shard tolerance of the unkilled fit, the same epochs.
"""

import jax
import numpy as np
import pytest
import torch

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import config as jax_config
from flink_ml_tpu.ckpt import snapshot as jax_snapshot
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_optimizer
from flink_ml_tpu.parallel import collectives as jax_collectives
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import config
from flink_ml_tpu_torch.ckpt import snapshot
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import launcher, mesh

JOB_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 60.0
TOL_2D = dict(rtol=3e-5, atol=3e-6)
FIT = dict(max_iter=6, global_batch_size=32, tol=0.0)


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


def _problem(n=128, d=30, nnz=5, seed=7):
    """Ragged padded-CSR rows (-1 padding) and separable {0, 1} labels
    (tests/test_sparse_2d_mesh.py `_sparse_problem`)."""
    rng = np.random.default_rng(seed)
    indices = np.full((n, nnz), -1, np.int32)
    values = np.zeros((n, nnz), np.float64)
    for i in range(n):
        k = rng.integers(1, nnz + 1)
        cols = np.sort(rng.choice(d, size=k, replace=False))
        indices[i, :k] = cols
        values[i, :k] = rng.random(k)
    truth = rng.random(d) - 0.5
    dense = np.zeros((n, d))
    np.add.at(dense, (np.arange(n)[:, None], np.clip(indices, 0, d - 1)),
              np.where(indices >= 0, values, 0.0))
    return indices, values, (dense @ truth > 0).astype(np.float64)


def _jax_mesh(shape):
    devices = jax.devices()[:int(np.prod(shape))]
    if len(shape) == 1:
        return jax_mesh.create_mesh(("data",), devices=devices)
    return jax_mesh.create_mesh_2d(shape[1], devices=devices)


def _jax_fit(shape, indices, values, y, d, mode="auto", **kw):
    kw = {**FIT, **kw}
    m = _jax_mesh(shape)
    with jax_config.sparse_2d_mode(mode), jax_mesh.use_mesh(m):
        coeff, crit, epochs = jax_optimizer.SGD(shard_features=True, **kw).optimize(
            np.zeros(d), (indices, values), y, None, jax_losses.SPARSE_BINARY_LOGISTIC_LOSS,
            mesh=m)
    return np.asarray(coeff), float(crit), int(epochs)


def _flat_fit(indices, values, y, d, **kw):
    with config.use_device("cpu"):
        return optimizer.SGD(**{**FIT, **kw}).optimize(
            np.zeros(d), (indices, values), y, None, losses.SPARSE_BINARY_LOGISTIC_LOSS)


def _same_on_every_rank(out):
    for r in out[1:]:
        np.testing.assert_array_equal(r[0], out[0][0])
        assert r[1:3] == out[0][1:3]


# ---------------------------------------------------------------------------
# the mesh, its shardings and the knobs (no world)
# ---------------------------------------------------------------------------

class TestShardings:
    @pytest.mark.parametrize("ndim,want", [(2, ("data", "model")), (3, ("data", None, "model"))])
    def test_data_model_sharding_specs_as_jax(self, ndim, want):
        m2 = mesh.Mesh(("data", "model"), (2, 2))
        jm2 = _jax_mesh((2, 2))
        assert tuple(mesh.data_model_sharding(m2, ndim).spec) == want == tuple(
            jax_mesh.data_model_sharding(jm2, ndim).spec)
        with pytest.raises(ValueError, match="ndim >= 2"):
            mesh.data_model_sharding(m2, ndim=1)

    def test_model_sharding_without_a_model_axis_is_replicated(self):
        m1 = mesh.Mesh(("data",), (4,))
        assert tuple(mesh.model_sharding(m1).spec) == () == tuple(
            jax_mesh.model_sharding(_jax_mesh((4,))).spec)
        assert tuple(mesh.data_model_sharding(m1).spec) == ("data", None)
        assert tuple(mesh.model_sharding(mesh.Mesh(("data", "model"), (2, 2))).spec) == (
            "model",)

    @pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
    @pytest.mark.parametrize("which", ["data_model", "model", "fleet", "data"])
    def test_a_rank_takes_the_block_its_device_holds_in_jax(self, shape, which):
        arr2 = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
        arr1 = np.arange(12, dtype=np.float32)
        jm = _jax_mesh(shape)
        arr, (port_fn, jax_fn) = {
            "data_model": (arr2, (mesh.data_model_sharding, jax_mesh.data_model_sharding)),
            "model": (arr1, (mesh.model_sharding, jax_mesh.model_sharding)),
            "fleet": (arr2, (mesh.fleet_sharding, jax_mesh.fleet_sharding)),
            "data": (arr2, (mesh.data_sharding, jax_mesh.data_sharding)),
        }[which]
        placed = jax.device_put(arr, jax_fn(jm, arr.ndim))
        shards = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
        for r, device in enumerate(jm.devices.flat):
            m = mesh.Mesh(("data", "model"), shape, rank=r)
            got = port_fn(m, arr.ndim).take(arr)
            np.testing.assert_array_equal(got, shards[device.id])
            np.testing.assert_array_equal(port_fn(m, arr.ndim).take(torch.from_numpy(arr)).numpy(),
                                          shards[device.id])

    def test_a_padded_model_slice_is_zero_filled(self):
        m = mesh.Mesh(("data", "model"), (1, 4), rank=3)
        sharding = mesh.model_sharding(m)
        assert sharding.bounds((30,)) == [(24, 32)]
        np.testing.assert_array_equal(sharding.take(np.arange(30.0)),
                                      [24, 25, 26, 27, 28, 29, 0, 0])

    @pytest.mark.parametrize("tag", ["data", "model", "replicated", "host"])
    @pytest.mark.parametrize("ndim", [0, 1, 2, 3])
    def test_shard_axis_for_tag_as_jax(self, tag, ndim):
        assert mesh.shard_axis_for_tag(tag, ndim) == jax_mesh.shard_axis_for_tag(tag, ndim)

    @pytest.mark.parametrize("shape,hosts", [((2, 2), 2), ((4, 1), 4), ((1, 4), 1), ((2, 2), 4)])
    def test_host_groups_are_the_jax_device_groups(self, shape, hosts):
        m = mesh.Mesh(("data", "model"), shape)
        jm = _jax_mesh(shape)
        flat = [d.id for d in jm.devices.flat]
        want = [[flat.index(d.id) for d in g] for g in jax_mesh.host_groups(jm, hosts)]
        assert mesh.host_groups(m, hosts) == want
        with pytest.raises(ValueError):
            mesh.host_groups(m, 0)

    def test_mode_off_disables_2d_routing(self):
        m2 = mesh.Mesh(("data", "model"), (2, 2))
        sgd = optimizer.SGD(max_iter=2, shard_features=True)
        with config.sparse_2d_mode("off"):
            assert not sgd._use_2d(m2, losses.SPARSE_BINARY_LOGISTIC_LOSS)
        assert sgd._use_2d(m2, losses.SPARSE_BINARY_LOGISTIC_LOSS)
        assert sgd._use_2d(m2, losses.PLAIN_SPARSE_VARIANTS["binary_logistic"])
        assert not sgd._use_2d(m2, losses.BINARY_LOGISTIC_LOSS)
        assert not sgd._use_2d(mesh.Mesh(("data",), (4,)), losses.SPARSE_BINARY_LOGISTIC_LOSS)
        assert not optimizer.SGD()._use_2d(m2, losses.SPARSE_BINARY_LOGISTIC_LOSS)

    @pytest.mark.parametrize("kind", ["user", "2d"])
    def test_a_sparse_loss_with_no_2d_form_raises(self, kind):
        """A loss marked sparse that has no feature-sharded form (a user's
        four-field LossFunc, or a 2D loss given as the fit's loss) raises a
        ValueError naming it on a data x model mesh; off that mesh, or
        without `shard_features`, it routes as before."""
        base = losses.SPARSE_BINARY_LOGISTIC_LOSS
        loss = (losses.LossFunc("my_sparse", base.fn, base.pointwise, True) if kind == "user"
                else losses.feature_sharded_variant(base))
        assert loss.sparse and loss.name not in losses.FEATURE_SHARDED_VARIANTS
        m2 = mesh.Mesh(("data", "model"), (2, 2))
        with pytest.raises(ValueError, match=f"{loss.name!r} has no feature-sharded"):
            optimizer.SGD(max_iter=2, shard_features=True)._use_2d(m2, loss)
        assert not optimizer.SGD(max_iter=2)._use_2d(m2, loss)
        assert not optimizer.SGD(max_iter=2, shard_features=True)._use_2d(
            mesh.Mesh(("data",), (4,)), loss)
        with config.sparse_2d_mode("off"):
            assert not optimizer.SGD(max_iter=2, shard_features=True)._use_2d(m2, loss)

    def test_the_2d_knobs_as_jax(self, monkeypatch):
        assert config.sparse_2d == jax_config.sparse_2d == "auto"
        with pytest.raises(ValueError, match="'auto' or 'off'"):
            with config.sparse_2d_mode("on"):
                pass
        with config.fleet_shard_threshold(7), jax_config.fleet_shard_threshold(7):
            assert config.fleet_shard_state_bytes == jax_config.fleet_shard_state_bytes == 7
        assert config.fleet_shard_state_bytes == jax_config.fleet_shard_state_bytes

    def test_the_2d_variants_are_named_and_banked(self):
        for name in ("binary_logistic", "hinge", "least_square"):
            loss2d = losses.feature_sharded_variant(losses.SPARSE_VARIANTS[name])
            assert loss2d.name == jax_losses.FEATURE_SHARDED_VARIANTS[
                jax_losses.SPARSE_VARIANTS[name].name].name
            assert losses.by_name(loss2d.name) is loss2d
            plain = losses.feature_sharded_variant(losses.PLAIN_SPARSE_VARIANTS[name])
            assert plain.name == "plain_" + loss2d.name and plain is not loss2d

    def test_the_2d_loss_on_one_rank_is_the_sparse_loss(self):
        """On a mesh of one rank (every axis of one) the 2D loss owns every
        feature: its (loss, grad, weight) equal the 1D sparse loss's bit for
        bit."""
        indices, values, y = _problem(n=40, d=30, seed=3)
        one = mesh.Mesh(("data", "model"), (1, 1), device="cpu")
        rng = np.random.default_rng(4)
        coeff = torch.from_numpy(rng.standard_normal(30).astype(np.float32))
        X = (torch.from_numpy(indices), torch.from_numpy(values.astype(np.float32)))
        yt, w = torch.from_numpy(y.astype(np.float32)), torch.ones(40)
        want = losses.SPARSE_BINARY_LOGISTIC_LOSS(X, yt, w, coeff)
        got = losses.FEATURE_SHARDED_BINARY_LOGISTIC_LOSS.fn(X, yt, w, coeff, one)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), wv.numpy())


# ---------------------------------------------------------------------------
# a world of 4 ranks
# ---------------------------------------------------------------------------

class TestCreateMesh2D:
    @pytest.mark.parametrize("m", [1, 2, 4])
    def test_factorizes_model_innermost(self, world, m):
        out = world(4).run("torch_mesh2d_jobs:mesh_info", m)
        for r, info in enumerate(out):
            assert info["shape"] == {"data": 4 // m, "model": m} and info["rank"] == r
            assert info["coords"] == {"data": r // m, "model": r % m}
            row, col = r // m, r % m
            assert info["groups"]["model"] == [row * m + j for j in range(m)]
            assert info["groups"]["data"] == [i * m + col for i in range(4 // m)]

    @pytest.mark.parametrize("m,hosts,match", [(3, None, "does not divide"),
                                               (0, None, "must be >= 1"),
                                               (4, 3, "straddle"), (2, 3, "straddle")])
    def test_refused_as_jax(self, world, m, hosts, match):
        for info in world(4).run("torch_mesh2d_jobs:mesh_info", m, hosts):
            assert match in info["error"]
        with pytest.raises(ValueError, match=match):
            jax_mesh.create_mesh_2d(m, devices=jax.devices()[:4], num_hosts=hosts)

    def test_host_alignment_accepts_whole_rows(self, world):
        for info in world(4).run("torch_mesh2d_jobs:mesh_info", 2, 2):
            assert info["shape"] == {"data": 2, "model": 2}
            assert info["hosts"] == [[0, 1], [2, 3]]


class TestTwoAxisAccounting:
    def test_the_same_counters_as_jax_for_the_same_call(self, world):
        """A pair exchange over `data` and a psum over `model`: the per-axis
        counters, the sparse sub-counters and the data-axis ratio gauge are
        the JAX package's for the same body; nothing sparse on `model`."""
        dim = 64
        out = world(4).run("torch_mesh2d_jobs:two_axis_accounting", dim)

        def body(idx, val):
            g = jax_collectives.sparse_all_reduce_sum(idx, val, dim, jax_collectives.DATA_AXIS)
            return g + jax_collectives.all_reduce_sum(jax.numpy.sum(g),
                                                      jax_collectives.MODEL_AXIS)

        from jax.sharding import PartitionSpec as P

        mapped = jax_collectives.shard_map_over(_jax_mesh((2, 2)), (P(), P()), P(), fn=body)
        before = jax_metrics.snapshot()
        want = np.asarray(jax.jit(mapped)(jax.numpy.arange(4, dtype=jax.numpy.int32),
                                          jax.numpy.ones(4, jax.numpy.float32)))
        delta = jax_metrics.snapshot_delta(before, jax_metrics.snapshot())
        # the collectives' counters (the JAX side also counts its program's
        # compiles, `jit.compiles`, when its compile listener is installed)
        want_counters = {k: v for k, v in delta["counters"].items()
                         if k.startswith("collective.")}
        for counters, gauges, wire, value in out:
            assert counters == want_counters
            assert gauges["collective.sparse_ratio.data"] == delta["gauges"][
                "collective.sparse_ratio.data"]
            assert "collective.sparse_ratio.model" not in gauges
            assert wire == jax_collectives.axis_wire_bytes(delta)
            np.testing.assert_array_equal(value, want)

    def test_a_2d_fit_routes_its_traffic_to_both_axes(self, world):
        """Per epoch `model` carries the (b_local, nnz) active values and
        `data` the dense payload [grad slice | loss | weight]; the fit ends
        with one gather of the (d_local + 2,) block over `model`."""
        indices, values, y = _problem(n=64, d=16, nnz=4, seed=2)
        out = world(4).run("torch_mesh2d_jobs:sparse_fit", (2, 2), (indices, values), y, 16,
                           dict(FIT, max_iter=2))
        for r in out:
            counters, wire = r[3], r[4]
            b_local, d_local = 16, 8
            assert wire["model"] == 2 * b_local * 4 * 4 + (d_local + 2) * 4
            assert wire["data"] == 2 * (d_local + 2) * 4
            assert counters["collective.axis.model.calls"] == 3
            assert counters["collective.axis.data.calls"] == 2
            assert counters["dispatch.whole_fit_fallback.mesh"] == 1

    def test_every_rank_records_the_same_collectives(self, world):
        indices, values, y = _problem(n=64, d=16, nnz=4, seed=2)
        for problems in world(4).run("torch_mesh2d_jobs:sequences_2d", (indices, values), y, 16,
                                     dict(FIT, max_iter=3)):
            assert problems == []


class TestParity:
    @pytest.mark.parametrize("ranks", [2, 4])
    def test_a_single_feature_shard_equals_the_1d_sharded_fit(self, world, ranks):
        indices, values, y = _problem(n=128, d=30, seed=7)
        one_d = world(ranks).run("torch_mesh2d_jobs:sparse_fit", (ranks,), (indices, values), y,
                                 30, FIT)
        two_d = world(ranks).run("torch_mesh2d_jobs:sparse_fit", (ranks, 1), (indices, values), y,
                                 30, FIT)
        _same_on_every_rank(two_d)
        np.testing.assert_array_equal(two_d[0][0], one_d[0][0])
        assert two_d[0][1:3] == one_d[0][1:3] and two_d[0][2] == 6
        assert two_d[0][4]["model"] > 0 and "model" not in one_d[0][4]

    @pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
    def test_multi_shard_allclose_to_jax_and_flat(self, world, shape):
        indices, values, y = _problem(n=128, d=30, seed=7)
        out = world(4).run("torch_mesh2d_jobs:sparse_fit", shape, (indices, values), y, 30, FIT)
        _same_on_every_rank(out)
        coeff, crit, epochs = out[0][:3]
        for ref in (_jax_fit(shape, indices, values, y, 30), _flat_fit(indices, values, y, 30)):
            np.testing.assert_allclose(coeff, ref[0], **TOL_2D)
            assert abs(crit - ref[1]) < 1e-5 and epochs == ref[2] == 6

    def test_every_rank_of_a_model_column_holds_the_same_slice(self, world):
        indices, values, y = _problem(n=128, d=30, seed=8)
        out = world(4).run("torch_mesh2d_jobs:sparse_fit", (2, 2), (indices, values), y, 30, FIT)
        np.testing.assert_array_equal(out[0][6], out[2][6])  # model column 0: ranks 0, 2
        np.testing.assert_array_equal(out[1][6], out[3][6])  # model column 1: ranks 1, 3
        np.testing.assert_array_equal(np.concatenate([out[0][6], out[1][6]]), out[0][0])
        _same_on_every_rank(out)

    def test_sparse_2d_off_is_the_replicated_reference(self, world):
        """`sparse_2d="off"` on 2 x 2 trains the replicated coefficient with
        its rows over all four ranks (`mesh.flatten`, C.36): one reduce of
        [grad | loss | weight] an epoch and no model-axis traffic (it never
        routes 2D quietly); within the multi-shard tolerance of the JAX
        GSPMD reference and of the 2D fit."""
        indices, values, y = _problem(n=128, d=30, seed=7)
        off = world(4).run("torch_mesh2d_jobs:sparse_fit", (2, 2), (indices, values), y, 30, FIT,
                           "off")
        _same_on_every_rank(off)
        assert off[0][4] == {"data": 6 * (30 + 2) * 4}
        ref = _jax_fit((2, 2), indices, values, y, 30, mode="off")
        np.testing.assert_allclose(off[0][0], ref[0], **TOL_2D)
        auto = world(4).run("torch_mesh2d_jobs:sparse_fit", (2, 2), (indices, values), y, 30, FIT)
        np.testing.assert_allclose(auto[0][0], off[0][0], **TOL_2D)
        assert auto[0][2] == off[0][2] == ref[2] == 6

    @pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
    def test_a_sparse_estimator_on_a_2d_default_mesh_trains_feature_sharded(self, world, shape):
        indices, values, y = _problem(n=120, d=24, nnz=4, seed=12)
        params = {"max_iter": 6, "global_batch_size": 32}
        out = world(4).run("torch_mesh2d_jobs:estimator_fit_2d", shape,
                           {"features": ("sparse", 24, indices, values), "label": y}, params)
        for r in out[1:]:
            np.testing.assert_array_equal(r, out[0])
        est = jax_lr.LogisticRegression().set_max_iter(6).set_global_batch_size(32)
        with jax_mesh.use_mesh(_jax_mesh(shape)):
            ref = est.fit(JaxTable({"features": JaxSparseBatch(24, indices, values), "label": y}))
        np.testing.assert_allclose(out[0], ref.coefficient, **TOL_2D)


class TestBeyondBudget:
    def test_a_wide_model_trains_2d_but_not_replicated(self, world):
        """d = 200,000 float32: one replicated coefficient is 800 KB. Under a
        600 KB per-rank budget the 1 x 4 mesh admits its 2 x 200 KB slices
        and trains; the replicated layout on the (4,) mesh is refused at
        admission (`HbmBudgetExceeded`) before its carries are copied."""
        d = 200_000
        rng = np.random.default_rng(11)
        indices = rng.integers(0, d, size=(256, 4)).astype(np.int32)
        values = rng.random((256, 4))
        y = rng.integers(0, 2, size=256).astype(np.float64)
        kw = dict(max_iter=2, global_batch_size=128, tol=0.0)
        out = world(4).run("torch_mesh2d_jobs:sparse_fit", (1, 4), (indices, values), y, d, kw,
                           "auto", False, 3 * d)
        for r in out:
            assert r[2] == 2 and r[0].shape == (d,) and np.all(np.isfinite(r[0]))
            assert r[7] <= 3 * d
        for r in world(4).run("torch_mesh2d_jobs:sparse_fit", (4,), (indices, values), y, d, kw,
                              "auto", False, 3 * d):
            assert r[0] == "HbmBudgetExceeded" and r[1] == 2 * 4 * d  # coeff + grad, one staging


class TestCheckpoint2D:
    KW = dict(max_iter=8, global_batch_size=32, tol=0.0, checkpoint_interval=2)

    def test_checkpointed_2d_matches_uncheckpointed(self, world, tmp_path):
        indices, values, y = _problem(n=96, d=16, nnz=4, seed=9)
        plain = world(4).run("torch_mesh2d_jobs:sparse_fit", (2, 2), (indices, values), y, 16,
                             dict(self.KW))
        ckpt = world(4).run("torch_mesh2d_jobs:checkpointed_fit", (2, 2), (indices, values), y,
                            16, self.KW, str(tmp_path), "c2d")
        for r in ckpt:
            np.testing.assert_array_equal(r[0], plain[0][0])
            assert r[2] == plain[0][2] == 8
        assert len([f for f in tmp_path.iterdir() if f.name.endswith(".manifest.json")]) >= 1

    @pytest.mark.parametrize("resume", [(1, 4), (4, 1), (2, 2), (4,), "one rank"])
    def test_a_2d_cut_resumes_on_another_factorization(self, world, tmp_path, resume):
        """A 2 x 2 fit killed after its third drained chunk (a rank cut at
        epoch 6) resumes on another factorization, on the data mesh, or on
        one rank; the JAX package reads the same cut."""
        indices, values, y = _problem(n=96, d=30, nnz=4, seed=5)
        ckpt = str(tmp_path)
        killed = world(4).run("torch_mesh2d_jobs:checkpointed_fit", (2, 2), (indices, values), y,
                              30, self.KW, ckpt, "el2d", 3)
        assert killed == ["killed"] * 4
        snap = snapshot.load_job_snapshot(ckpt, "el2d",
                                          templates={"model": optimizer._carry_template(30)})
        jax_snap = jax_snapshot.load_job_snapshot(ckpt, "el2d", templates={
            "model": (np.zeros(30, np.float32), np.zeros(30, np.float32), np.float32(0),
                      np.int32(0))})
        assert snap.epoch == jax_snap.epoch == 6 and snap.specs["model"][0] == "model"
        for a, b in zip(snap.sections["model"], jax_snap.sections["model"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if resume == "one rank":
            with config.use_device("cpu"):
                got = optimizer.SGD(shard_features=True, checkpoint_dir=ckpt,
                                    checkpoint_key="el2d", **self.KW).optimize(
                    np.zeros(30), (indices, values), y, None, losses.SPARSE_BINARY_LOGISTIC_LOSS)
        else:
            got = world(4).run("torch_mesh2d_jobs:checkpointed_fit", resume, (indices, values), y,
                               30, self.KW, ckpt, "el2d")[0]
        want = world(4).run("torch_mesh2d_jobs:sparse_fit", (2, 2), (indices, values), y, 30,
                            dict(self.KW))[0]
        np.testing.assert_allclose(np.asarray(got[0]), want[0], **TOL_2D)
        assert got[2] == want[2] == 8
