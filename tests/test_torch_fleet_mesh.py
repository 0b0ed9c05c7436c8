"""FitFleet on a mesh of ranks (fleet.py's two regimes, the default-regime
epochs of ops/optimizer.py, kmeans.py `_lloyd_fleet_sharded`) against the
port's solo fits and the JAX package's fleet on its R-device CPU mesh,
the cases of tests/test_fleet.py that need a mesh.

The fault this slice repairs: the fleet used to ignore the default mesh,
so on R > 1 ranks every rank trained every member on all the rows, and a
member equalled the port's flat fit instead of its solo fit on the same
mesh: before the repair, 4 of 4 members of a dense LR fleet on 4 ranks
differed from their 4-rank solo fits (by up to 1.5e-8), and
`test_a_default_regime_member_equals_its_solo_fit_on_the_same_mesh`
fails there.

The module opens one world of 2 and one of 4 gloo ranks on the CPU and
runs the fleets there through tests/torch_mesh2d_jobs.py. Held to:

- the default regime: each member equals its solo fit on the same mesh
  bit for bit (the member's own reduce is the solo fit's reduce), every
  rank ends with the same members;
- the fleet-sharded regime (`shard_fleet_axis=True`, or a state size
  above `fleet_shard_threshold`): each member equals its solo fit on one
  rank bit for bit (each rank trains whole members over every row);
- both regimes against the JAX fleet in the same regime on R devices:
  coefficients rtol 1e-4 / atol 1e-6, KMeans centroids rtol 1e-5 /
  atol 1e-5 and the counts equal (tests/test_torch_fleet.py's
  tolerances);
- a checkpointed fleet on ranks killed at a chunk resumes to the unkilled
  fleet bit for bit, in both regimes.
"""

import jax
import numpy as np
import pytest

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import fleet as jax_fleet
from flink_ml_tpu.models.classification import linearsvc as jax_svc
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.models.regression import linearregression as jax_linreg
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.parallel import launcher

JOB_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 60.0
COEFF_TOL = dict(rtol=1e-4, atol=1e-6)
CENTROID_TOL = dict(rtol=1e-5, atol=1e-5)
SPARSE_D = 40
JAX_KINDS = {"lr": jax_lr.LogisticRegression, "svc": jax_svc.LinearSVC,
             "linreg": jax_linreg.LinearRegression, "kmeans": jax_kmeans.KMeans}
MEMBERS = [
    {"max_iter": 9, "global_batch_size": 64, "tol": 0.0},
    {"max_iter": 9, "global_batch_size": 64, "tol": 0.0, "learning_rate": 0.05, "reg": 0.1},
    {"max_iter": 9, "global_batch_size": 64, "tol": 0.0, "reg": 0.07, "elastic_net": 0.3},
    {"max_iter": 4, "global_batch_size": 64, "tol": 0.0, "learning_rate": 0.2},
]
KMEANS_MEMBERS = [{"k": 3, "seed": s, "max_iter": m} for s, m in [(1, 6), (2, 5), (3, 6), (4, 3)]]


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


def _columns(kind, layout, seed=0, n=300, d=12):
    rng = np.random.default_rng(seed)
    if layout == "sparse":
        indices = rng.integers(0, SPARSE_D, size=(n, 6)).astype(np.int32)
        indices[rng.random((n, 6)) < 0.2] = -1
        values = rng.random((n, 6))
        truth = rng.standard_normal(SPARSE_D)
        dots = np.where(indices >= 0, values * truth[np.clip(indices, 0, SPARSE_D - 1)], 0).sum(1)
        features = ("sparse", SPARSE_D, indices, values)
    else:
        features = rng.standard_normal((n, d))
        dots = features @ rng.standard_normal(d)
    y = dots + 0.1 * rng.standard_normal(n) if kind == "linreg" else (dots > 0).astype(float)
    return {"features": features, "label": y}


def _jax_table(columns):
    f = columns["features"]
    if isinstance(f, tuple):
        f = JaxSparseBatch(f[1], f[2], f[3])
    return JaxTable({**columns, "features": f})


def _jax_fleet(kind, columns, members, ranks, shard):
    ests = []
    for params in members:
        est = JAX_KINDS[kind]()
        for name, value in params.items():
            getattr(est, f"set_{name}")(value)
        ests.append(est)
    with jax_mesh.use_mesh(jax_mesh.create_mesh(("data",), devices=jax.devices()[:ranks])):
        return jax_fleet.FitFleet(ests, shard_fleet_axis=shard).fit(_jax_table(columns))


def _flat_solo(kind, columns, params):
    from flink_ml_tpu_torch import SparseBatch

    f = columns["features"]
    if isinstance(f, tuple):
        f = SparseBatch(f[1], f[2], f[3])
    cls = {"lr": LogisticRegression, "kmeans": KMeans}.get(kind)
    if cls is None:
        from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC
        from flink_ml_tpu_torch.models.regression.linearregression import LinearRegression

        cls = {"svc": LinearSVC, "linreg": LinearRegression}[kind]
    est = cls()
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
    with config.use_device("cpu"):
        return est.fit(Table({**columns, "features": f}))


def _all_ranks_equal(out, key):
    for r in out[1:]:
        for a, b in zip(r[0], out[0][0]):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("kind,layout", [("lr", "dense"), ("lr", "sparse"), ("svc", "dense"),
                                         ("linreg", "dense"), ("svc", "sparse")])
def test_a_default_regime_member_equals_its_solo_fit_on_the_same_mesh(world, ranks, kind,
                                                                       layout):
    columns = _columns(kind, layout, seed=ranks)
    out = world(ranks).run("torch_mesh2d_jobs:fleet_fit", None, kind, columns, MEMBERS)
    members, solos, gauges, counters = out[0]
    assert gauges == {"sharded": 0.0, "size": 4}
    assert counters["dispatch.whole_fit_fallback.mesh"] == 1
    _all_ranks_equal(out, "coefficient")
    for m, s in zip(members, solos):
        np.testing.assert_array_equal(m["coefficient"], s["coefficient"])
    ref = _jax_fleet(kind, columns, MEMBERS, ranks, None)
    for m, j in zip(members, ref):
        np.testing.assert_allclose(m["coefficient"], j.coefficient, **COEFF_TOL)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("kind,layout", [("lr", "dense"), ("lr", "sparse"), ("linreg", "dense")])
def test_a_fleet_sharded_member_equals_its_solo_fit_on_one_shard(world, ranks, kind, layout):
    columns = _columns(kind, layout, seed=10 + ranks)
    out = world(ranks).run("torch_mesh2d_jobs:fleet_fit", None, kind, columns, MEMBERS, False,
                           True)
    members, _, gauges, counters = out[0]
    assert gauges == {"sharded": 1.0, "size": 4}
    assert counters["collective.all_gather.calls"] == 1
    assert counters.get("collective.psum.calls", 0) == 0  # nothing adds across members
    _all_ranks_equal(out, "coefficient")
    for m, params in zip(members, MEMBERS):
        np.testing.assert_array_equal(m["coefficient"], _flat_solo(kind, columns,
                                                                   params).coefficient)
    ref = _jax_fleet(kind, columns, MEMBERS, ranks, True)
    for m, j in zip(members, ref):
        np.testing.assert_allclose(m["coefficient"], j.coefficient, **COEFF_TOL)


@pytest.mark.parametrize("threshold,want", [(1, 1.0), (None, 0.0), (1 << 30, 0.0)])
def test_the_regime_follows_the_state_threshold(world, threshold, want):
    columns = _columns("lr", "dense", seed=21)
    out = world(4).run("torch_mesh2d_jobs:fleet_fit", None, "lr", columns, MEMBERS, False, None,
                       threshold)
    assert out[0][2] == {"sharded": want, "size": 4}


def test_a_fleet_that_cannot_shard_raises_as_jax(world):
    columns = _columns("lr", "dense", seed=22)
    for message in world(2).run("torch_mesh2d_jobs:fleet_refused", columns, MEMBERS[:3]):
        assert "cannot shard" in message
    with pytest.raises(ValueError, match="cannot shard"):
        _jax_fleet("lr", columns, MEMBERS[:3], 2, True)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("shard", [None, True])
def test_kmeans_fleet_in_both_regimes(world, ranks, shard):
    rng = np.random.RandomState(5)
    X = np.concatenate([rng.randn(40, 4) + 4, rng.randn(41, 4) - 4, rng.randn(40, 4)])
    out = world(ranks).run("torch_mesh2d_jobs:fleet_fit", None, "kmeans", {"features": X},
                           KMEANS_MEMBERS, shard is None, shard)
    members, solos, gauges, _ = out[0]
    assert gauges["sharded"] == (1.0 if shard else 0.0)
    _all_ranks_equal(out, "centroids")
    ref = _jax_fleet("kmeans", {"features": X}, KMEANS_MEMBERS, ranks, shard)
    for i, (m, j) in enumerate(zip(members, ref)):
        want = solos[i] if shard is None else {
            "centroids": _flat_solo("kmeans", {"features": X}, KMEANS_MEMBERS[i]).centroids}
        np.testing.assert_array_equal(m["centroids"], want["centroids"])
        np.testing.assert_allclose(m["centroids"], j.centroids, **CENTROID_TOL)
        np.testing.assert_array_equal(m["weights"], j.weights)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("shard", [None, True])
def test_a_stream_fleet_in_both_regimes(world, ranks, shard):
    """A StreamTable of 4 equal batches: the default regime stacks this
    rank's rows of each batch and equals the members' solo stream fits on
    the same mesh bit for bit; the sharded regime their one-rank stream
    fits."""
    columns = _columns("lr", "dense", seed=30, n=256)
    members = [dict(m, global_batch_size=64) for m in MEMBERS]
    out = world(ranks).run("torch_mesh2d_jobs:fleet_fit", None, "lr", columns, members,
                           shard is None, shard, -1, False, 4)
    got, solos, gauges, _ = out[0]
    assert gauges["sharded"] == (1.0 if shard else 0.0)
    _all_ranks_equal(out, "coefficient")
    if shard is None:
        for m, s in zip(got, solos):
            np.testing.assert_array_equal(m["coefficient"], s["coefficient"])
    else:
        from flink_ml_tpu_torch import StreamTable

        for m, params in zip(got, members):
            est = LogisticRegression()
            for name, value in params.items():
                getattr(est, f"set_{name}")(value)
            with config.use_device("cpu"):
                solo = est.fit(StreamTable.from_batches(
                    [Table({k: v[i * 64:(i + 1) * 64] for k, v in columns.items()})
                     for i in range(4)]))
            np.testing.assert_array_equal(m["coefficient"], solo.coefficient)


def test_an_overlap_tuned_fleet_counts_its_downgrade(world):
    columns = _columns("lr", "dense", seed=40)
    out = world(2).run("torch_mesh2d_jobs:fleet_fit", None, "lr", columns, MEMBERS, False, None,
                       -1, True)
    assert out[0][3]["dispatch.whole_fit_fallback.fleet_overlap"] == 1


@pytest.mark.parametrize("shard", [None, True])
def test_a_checkpointed_fleet_on_ranks_resumes_bit_for_bit(world, shard, tmp_path):
    columns = _columns("lr", "dense", seed=41)
    members = [dict(m, max_iter=8) for m in MEMBERS]
    want = world(4).run("torch_mesh2d_jobs:fleet_checkpointed", None, columns, members, shard,
                        str(tmp_path / "whole"))
    got = world(4).run("torch_mesh2d_jobs:fleet_checkpointed", None, columns, members, shard,
                       str(tmp_path / "killed"), 2)
    for r in range(4):
        for g, w in zip(got[r], want[0]):
            np.testing.assert_array_equal(g, w)
    assert any(f.name.endswith(".manifest.json") for f in (tmp_path / "killed").iterdir())
