"""FitFleet in flink_ml_tpu_torch (fleet.py, the fleet programs of
ops/optimizer.py, the fleet losses of ops/losses.py and
models/clustering/kmeans.py `_lloyd_fleet_train`) against the JAX package.

Seeded numpy inputs go through both packages' FitFleet: the JAX side on a
one-device mesh (the sparse kernels in Pallas interpret mode under its
vmap), the port on the CPU (the fleet kernels' plain versions). Held to:

- each port member against the JAX member at the solo parity tolerances
  (coefficients rtol 1e-4, atol 1e-6; KMeans centroids rtol 1e-5, atol
  1e-5, counts equal, as tests/test_torch_kmeans.py holds the solo fits);
- each JAX member equal to its own solo fit bit for bit (the JAX
  package's contract);
- each port member equal to the port's own solo fit bit for bit. That
  holds on the CPU: each member runs its solo fit's arithmetic op for op
  (the proximal factors formed in float64 as the solo `_prox_step` forms
  them; `lr / wsum` as the solo form's `reciprocal(wsum) * lr`), the
  fleet's plain kernels add each member's slots in the solo plain
  versions' order, the dense reduce forms over X[None] reduce each
  member's row as the solo form does, and KMeans' stacked matmuls give the
  solo matmuls' bits at these sizes. On the card the gradient's atomics
  reorder every fit's sums, so there the gap is measured (chip_smoke.py,
  PERF.md), not pinned;
- a member with a smaller maxIter (or an earlier tol stop) freezes at its
  own epoch count while the others train;
- one fleet fit is one packed readback (`_linear.packed_to_host` called
  once);
- the JAX package's validation errors.
"""

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import SparseBatch as JaxSparseBatch
from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import fleet as jax_fleet
from flink_ml_tpu.models.classification import linearsvc as jax_svc
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.clustering import kmeans as jax_kmeans
from flink_ml_tpu.models.feature import standardscaler as jax_scaler
from flink_ml_tpu.models.regression import linearregression as jax_linreg
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu_torch import SparseBatch, StreamTable, Table, config
from flink_ml_tpu_torch import fleet as port_fleet
from flink_ml_tpu_torch.models import _linear as port_linear
from flink_ml_tpu_torch.models.classification import linearsvc as port_svc
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.clustering import kmeans as port_kmeans
from flink_ml_tpu_torch.models.feature import standardscaler as port_scaler
from flink_ml_tpu_torch.models.regression import linearregression as port_linreg
from flink_ml_tpu_torch.ops import optimizer as port_optimizer

COEFF_TOL = dict(rtol=1e-4, atol=1e-6)
CENTROID_TOL = dict(rtol=1e-5, atol=1e-5)
SPARSE_D = 40
# kind -> (JAX module, port module, estimator class name)
KINDS = {
    "lr": (jax_lr, port_lr, "LogisticRegression"),
    "svc": (jax_svc, port_svc, "LinearSVC"),
    "linreg": (jax_linreg, port_linreg, "LinearRegression"),
}
# per-member params: a plain member, reg with L2, an elastic net with
# values no float32 product forms exactly, a shorter maxIter
MEMBERS = [
    {},
    {"learning_rate": 0.05, "reg": 0.1},
    {"reg": 0.07, "elastic_net": 0.3},
    {"max_iter": 4, "learning_rate": 0.2},
]


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _estimator(module, cls, max_iter=9, gbs=64, **params):
    est = getattr(module, cls)().set_max_iter(max_iter).set_global_batch_size(gbs).set_tol(0.0)
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
    return est


def _members(kind, members=MEMBERS, **shared):
    """(JAX estimators, port estimators) of the same per-member params."""
    jax_mod, port_mod, cls = KINDS[kind]
    out = []
    for module in (jax_mod, port_mod):
        out.append([_estimator(module, cls, **{**shared, **m}) for m in members])
    return out


def _labels(kind, dots, rng):
    if kind == "linreg":
        return dots + 0.1 * rng.standard_normal(dots.shape[0])
    return (dots > 0).astype(np.float64)


def _dense(kind, seed=0, n=300, d=12):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = _labels(kind, X @ rng.standard_normal(d), rng)
    return X, y, rng.random(n) + 0.5


def _sparse(kind, seed=1, n=320, nnz=6):
    """Padded CSR with -1 padding and indices >= d (clamped in the dot,
    dropped in the gradient)."""
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, SPARSE_D, size=(n, nnz)).astype(np.int32)
    indices[rng.random((n, nnz)) < 0.2] = -1
    indices[rng.random((n, nnz)) < 0.03] = SPARSE_D + 2
    values = rng.random((n, nnz))
    truth = rng.standard_normal(SPARSE_D)
    dots = np.where(indices >= 0, values * truth[np.clip(indices, 0, SPARSE_D - 1)], 0).sum(1)
    return indices, values, _labels(kind, dots, rng)


def _tables(X, **cols):
    if isinstance(X, tuple):
        indices, values = X
        return (JaxTable({"features": JaxSparseBatch(SPARSE_D, indices, values), **cols}),
                Table({"features": SparseBatch(SPARSE_D, indices, values), **cols}))
    return JaxTable({"features": X, **cols}), Table({"features": X, **cols})


def _hold(jax_models, port_models, port_solo, jax_solo):
    for jm, pm, ps, js in zip(jax_models, port_models, port_solo, jax_solo):
        np.testing.assert_array_equal(np.asarray(jm.coefficient), np.asarray(js.coefficient))
        np.testing.assert_allclose(pm.coefficient, np.asarray(jm.coefficient), **COEFF_TOL)
        np.testing.assert_array_equal(pm.coefficient, ps.coefficient)


def _fit_both(kind, jax_table, port_table, **shared):
    jax_ests, port_ests = _members(kind, **shared)
    jax_models = jax_fleet.FitFleet(jax_ests).fit(jax_table)
    port_models = port_fleet.FitFleet(port_ests).fit(port_table)
    jax_solo = [e.fit(jax_table) for e in _members(kind, **shared)[0]]
    port_solo = [e.fit(port_table) for e in _members(kind, **shared)[1]]
    return jax_models, port_models, port_solo, jax_solo


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_dense_fleet_matches_jax_and_solo(both_on_one_device, kind, weighted):
    X, y, w = _dense(kind)
    cols = {"label": y, "weight": w} if weighted else {"label": y}
    shared = {"weight_col": "weight"} if weighted else {}
    jax_table, port_table = _tables(X, **cols)
    jax_models, port_models, port_solo, jax_solo = _fit_both(kind, jax_table, port_table, **shared)
    _hold(jax_models, port_models, port_solo, jax_solo)
    for pm, est in zip(port_models, _members(kind, **shared)[1]):
        assert type(pm).__name__ == KINDS[kind][2] + "Model"
        assert pm.get_features_col() == est.get_features_col()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sparse_fleet_matches_jax_and_solo(both_on_one_device, kind):
    indices, values, y = _sparse(kind)
    jax_table, port_table = _tables((indices, values), label=y)
    _hold(*_fit_both(kind, jax_table, port_table))


def test_sparse_fleet_runs_the_fleet_kernels_only(both_on_one_device):
    """On the CPU the fleet wrappers take their plain versions and count no
    launch; the fleet loss calls each member-batched form once an epoch and
    never a solo form."""
    from flink_ml_tpu_torch.ops import sparsekernels

    calls = {"fleet_row_dots_plain": 0, "fleet_grad_plain": 0, "sparse_row_dots_plain": 0,
             "sparse_grad_plain": 0}
    originals = {name: getattr(sparsekernels, name) for name in calls}

    def counting(name):
        def call(*args):
            calls[name] += 1
            return originals[name](*args)
        return call

    indices, values, y = _sparse("lr", seed=9)
    _, port_table = _tables((indices, values), label=y)
    try:
        for name in calls:
            setattr(sparsekernels, name, counting(name))
        sparsekernels.reset_launch_counts()
        port_fleet.FitFleet(_members("lr")[1]).fit(port_table)
    finally:
        for name, fn in originals.items():
            setattr(sparsekernels, name, fn)
    assert calls == {"fleet_row_dots_plain": 9, "fleet_grad_plain": 9, "sparse_row_dots_plain": 0,
                     "sparse_grad_plain": 0}
    assert set(sparsekernels.launch_counts().values()) == {0}


def test_stream_fleet_matches_jax_and_solo(both_on_one_device):
    """Uniform chunks: each chunk is a batch, stacked on the device once."""
    X, y, w = _dense("lr", seed=8, n=320)
    jax_ests, port_ests = _members("lr", gbs=80, weight_col="weight")

    def chunks(table_cls):
        return [table_cls({"features": X[i:i + 80], "label": y[i:i + 80], "weight": w[i:i + 80]})
                for i in range(0, 320, 80)]

    jax_models = jax_fleet.FitFleet(jax_ests).fit(JaxStreamTable.from_batches(chunks(JaxTable)))
    port_models = port_fleet.FitFleet(port_ests).fit(StreamTable.from_batches(chunks(Table)))
    jax_solo = [e.fit(JaxStreamTable.from_batches(chunks(JaxTable)))
                for e in _members("lr", gbs=80, weight_col="weight")[0]]
    port_solo = [e.fit(StreamTable.from_batches(chunks(Table)))
                 for e in _members("lr", gbs=80, weight_col="weight")[1]]
    _hold(jax_models, port_models, port_solo, jax_solo)
    # and the bounded fleet on the same rows gives the same bits
    bounded = port_fleet.FitFleet(_members("lr", gbs=80, weight_col="weight")[1]).fit(
        Table({"features": X, "label": y, "weight": w}))
    for a, b in zip(port_models, bounded):
        np.testing.assert_array_equal(a.coefficient, b.coefficient)


def test_stream_fleet_needs_uniform_chunks(both_on_one_device):
    X, y, _ = _dense("lr", seed=3, n=150)
    stream = StreamTable.from_batches([Table({"features": X[:100], "label": y[:100]}),
                                       Table({"features": X[100:], "label": y[100:]})])
    with pytest.raises(ValueError, match="uniform batch shapes"):
        port_fleet.FitFleet(_members("lr")[1]).fit(stream)
    with pytest.raises(ValueError, match="no batches"):
        port_fleet.FitFleet(_members("lr")[1]).fit(StreamTable.from_batches([]))


def _blobs(seed=9, d=5):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((60, d)) + c for c in (-4.0, 0.0, 4.0)]).astype(
        np.float32)


KMEANS_MEMBERS = [{"seed": 11, "max_iter": 8}, {"seed": 29, "max_iter": 8},
                  {"seed": 11, "max_iter": 3}, {"seed": 5, "max_iter": 1}]


def _kmeans_members(module, measure="euclidean"):
    return [module.KMeans().set_k(3).set_seed(m["seed"]).set_max_iter(m["max_iter"])
            .set_distance_measure(measure) for m in KMEANS_MEMBERS]


@pytest.mark.parametrize("measure", ["euclidean", "manhattan", "cosine"])
def test_kmeans_fleet_matches_jax_and_solo(both_on_one_device, measure):
    X = _blobs()
    jax_models = jax_fleet.FitFleet(_kmeans_members(jax_kmeans, measure)).fit(JaxTable({"features": X}))
    port_models = port_fleet.FitFleet(_kmeans_members(port_kmeans, measure)).fit(Table({"features": X}))
    for jm, pm, js, ps in zip(jax_models, port_models,
                              [e.fit(JaxTable({"features": X})) for e in _kmeans_members(jax_kmeans, measure)],
                              [e.fit(Table({"features": X})) for e in _kmeans_members(port_kmeans, measure)]):
        np.testing.assert_array_equal(np.asarray(jm.centroids), np.asarray(js.centroids))
        np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids), **CENTROID_TOL)
        np.testing.assert_array_equal(pm.weights, np.asarray(jm.weights))
        np.testing.assert_array_equal(pm.centroids, ps.centroids)
        np.testing.assert_array_equal(pm.weights, ps.weights)
        assert pm.get_k() == 3 and pm.get_distance_measure() == measure


def test_kmeans_fleet_on_a_tensor_column(both_on_one_device):
    X = _blobs(seed=4)
    host = port_fleet.FitFleet(_kmeans_members(port_kmeans)).fit(Table({"features": X}))
    tensor = port_fleet.FitFleet(_kmeans_members(port_kmeans)).fit(
        Table({"features": torch.from_numpy(X)}))
    for a, b in zip(host, tensor):
        np.testing.assert_array_equal(a.centroids, b.centroids)


def test_kmeans_fleet_refuses_a_stream_and_too_few_points(both_on_one_device):
    X = _blobs()
    with pytest.raises(ValueError, match="out-of-core KMeans"):
        port_fleet.FitFleet(_kmeans_members(port_kmeans)).fit(
            StreamTable.from_batches([Table({"features": X})]))
    with pytest.raises(ValueError, match="less than k"):
        port_fleet.FitFleet(_kmeans_members(port_kmeans)).fit(Table({"features": X[:2]}))
    with pytest.raises(ValueError, match="k"):
        port_fleet.FitFleet([port_kmeans.KMeans().set_k(2), port_kmeans.KMeans().set_k(3)]).fit(
            Table({"features": X}))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_members_freeze_at_their_own_epoch(both_on_one_device, layout):
    """The convergence mask: a shorter maxIter and an early tol stop each
    end at their own epoch while the others train to maxIter."""
    X, y, _ = _dense("lr", seed=6) if layout == "dense" else (None, None, None)
    if layout == "sparse":
        indices, values, y = _sparse("lr", seed=6)
        X = (indices, values)
    _, port_table = _tables(X, label=y)
    tol = 0.65 if layout == "dense" else 0.69  # reached after a few of the 9 epochs
    params = [{}, {"max_iter": 3}, {"tol": tol}, {"max_iter": 1}]
    ests = [_estimator(port_lr, "LogisticRegression", **p) for p in params]
    models, criteria, epochs = port_fleet.FitFleet(ests)._fit_linear(port_table)
    solo_epochs = []
    for p in params:
        _, _, solo = port_linear.run_sgd(
            _estimator(port_lr, "LogisticRegression", **p), port_table,
            port_lr.BINARY_LOGISTIC_LOSS, None, validate_binomial=True)
        solo_epochs.append(solo)
    assert epochs.tolist() == solo_epochs
    assert epochs[0] == 9 and epochs[1] == 3 and epochs[3] == 1 and 3 < epochs[2] < 9
    assert criteria[2] <= tol < criteria[1]


def test_one_packed_readback_a_fleet_fit(both_on_one_device, monkeypatch):
    reads = []
    original = port_linear.packed_to_host

    def counting(*tensors):
        reads.append([tuple(t.shape) for t in tensors])
        return original(*tensors)

    monkeypatch.setattr(port_linear, "packed_to_host", counting)
    X, y, _ = _dense("lr", seed=2)
    port_fleet.FitFleet(_members("lr")[1]).fit(Table({"features": torch.from_numpy(X),
                                                      "label": torch.from_numpy(y)}))
    # the label check rides the pack: a flag column before the d + 2
    assert reads == [[(len(MEMBERS), 1 + X.shape[1] + 2)]]
    indices, values, y = _sparse("svc", seed=2)
    port_fleet.FitFleet(_members("svc")[1]).fit(_tables((indices, values), label=y)[1])
    assert reads[1:] == [[(len(MEMBERS), SPARSE_D + 2)]]
    port_fleet.FitFleet(_kmeans_members(port_kmeans)).fit(Table({"features": _blobs()}))
    assert reads[2:] == [[(len(KMEANS_MEMBERS), 3 * 5 + 3)]]


def test_validation_errors_match_jax(both_on_one_device):
    X, y, _ = _dense("lr", seed=16)
    for fleet_cls, mods in ((jax_fleet.FitFleet, (jax_lr, jax_svc, jax_scaler)),
                            (port_fleet.FitFleet, (port_lr, port_svc, port_scaler))):
        lr, svc, scaler = mods
        with pytest.raises(ValueError, match="at least one"):
            fleet_cls([])
        with pytest.raises(ValueError, match="same estimator class"):
            fleet_cls([lr.LogisticRegression(), svc.LinearSVC()])
        with pytest.raises(ValueError, match="does not support StandardScaler"):
            fleet_cls([scaler.StandardScaler()])
        table = (JaxTable if lr is jax_lr else Table)({"features": X, "label": y})
        with pytest.raises(ValueError, match="globalBatchSize"):
            fleet_cls([_estimator(lr, "LogisticRegression", gbs=32),
                       _estimator(lr, "LogisticRegression", gbs=64)]).fit(table)
        with pytest.raises(ValueError, match="featuresCol"):
            fleet_cls([_estimator(lr, "LogisticRegression"),
                       _estimator(lr, "LogisticRegression", features_col="f")]).fit(table)
        with pytest.raises(ValueError, match="Multinomial"):
            fleet_cls([_estimator(lr, "LogisticRegression"),
                       _estimator(lr, "LogisticRegression", multi_class="multinomial")]).fit(table)
        bad = (JaxTable if lr is jax_lr else Table)({"features": X, "label": np.full(len(y), 2.0)})
        with pytest.raises(ValueError, match="binomial"):
            fleet_cls([_estimator(lr, "LogisticRegression", max_iter=2)]).fit(bad)
        with pytest.raises(ValueError, match="cannot shard over 1 data shard"):
            fleet_cls([_estimator(lr, "LogisticRegression")] * 2, shard_fleet_axis=True).fit(table)
    assert config.fleet_shard_state_bytes == 256 << 20


def test_invalid_tensor_labels_raise_from_the_readback(both_on_one_device):
    X, y, _ = _dense("lr", seed=18)
    y[5] = 2.0
    table = Table({"features": torch.from_numpy(X), "label": torch.from_numpy(y)})
    with pytest.raises(ValueError, match="Multinomial classification is not supported"):
        port_fleet.FitFleet(_members("lr")[1]).fit(table)


def test_unported_fleet_paths_raise_naming_their_roadmap_item(both_on_one_device, tmp_path):
    """The checkpointed fleet raised naming ROADMAP A.13 until checkpoints
    were ported; it now checkpoints, and a fleet killed at a chunk resumes
    to the unkilled fleet bit for bit (its chunk program replaces the
    stub). The sharded regime raised (A.10b) until it was ported; on one
    device it cannot shard, and forbidding it is the default regime (the
    regimes on ranks: tests/test_torch_fleet_mesh.py)."""
    from flink_ml_tpu_torch.ckpt import faults

    X, y, _ = _dense("lr", seed=19)
    table = Table({"features": X, "label": y})
    want = port_fleet.FitFleet(_members("lr")[1]).fit(table)
    with config.iteration_checkpointing(str(tmp_path), interval=2):
        with faults.inject("chunk", after=2):
            with pytest.raises(faults.InjectedFault):
                port_fleet.FitFleet(_members("lr")[1]).fit(table)
        got = port_fleet.FitFleet(_members("lr")[1]).fit(table)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.coefficient, w.coefficient)
    # forbidding the sharded regime is the default regime
    models = port_fleet.FitFleet(_members("lr")[1], shard_fleet_axis=False).fit(table)
    assert len(models) == len(MEMBERS)


def test_fleet_model_arrays(both_on_one_device):
    X = _blobs(seed=21, d=3)
    (model,) = port_fleet.FitFleet([port_kmeans.KMeans().set_k(2).set_seed(1).set_max_iter(4)]).fit(
        Table({"features": X}))
    (jax_model,) = jax_fleet.FitFleet([jax_kmeans.KMeans().set_k(2).set_seed(1).set_max_iter(4)]).fit(
        JaxTable({"features": X}))
    centroids, weights = port_fleet.fleet_model_arrays(model)
    want = jax_fleet.fleet_model_arrays(jax_model)
    assert centroids.shape == (2, 3) and weights.shape == (2,) and centroids.dtype == np.float32
    np.testing.assert_allclose(centroids, want[0], **CENTROID_TOL)
    np.testing.assert_array_equal(weights, want[1])
    X, y, _ = _dense("lr", seed=22)
    (lr_model,) = port_fleet.FitFleet([_members("lr")[1][0]]).fit(Table({"features": X, "label": y}))
    (coeff,) = port_fleet.fleet_model_arrays(lr_model)
    assert coeff.dtype == np.float32 and coeff.shape == (X.shape[1],)


def test_single_member_fleet_is_the_solo_fit(both_on_one_device):
    X, y, _ = _dense("svc", seed=5)
    table = Table({"features": X, "label": y})
    (model,) = port_fleet.FitFleet([_members("svc")[1][1]]).fit(table)
    np.testing.assert_array_equal(model.coefficient, _members("svc")[1][1].fit(table).coefficient)


def test_fleet_models_save_load_and_predict_in_both_packages(both_on_one_device, tmp_path):
    from flink_ml_tpu.api import Stage as JaxStage
    from flink_ml_tpu_torch.api import Stage

    indices, values, y = _sparse("lr", seed=23)
    jax_table, port_table = _tables((indices, values), label=y)
    models = port_fleet.FitFleet(_members("lr")[1]).fit(port_table)
    for i, model in enumerate(models):
        model.save(str(tmp_path / f"m{i}"))
        loaded = JaxStage.load(str(tmp_path / f"m{i}"))
        np.testing.assert_array_equal(np.asarray(loaded.coefficient), model.coefficient)
        again = Stage.load(str(tmp_path / f"m{i}")).transform(port_table)[0]
        np.testing.assert_array_equal(again.column("prediction"),
                                      model.transform(port_table)[0].column("prediction"))
