"""ModelLifecycle, the hot-swap path and promote_fleet_winner of
flink_ml_tpu_torch against the JAX package.

The cases of tests/test_hot_swap.py and tests/test_fleet.py's winner cases
run on both packages with the same seeded numpy candidates; each must give
the same gate decisions (reasons), the same ring contents (version ids,
arrays bit for bit), the same rollback and quarantine version ids, the same
events and counters. Served outputs of a swapped model are held to the
JAX package's at the LR tolerances, and their version stamps exactly. The
port on the CPU (`config.use_device("cpu")`), the JAX package on one
device. Every wait on a thread is bounded by a timeout.
"""

import types

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu import fleet as jax_fleet
from flink_ml_tpu import lifecycle as jax_lifecycle
from flink_ml_tpu.ckpt import faults as jax_faults
from flink_ml_tpu.linalg import DenseVector as JaxDenseVector
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.classification import onlinelogisticregression as jax_olr
from flink_ml_tpu.models.clustering import kmeans as jax_km
from flink_ml_tpu.models.clustering import onlinekmeans as jax_okm
from flink_ml_tpu.models.feature import standardscaler as jax_ss
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.pipeline import PipelineModel as JaxPipelineModel
from flink_ml_tpu.serving import MicroBatchServer as JaxServer
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch import fleet as port_fleet
from flink_ml_tpu_torch import flow
from flink_ml_tpu_torch import lifecycle as port_lifecycle
from flink_ml_tpu_torch.ckpt import faults as port_faults
from flink_ml_tpu_torch.linalg import DenseVector
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.classification import onlinelogisticregression as port_olr
from flink_ml_tpu_torch.models.clustering import kmeans as port_km
from flink_ml_tpu_torch.models.clustering import onlinekmeans as port_okm
from flink_ml_tpu_torch.models.feature import standardscaler as port_ss
from flink_ml_tpu_torch.pipeline import PipelineModel
from flink_ml_tpu_torch.serving import MicroBatchServer
from flink_ml_tpu_torch.utils import metrics as port_metrics

DIM = 4
WAIT_S = 60.0
LR_TOL = dict(rtol=1e-5, atol=1e-6)

PKGS = {
    "jax": types.SimpleNamespace(lifecycle=jax_lifecycle, olr=jax_olr, okm=jax_okm, faults=jax_faults,
                                 metrics=jax_metrics, fleet=jax_fleet, lr=jax_lr, km=jax_km,
                                 Table=JaxTable, DenseVector=JaxDenseVector,
                                 device_put=jax.device_put),
    "port": types.SimpleNamespace(lifecycle=port_lifecycle, olr=port_olr, okm=port_okm,
                                  faults=port_faults, metrics=port_metrics, fleet=port_fleet,
                                  lr=port_lr, km=port_km, Table=Table, DenseVector=DenseVector,
                                  device_put=torch.as_tensor),
}


@pytest.fixture
def both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _olr_model(p, coeff=None, version=0):
    m = p.olr.OnlineLogisticRegressionModel()
    m.publish_model_arrays((np.zeros(DIM) if coeff is None else coeff,), version)
    m.set_features_col("features").set_prediction_col("pred")
    return m


def _ring(lc):
    return [(v.version_id, v.source, [None if a is None else a.tolist() for a in v.arrays])
            for v in lc._ring]


def _events(lc):
    return [(e.kind, e.version) for e in lc.events]


def _counters(p, before):
    after = p.metrics.snapshot()["counters"]
    return {k: after.get(k, 0) - before.get(k, 0) for k in (
        "lifecycle.promoteRejected", "lifecycle.swap", "lifecycle.rollback",
        "lifecycle.quarantined", "lifecycle.quarantineRefused", "lifecycle.guardErrors")}


def _rejection(p, lc, arrays):
    try:
        lc.promote(arrays)
        return "promoted"
    except p.lifecycle.PromotionRejected as e:
        return e.reason


# ---------------------------------------------------------------------------
# the gate, the ring and rollback: one record per case, both packages
# ---------------------------------------------------------------------------

def gate_nonfinite_shape_arity_dtype(p):
    model = _olr_model(p, np.ones(DIM), version=1)
    lc = p.lifecycle.ModelLifecycle(model)
    before = p.metrics.snapshot()["counters"]
    bad = np.ones(DIM)
    bad[2] = np.nan
    inf = np.ones(DIM)
    inf[0] = np.inf
    reasons = [_rejection(p, lc, (bad,)), _rejection(p, lc, (inf,)),
               _rejection(p, lc, (np.ones(DIM + 1),)),
               _rejection(p, lc, (np.ones(DIM), np.ones(DIM))),
               _rejection(p, lc, (None,)),
               _rejection(p, lc, (np.ones(DIM, np.float32),)),
               _rejection(p, lc, (np.full(DIM, 0.5),))]
    return (reasons, model.model_version, np.asarray(model.coefficient).tolist(), _ring(lc),
            _events(lc), lc.promote_rejected, _counters(p, before))


def gate_canary(p):
    rng = np.random.RandomState(3)
    coeff = np.full(DIM, 0.5)
    model = _olr_model(p, coeff, version=1)
    canary = {"features": rng.randn(16, DIM).astype(np.float32)}
    lc = p.lifecycle.ModelLifecycle(model, canary=canary, canary_rtol=0.2)
    reasons = [_rejection(p, lc, (coeff + 0.001,)), _rejection(p, lc, (-5.0 * coeff,)),
               _rejection(p, lc, (coeff * 1.01,))]
    return reasons, model.model_version, _ring(lc), _events(lc)


def device_candidate(p):
    model = _olr_model(p, np.zeros(DIM), version=0)
    lc = p.lifecycle.ModelLifecycle(model)
    entry = lc.promote((p.device_put(np.full(DIM, 0.25, np.float32)),))
    return entry.version_id, np.asarray(model.coefficient).tolist(), _ring(lc)


def guard_window_rollback(p):
    rng = np.random.RandomState(11)
    model = _olr_model(p, np.zeros(DIM), version=0)
    lc = p.lifecycle.ModelLifecycle(model, retained=3, health_window=4, error_rate_trigger=0.5)
    before = p.metrics.snapshot()["counters"]
    good = rng.randn(DIM)
    lc.promote((good,))  # v1
    lc.record_serve_ok()  # v1 proven good
    lc.promote((rng.randn(DIM),))  # v2: the bad one
    versions = []
    for _ in range(4):
        lc.record_guard_error(ValueError("guard fired"))
        versions.append(model.model_version)
    restored = np.asarray(model.coefficient).tolist()
    with pytest.raises(p.lifecycle.TrainerQuarantined) as ei:
        lc.promote((rng.randn(DIM),))
    quarantined = (lc.quarantined, ei.value.since_version)
    lc.release_quarantine()
    after = lc.promote((good + 0.1,)).version_id
    return (versions, restored == good.tolist(), quarantined, after, lc.last_good, _ring(lc),
            _events(lc), lc.rollback_count, _counters(p, before))


def ring_is_bounded(p):
    rng = np.random.RandomState(12)
    model = _olr_model(p, np.zeros(DIM), version=0)
    lc = p.lifecycle.ModelLifecycle(model, retained=3, health_window=4, error_rate_trigger=0.5)
    for _ in range(6):
        lc.promote((rng.randn(DIM),))
    return lc.retained_versions(), _ring(lc), lc.current.version_id


def manual_rollback_targets_seed(p):
    rng = np.random.RandomState(13)
    model = _olr_model(p, np.zeros(DIM), version=0)
    lc = p.lifecycle.ModelLifecycle(model, retained=3, health_window=4, error_rate_trigger=0.5)
    lc.promote((rng.randn(DIM),))
    lc.promote((rng.randn(DIM),))
    restored = lc.rollback("operator")
    return (restored.version_id, restored.source, model.model_version,
            np.asarray(model.coefficient).tolist(), _events(lc))


def explicit_version_ids(p):
    rng = np.random.RandomState(14)
    model = _olr_model(p, np.zeros(DIM), version=5)
    lc = p.lifecycle.ModelLifecycle(model, retained=4)
    ids = [lc.promote((rng.randn(DIM),)).version_id,
           lc.promote((rng.randn(DIM),), version=20).version_id,
           lc.promote((rng.randn(DIM),)).version_id]
    return ids, lc.retained_versions(), model.model_version


def rollback_without_good_version(p):
    model = p.olr.OnlineLogisticRegressionModel()
    model.set_features_col("features")
    lc = p.lifecycle.ModelLifecycle(model)
    with pytest.raises(RuntimeError, match="rollback impossible"):
        lc.rollback()
    return lc.retained_versions(), lc.last_good


def kmeans_ring(p):
    rng = np.random.RandomState(15)
    model = p.okm.OnlineKMeansModel()
    model.publish_model_arrays((np.zeros((3, DIM)), np.ones(3)), 0)
    model.set_features_col("features").set_prediction_col("pred")
    lc = p.lifecycle.ModelLifecycle(model, retained=2)
    reasons = [_rejection(p, lc, (rng.randn(3, DIM), np.ones(3))),
               _rejection(p, lc, (rng.randn(2, DIM), np.ones(2))),
               _rejection(p, lc, (rng.randn(3, DIM),))]
    return reasons, _ring(lc)


def fault_sites(p):
    model = _olr_model(p, np.zeros(DIM), version=0)
    lc = p.lifecycle.ModelLifecycle(model)
    out = []
    for site in ("lifecycle.promote", "lifecycle.swap"):
        with p.faults.inject(site, after=1):
            with pytest.raises(p.faults.InjectedFault):
                lc.promote((np.ones(DIM),))
        out.append((site, model.model_version, lc.retained_versions()))
    out.append(lc.promote((np.ones(DIM),)).version_id)
    return out


LIFECYCLE_CASES = {f.__name__: f for f in (
    gate_nonfinite_shape_arity_dtype, gate_canary, device_candidate, guard_window_rollback,
    ring_is_bounded, manual_rollback_targets_seed, explicit_version_ids,
    rollback_without_good_version, kmeans_ring, fault_sites)}


@pytest.mark.parametrize("case", sorted(LIFECYCLE_CASES))
def test_lifecycle_case_equals_jax(case, both_on_one_device):
    fn = LIFECYCLE_CASES[case]
    assert fn(PKGS["port"]) == fn(PKGS["jax"])


def test_gate_decisions_are_the_hot_swap_ones(both_on_one_device):
    """What tests/test_hot_swap.py asserts, on the port's records."""
    reasons, version, coeff, ring, _, rejected, counters = \
        gate_nonfinite_shape_arity_dtype(PKGS["port"])
    # a float32 candidate passes: the gate compares the float64 host copies
    assert reasons == ["nonfinite", "nonfinite", "shape", "arity", "shape", "promoted", "promoted"]
    assert version == 3 and coeff == [0.5] * DIM and rejected == 5
    assert counters["lifecycle.promoteRejected"] == 5 and counters["lifecycle.swap"] == 2
    assert gate_canary(PKGS["port"])[0] == ["promoted", "canary", "promoted"]
    versions, exact, quarantined, after, last_good, _, events, rollbacks, counters = \
        guard_window_rollback(PKGS["port"])
    assert versions == [2, 2, 1, 1] and exact and quarantined == (True, 2) and after == 3
    assert rollbacks == 1 and counters["lifecycle.quarantineRefused"] == 1
    assert [k for k, _ in events] == ["promoted", "promoted", "rollback", "quarantined",
                                      "released", "promoted"]
    assert ring_is_bounded(PKGS["port"])[0] == [4, 5, 6]
    assert manual_rollback_targets_seed(PKGS["port"])[2] == 0


def test_checkpoint_dir_raises_until_a13(tmp_path):
    """A checkpoint directory raised naming ROADMAP A.13 until checkpoints
    were ported; the lifecycle now persists each promotion and a new
    lifecycle on the directory republishes it, as the JAX package's does."""
    for name in ("port", "jax"):
        lc = PKGS[name].lifecycle.ModelLifecycle(
            _olr_model(PKGS[name]), checkpoint_dir=str(tmp_path / name), job_key="a13")
        lc.promote((np.full(DIM, 0.5),))
        resumed = _olr_model(PKGS[name])
        PKGS[name].lifecycle.ModelLifecycle(resumed, checkpoint_dir=str(tmp_path / name),
                                            job_key="a13")
        assert resumed.model_version == 1
        np.testing.assert_array_equal(resumed.coefficient, np.full(DIM, 0.5))


def test_not_swap_capable_is_refused():
    with pytest.raises(TypeError, match="swap-capable"):
        port_lifecycle.ModelLifecycle(port_lr.LogisticRegressionModel())


def test_concurrent_publish_is_atomic():
    """A trainer thread publishing while a reader snaps the record: every
    snapshot is a consistent (version, centroids, weights)."""
    model = port_okm.OnlineKMeansModel()
    model.publish_model_arrays((np.zeros((3, DIM)), np.zeros(3)), 0)
    stop, tears = [], []

    def trainer():
        for v in range(1, 400):
            model.publish_model_arrays((np.full((3, DIM), float(v)), np.full(3, float(v))), v)
        stop.append(True)

    def reader():
        while not stop:
            pub = model._published
            if pub.version > 0 and not (pub.centroids[0, 0] == pub.weights[0] == float(pub.version)):
                tears.append(pub.version)

    t1, t2 = flow.spawn(trainer, name="t.trainer"), flow.spawn(reader, name="t.reader")
    t1.join(timeout=WAIT_S)
    t2.join(timeout=WAIT_S)
    assert not t1.is_alive() and not t2.is_alive()
    assert tears == [] and model.model_version == 399


# ---------------------------------------------------------------------------
# served swaps: version stamps and outputs against the JAX server
# ---------------------------------------------------------------------------

def _scaler(module):
    m = module.StandardScalerModel()
    m.mean = np.zeros(DIM)
    m.std = np.ones(DIM)
    m.set_input_col("features").set_output_col("features")
    return m


def _swap_serving(p, pm_cls, server_cls, model, batches):
    """Serve `batches`, publishing version 8 (all -1) while batch 0 is in
    flight; the outputs' versions and predictions."""
    server = server_cls(pm_cls([_scaler(p.ss), model]), in_flight=2, device_input=True)

    def stream():
        yield batches[0]
        model.publish_model_arrays((np.full(DIM, -1.0),), 8)
        yield from batches[1:]

    outs = list(server.serve(stream()))
    return [(np.asarray(o.column("modelVersion")).tolist(), np.asarray(o.column("pred")),
             np.asarray(o.column("rawPrediction"))) for o in outs]


def test_inflight_batch_keeps_dispatch_version_equal_jax(both_on_one_device):
    rng = np.random.RandomState(21)
    coeff = rng.randn(DIM)
    batches = [rng.randn(8, DIM).astype(np.float32) for _ in range(3)]
    got = _swap_serving(types.SimpleNamespace(ss=port_ss), PipelineModel, MicroBatchServer,
                        _olr_model(PKGS["port"], coeff, 7), [Table({"features": b}) for b in batches])
    want = _swap_serving(types.SimpleNamespace(ss=jax_ss), JaxPipelineModel, JaxServer,
                         _olr_model(PKGS["jax"], coeff, 7), [JaxTable({"features": b}) for b in batches])
    assert [v for v, _, _ in got] == [v for v, _, _ in want] == [[7] * 8, [8] * 8, [8] * 8]
    for (_, pg, rg), (_, pw, rw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_allclose(rg, rw, **LR_TOL)


def test_served_swaps_capture_nothing_and_reuse_the_plan(both_on_one_device):
    """N publications against a served fused plan: one plan object, no new
    capture counted, every batch stamped with the version published just
    before it and scored by its coefficients."""
    rng = np.random.RandomState(22)
    model = _olr_model(PKGS["port"])
    pm = PipelineModel([_scaler(port_ss), model])
    batch = Table({"features": torch.as_tensor(rng.randn(8, DIM).astype(np.float32))})
    pm.transform(batch)
    plan = pm._fusion_plan()
    traces = port_metrics.get_counter("jit.traces")
    for v in range(1, 6):
        coeff = rng.randn(DIM)
        if v % 2:
            model.set_model_data(Table({"coefficient": [DenseVector(coeff)], "modelVersion": [v]}))
        else:
            model.publish_model_arrays((coeff,), v)
        out = pm.transform(batch)[0]
        assert np.unique(out.column("modelVersion").numpy()).tolist() == [v]
        want = (batch.column("features").numpy() @ coeff.astype(np.float32) >= 0).astype(np.float32)
        np.testing.assert_array_equal(out.column("pred").numpy(), want)
    assert pm._fusion_plan() is plan
    assert port_metrics.get_counter("jit.traces") == traces


# ---------------------------------------------------------------------------
# promote_fleet_winner (tests/test_fleet.py's winner cases)
# ---------------------------------------------------------------------------

def _classif(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(200, DIM)
    y = (X @ np.arange(1.0, DIM + 1.0) > 0).astype(np.float64)
    return X, y


def _fleet_lr(p, max_iter, lr=0.1):
    return p.lr.LogisticRegression().set_max_iter(max_iter).set_learning_rate(lr) \
        .set_global_batch_size(64)


def winner_max_mode(p):
    X, y = _classif(19)
    table = p.Table({"features": X, "label": y})
    models = p.fleet.FitFleet([_fleet_lr(p, 6), _fleet_lr(p, 6, 0.02), _fleet_lr(p, 6, 0.3)]).fit(table)
    lc = p.lifecycle.ModelLifecycle(_olr_model(p, np.zeros(DIM, np.float32)))
    winner, version = p.fleet.promote_fleet_winner(lc, models, [0.71, 0.64, 0.83])
    gauges = p.metrics.snapshot()["gauges"]
    return (winner, version.version_id, lc.model.model_version, version.arrays[0],
            np.asarray(models[2].coefficient, np.float32), gauges.get("fleet.winnerIndex"),
            gauges.get("fleet.winnerScore"))


def winner_min_mode_and_errors(p):
    X, y = _classif(20)
    models = p.fleet.FitFleet([_fleet_lr(p, 3), _fleet_lr(p, 4)]).fit(p.Table({"features": X, "label": y}))
    lc = p.lifecycle.ModelLifecycle(_olr_model(p, np.zeros(DIM, np.float32)))
    winner, _ = p.fleet.promote_fleet_winner(lc, models, [0.4, 0.1], mode="min")
    errors = []
    for scores, mode in (([0.4], "max"), ([0.4, float("nan")], "max"), ([0.4, 0.1], "median")):
        with pytest.raises(ValueError) as ei:
            p.fleet.promote_fleet_winner(lc, models, scores, mode=mode)
        errors.append(str(ei.value))
    return winner, errors, lc.retained_versions()


def winner_kmeans_arrays(p):
    rng = np.random.RandomState(21)
    X = np.concatenate([rng.randn(30, 3).astype(np.float32) + c for c in (-2.0, 2.0)])
    (model,) = p.fleet.FitFleet([p.km.KMeans().set_k(2).set_seed(1).set_max_iter(4)]).fit(
        p.Table({"features": X}))
    centroids, weights = p.fleet.fleet_model_arrays(model)
    return centroids.shape, weights.shape, centroids.dtype, centroids, weights


def test_winner_max_mode_equals_jax(both_on_one_device):
    got, want = winner_max_mode(PKGS["port"]), winner_max_mode(PKGS["jax"])
    assert got[:3] == want[:3] == (2, 1, 1)
    np.testing.assert_array_equal(got[3], got[4].astype(np.float64))  # the winner's arrays
    np.testing.assert_allclose(got[3], want[3], **LR_TOL)
    assert got[5:] == want[5:] == (2.0, pytest.approx(0.83))


def test_winner_min_mode_and_errors_equal_jax(both_on_one_device):
    got, want = winner_min_mode_and_errors(PKGS["port"]), winner_min_mode_and_errors(PKGS["jax"])
    assert got == want
    assert got[0] == 1 and got[2] == [0, 1]
    assert [e.split(" ")[0] for e in got[1]] == ["2", "fleet", "Unknown"]


def test_winner_kmeans_arrays_equal_jax(both_on_one_device):
    got, want = winner_kmeans_arrays(PKGS["port"]), winner_kmeans_arrays(PKGS["jax"])
    assert got[:3] == want[:3] == ((2, 3), (2,), np.float32)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[4], want[4])
