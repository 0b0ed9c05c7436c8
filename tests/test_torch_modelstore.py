"""ModelStore of flink_ml_tpu_torch against the JAX package.

The same access sequence over the same registered models, under a budget
that holds the same number of models in each package (each package's own
estimate and device bytes), must give the same LRU residency after every
step and the same `stats` (hits, misses, evictions) as the JAX store.
Also held, on the port: the ledger's `model` bytes never above the budget
and equal to the store's (`check_ledger_parity`), a page-out that closes
the ledger entries at once, the admission estimate bounding the bytes the
constants upload in every dtype, registered models planned in operand
mode with their graphs shared by architecture, and the store's lifecycle
and serving integration. The port on the CPU, the JAX package on one
device.
"""

import types

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.data import modelstore as jax_store
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.classification import onlinelogisticregression as jax_olr
from flink_ml_tpu.models.feature import standardscaler as jax_ss
from flink_ml_tpu.obs import memledger as jax_ledger
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.pipeline import PipelineModel as JaxPipelineModel
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch import api as port_api
from flink_ml_tpu_torch import pipeline as port_pipeline
from flink_ml_tpu_torch import table as port_table
from flink_ml_tpu_torch.data import modelstore as port_store
from flink_ml_tpu_torch.lifecycle import ModelLifecycle
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.classification import onlinelogisticregression as port_olr
from flink_ml_tpu_torch.models.feature import standardscaler as port_ss
from flink_ml_tpu_torch.models.feature.vectorassembler import VectorAssembler
from flink_ml_tpu_torch.obs import memledger as port_ledger
from flink_ml_tpu_torch.pipeline import PipelineModel
from flink_ml_tpu_torch.serving import MicroBatchServer
from flink_ml_tpu_torch.utils import metrics as port_metrics

D = 64

PKGS = {
    "jax": types.SimpleNamespace(store=jax_store, ss=jax_ss, olr=jax_olr, lr=jax_lr,
                                 ledger=jax_ledger, metrics=jax_metrics, PM=JaxPipelineModel),
    "port": types.SimpleNamespace(store=port_store, ss=port_ss, olr=port_olr, lr=port_lr,
                                  ledger=port_ledger, metrics=port_metrics, PM=PipelineModel),
}


@pytest.fixture(autouse=True)
def _clean_ledgers():
    port_ledger.reset()
    jax_ledger.reset()
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield
    port_ledger.reset()
    jax_ledger.reset()


def _scaler(p, seed, d=D):
    rng = np.random.RandomState(seed)
    ss = p.ss.StandardScalerModel()
    ss.mean = rng.randn(d)
    ss.std = np.abs(rng.randn(d)) + 0.1
    ss.set_input_col("features").set_output_col("scaled")
    return ss


def _olr(p, d=16, version=0):
    m = p.olr.OnlineLogisticRegressionModel()
    m.publish_model_arrays((np.ones(d),), version)
    m.set_features_col("features").set_prediction_col("pred")
    return m


def _sizes(p):
    """(admission estimate, device bytes) of one scaler in package p."""
    probe = p.store.ModelStore(budget_bytes=None, name="probe")
    probe.register("x", _scaler(p, 0))
    est = probe.estimated_nbytes("x")
    probe.page_in("x")
    dev = probe.stats["bytes"]
    probe.unregister("x")
    return est, dev


def _lru_run(p, models_held, sequence, pipeline):
    """Run `sequence` of (op, key) on a store that fits `models_held`
    scalers; residency and stats after each step."""
    est, dev = _sizes(p)
    # `models_held` residents fit beside one more estimate; one more does not
    store = p.store.ModelStore(budget_bytes=models_held * dev + est - 1)
    for i, key in enumerate("abcde"):
        model = _scaler(p, i + 1)
        store.register(key, p.PM([model]) if pipeline else model)
    trace = []
    for op, key in sequence:
        getattr(store, op)(key)
        live = p.ledger.live_bytes("model")
        trace.append((op, key, sorted(store.resident_keys()), live <= store.budget_bytes,
                      store.stats["bytes"] <= store.budget_bytes))
        store.check_ledger_parity()
    stats = dict(store.stats)
    # the JAX package's device bytes are float32 (x64 off), the port's the
    # host dtype: compare them in models
    stats["bytes"] //= dev
    return trace, stats


SEQUENCES = {
    "test_modelstore": [("page_in", "a"), ("page_in", "b"), ("page_in", "c"), ("acquire", "b"),
                        ("page_in", "a")],
    "round_robin": [("acquire", k) for k in "abcdeabcdeabcde"],
    "hot_key": [("acquire", k) for k in "aabacadaeabacada"],
    "page_out_mix": [("acquire", "a"), ("acquire", "b"), ("page_out", "a"), ("acquire", "c"),
                     ("acquire", "a"), ("page_out", "c"), ("acquire", "d"), ("acquire", "b")],
}


@pytest.mark.parametrize("held", [1, 2, 3])
@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_lru_sequence_and_stats_equal_jax(name, held, pipeline):
    got = _lru_run(PKGS["port"], held, SEQUENCES[name], pipeline)
    want = _lru_run(PKGS["jax"], held, SEQUENCES[name], pipeline)
    assert got == want
    trace, stats = got
    assert all(ok_ledger and ok_store for *_, ok_ledger, ok_store in trace)
    assert all(len(resident) <= held for _, _, resident, _, _ in trace)
    if name == "test_modelstore" and held == 2:
        assert [r for _, _, r, _, _ in trace][-1] == ["a", "b"]
        assert (stats["evictions"], stats["misses"], stats["hits"]) == (2, 4, 1)


def test_registry_estimate_and_errors():
    store = port_store.ModelStore(budget_bytes=None)
    store.register("a", _scaler(PKGS["port"], 1))
    assert "a" in store and store.keys() == ["a"]
    assert store.estimated_nbytes("a") == 2 * D * 8  # mean and scale, float64, aligned
    store.unregister("a")
    assert "a" not in store
    with pytest.raises(KeyError):
        store.acquire("a")
    with pytest.raises(TypeError):
        store.register("x", object())
    one = store_est = port_store._host_nbytes(_scaler(PKGS["port"], 1)._kernel_constants())
    small = port_store.ModelStore(budget_bytes=one - 1)
    with pytest.raises(port_store.ModelStoreBudgetExceeded) as ei:
        small.register("big", _scaler(PKGS["port"], 1))
    assert (ei.value.key, ei.value.nbytes, ei.value.budget) == ("big", store_est, one - 1)


@pytest.mark.parametrize("model", ["scaler_f64", "lr_f32", "online_lr_f32_int32", "odd_sizes"])
def test_estimate_bounds_the_uploaded_bytes(model):
    """`_host_nbytes` is at least what `device_constants()` ledgers and what
    its upload allocates (each leaf in its host dtype, the staging
    buffer's alignment), whatever the constants' dtypes; the ledger counts
    the whole buffer, each leaf's aligned slot (ROADMAP C.39)."""
    p = PKGS["port"]
    if model == "scaler_f64":
        stage = _scaler(p, 1, d=37)
    elif model == "lr_f32":
        stage = p.lr.LogisticRegressionModel()
        stage.coefficient = np.random.RandomState(2).randn(1001)
    elif model == "online_lr_f32_int32":
        stage = _olr(p, d=13, version=4)
    else:
        stage = _scaler(p, 1, d=1)
    est = port_store._host_nbytes(stage._kernel_constants())
    consts = stage.device_constants(torch.device("cpu"))
    leaves = port_pipeline._tree_leaves(consts)
    ledgered = port_ledger.tracked_nbytes(consts)
    align = port_api.HostConstants.ALIGN
    assert ledgered == sum(-(-t.numel() * t.element_size() // align) * align
                           for t in leaves) > 0
    buffer = leaves[0].untyped_storage().nbytes()
    assert all(t.untyped_storage().data_ptr() == leaves[0].untyped_storage().data_ptr() for t in leaves)
    assert est >= buffer == ledgered


def test_page_out_releases_ledger_at_once():
    store = port_store.ModelStore(budget_bytes=None)
    store.register("a", _scaler(PKGS["port"], 1))
    base = port_ledger.live_bytes("model")
    store.page_in("a")
    assert port_ledger.live_bytes("model") - base == store.stats["bytes"] == 2 * D * 8
    store.page_out("a")
    assert port_ledger.live_bytes("model") == base
    assert store.stats["bytes"] == 0 and store.resident_keys() == []
    store.check_ledger_parity()


def test_prefetch_warms_off_the_dispatch_path():
    store = port_store.ModelStore(budget_bytes=None)
    store.register("a", _scaler(PKGS["port"], 1))
    store.register("b", _scaler(PKGS["port"], 2))
    before = port_metrics.get_counter("modelstore.prefetch", 0)
    store.prefetch(["a", "b"])
    assert sorted(store.resident_keys()) == ["a", "b"]
    assert port_metrics.get_counter("modelstore.prefetch", 0) == before + 2
    store.page_out("a")
    with config.use_device("cpu"):
        worker = store.prefetch(["a"], wait=False)
    worker.join(timeout=30)
    assert not worker.is_alive()
    s = store.stats
    store.prefetch(["a", "b"])
    assert store.stats["hits"] == s["hits"] + 2


def _lr_pm(seed, d=32):
    m = port_lr.LogisticRegressionModel()
    m.coefficient = np.random.RandomState(seed).randn(d)
    m.set_features_col("features")
    return PipelineModel([m])


def test_registered_models_share_graphs_by_architecture():
    """A registered PipelineModel plans in operand mode: two tenants of one
    architecture share one graph cache; another architecture (params) or a
    stage that is not graph-shareable keeps its own."""
    store = port_store.ModelStore(budget_bytes=None)
    a, b, c = _lr_pm(1), _lr_pm(2), _lr_pm(3)
    c.stages[0].set_prediction_col("other")
    va = PipelineModel([VectorAssembler().set_input_cols("x", "y").set_output_col("features"),
                        port_lr.LogisticRegressionModel().set_features_col("features")])
    va.stages[1].coefficient = np.ones(3)
    for key, pm in (("a", a), ("b", b), ("c", c), ("va", va)):
        store.register(key, pm)

    def graphs(pm):
        (run,) = [r for r in pm._fusion_plan().runs if r[0] == "fused"]
        assert run[1].operands
        return run[1].graphs

    assert graphs(a) is graphs(b)
    assert graphs(c) is not graphs(a)
    assert graphs(va) is not graphs(a) and graphs(va) is not port_pipeline._SHARED_GRAPHS.get(
        port_pipeline._architecture(va.stages))
    assert not _lr_pm(4)._fusion_plan().runs[0][1].operands  # unregistered: per model


def test_paging_serves_every_tenant_its_own_model():
    """Tenants page in and out while serving (one fits): each served row is
    its own tenant's transform, bit for bit."""
    rng = np.random.RandomState(5)
    pms = {k: _lr_pm(i) for i, k in enumerate("abc")}
    refs = {}
    batch = Table({"features": SparseBatch(32, rng.randint(0, 32, (8, 4)).astype(np.int32),
                                           rng.rand(8, 4).astype(np.float32))})
    for k, pm in pms.items():
        refs[k] = pm.transform(batch)[0].column("rawPrediction")
    est = port_store._host_nbytes(pms["a"].stages[0]._kernel_constants())
    store = port_store.ModelStore(budget_bytes=est)
    for k, pm in pms.items():
        store.register(k, pm)
    pageins = port_metrics.get_counter("modelstore.pageIn")
    for k in "abcabcab":
        server = MicroBatchServer(store.acquire(k), in_flight=1, buckets=(8,))
        (out,) = list(server.serve([batch]))
        np.testing.assert_array_equal(out.column("rawPrediction").numpy(), refs[k])
        assert store.resident_keys() == [k]
        assert port_ledger.live_bytes("model") <= store.budget_bytes
        store.check_ledger_parity()
    assert port_metrics.get_counter("modelstore.pageIn") - pageins == 8


def test_promote_through_store_refreshes_residency():
    p = PKGS["port"]
    model = _olr(p, d=16, version=1)
    store = port_store.ModelStore(budget_bytes=None)
    store.register("t", model, lifecycle=ModelLifecycle(model), quota=4)
    assert store.quota("t") == 4 and store.lifecycle("t") is not None
    store.page_in("t")
    np.testing.assert_array_equal(store.acquire("t").device_constants()["coefficient"].numpy(),
                                  np.ones(16))
    mv = store.promote("t", (np.full(16, 2.0),))
    assert mv.version_id == 2 and store.resident_keys() == ["t"]
    store.check_ledger_parity()
    np.testing.assert_array_equal(store.acquire("t").device_constants()["coefficient"].numpy(),
                                  np.full(16, 2.0))
    store.register("u", _olr(p))
    with pytest.raises(ValueError, match="no lifecycle"):
        store.promote("u", (np.zeros(16),))


def test_external_republish_heals_on_next_page_in():
    model = _olr(PKGS["port"], d=16, version=1)
    store = port_store.ModelStore(budget_bytes=None)
    store.register("t", model)
    store.page_in("t")
    evictions = store.stats["evictions"]
    model.publish_model_arrays((np.full(16, 3.0),), 2)  # bypasses the store
    assert store.page_in("t").resident
    assert store.stats["evictions"] == evictions
    store.check_ledger_parity()
    np.testing.assert_array_equal(store.acquire("t").device_constants()["coefficient"].numpy(),
                                  np.full(16, 3.0))


def test_server_with_store_only():
    store = port_store.ModelStore(budget_bytes=None)
    store.register("known", PipelineModel([_scaler(PKGS["port"], 1)]))
    server = MicroBatchServer(store=store, in_flight=1, admission=4)
    with pytest.raises(KeyError, match="ghost"):
        server.submit(Table({"features": np.zeros((4, D), np.float32)}), tenant="ghost")
    server.submit(Table({"features": np.zeros((4, D), np.float32)}), tenant="known")
    server.close()
    results = list(server.results())
    assert [(r.status, r.tenant) for r in results] == [("ok", "known")]
    assert server.health().modelStore["models"] == 1
    with pytest.raises(TypeError, match="model"):
        MicroBatchServer()


def test_concurrent_acquires_keep_the_budget_and_the_ledger():
    """More threads than cores acquire tenants at once, with a short switch
    interval: every acquire is counted once (hits + misses), residency never
    passes the budget and the ledger matches the store."""
    import os
    import sys
    import threading

    est = port_store._host_nbytes(_scaler(PKGS["port"], 0)._kernel_constants())
    store = port_store.ModelStore(budget_bytes=3 * est)
    keys = [f"k{i}" for i in range(6)]
    for i, key in enumerate(keys):
        store.register(key, _scaler(PKGS["port"], i))
    workers, per_worker = (os.cpu_count() or 2) + 4, 60
    errors, over = [], []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            with config.use_device("cpu"):
                for _ in range(per_worker):
                    store.acquire(keys[int(rng.integers(0, len(keys)))])
                    if store.stats["bytes"] > store.budget_bytes:
                        over.append(store.stats["bytes"])
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == [] and over == []
    stats = store.stats
    assert stats["hits"] + stats["misses"] == workers * per_worker
    assert stats["resident"] <= 3
    store.check_ledger_parity()
    assert port_ledger.live_bytes("model") == stats["bytes"]


@pytest.mark.parametrize("tree", ["olr_64", "odd_leaves", "aligned_leaves", "empty_leaf"])
def test_upload_ledgers_what_it_allocates(tree):
    """`HostConstants.upload` ledgers the buffer it allocates, each leaf its
    ALIGN-byte slot: the ledgered bytes equal `HostConstants.nbytes` and
    the allocation, and drop to 0 when the tensors die (ROADMAP C.39)."""
    rng = np.random.default_rng(4)
    trees = {
        "olr_64": {"coefficient": rng.standard_normal(64).astype(np.float32),
                   "version": np.int32(3)},
        "odd_leaves": (rng.standard_normal(7), np.arange(3, dtype=np.int64), np.float32(1.5)),
        "aligned_leaves": [rng.standard_normal(32), rng.standard_normal(64).astype(np.float32)],
        "empty_leaf": {"a": np.zeros(0, np.float32), "b": rng.standard_normal(5)},
    }
    constants = port_api.HostConstants(trees[tree])
    base = port_ledger.live_bytes("model")
    uploaded = constants.upload(torch.device("cpu"))
    leaves = port_pipeline._tree_leaves(uploaded)
    assert port_ledger.tracked_nbytes(uploaded) == constants.nbytes
    assert port_ledger.live_bytes("model") - base == constants.nbytes
    assert leaves[0].untyped_storage().nbytes() == constants.nbytes
    assert constants.nbytes % port_api.HostConstants.ALIGN == 0
    for leaf in leaves:  # numpy reads them on any device (ROADMAP C.41)
        assert type(leaf) is port_table.HostReadable
        np.asarray(leaf)
    del uploaded, leaves, leaf
    assert port_ledger.live_bytes("model") == base


def test_paging_keeps_ledger_parity_at_the_estimate():
    """The store's residency is the ledger's and, for a model whose upload
    fills its 512-byte block, its estimate: a budget of 2.3 estimates holds
    two 64-wide OnlineLogisticRegression models and pages the third, with
    `check_ledger_parity` through every page-out and page-in (the
    multi-tenant example's sizing, ROADMAP C.39)."""
    p = PKGS["port"]
    models = {k: p.PM([_olr(p, d=64, version=i)]) for i, k in enumerate("abc")}
    probe = port_store.ModelStore(budget_bytes=None)
    probe.register("a", models["a"])
    est = probe.estimated_nbytes("a")
    probe.unregister("a")
    assert est == 512
    store = port_store.ModelStore(budget_bytes=int(est * 2.3))
    for k, m in models.items():
        store.register(k, m)
    base = port_ledger.live_bytes("model")
    for k in "abcabca":
        store.acquire(k)
        store.check_ledger_parity()
        assert store.stats["bytes"] == est * store.stats["resident"]
        assert port_ledger.live_bytes("model") - base == store.stats["bytes"] <= store.budget_bytes
    assert store.stats["evictions"] == 5 and store.stats["resident"] == 2
    store.page_out("a")
    store.check_ledger_parity()
    assert port_ledger.live_bytes("model") - base == store.stats["bytes"] == est
