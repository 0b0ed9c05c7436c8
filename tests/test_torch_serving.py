"""MicroBatchServer of flink_ml_tpu_torch against the JAX package.

The same seeded numpy requests go through the port's server (on the CPU,
`config.use_device("cpu")`) and the JAX package's (one device), in the
pull loop and in each push mode ("request", "fixed", "continuous"), for a
dense pipeline (StandardScaler -> Normalizer), a guarded one (Bucketizer
with handleInvalid "error") and sparse LR tenants behind a ModelStore.
Held to:

- served outputs equal to the JAX server's (float32 kernels on both:
  rtol 1e-6, atol 1e-7 for the scaler pipeline; the LR tolerances rtol
  1e-5, atol 1e-6 for scores; predictions, bucket indices and statuses
  exactly), and within 2 ulps of the port's own eager transform of the
  same rows in every mode (ROADMAP C.19: on the CPU torch's vectorized
  elementwise math and its scalar tail can differ by an ulp, so a row's
  bits may depend on its offset in the batch; on the card the modes are
  held equal bit for bit by chip_smoke.py phase 12);
- bucket padding (row counts, buckets seen), deferred guard errors raised
  in order at the batch that fired, the window released on early exit;
- admission, quotas, deadlines, retries, forming flushes and `health()` as
  tests/test_serving.py has them; one transform host sync per dispatched
  batch.

Every push-API drain runs on a thread joined with a timeout.
"""

import time
import types

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.data import modelstore as jax_store
from flink_ml_tpu.models.classification import logisticregression as jax_lr
from flink_ml_tpu.models.feature import bucketizer as jax_bucketizer
from flink_ml_tpu.models.feature import normalizer as jax_normalizer
from flink_ml_tpu.models.feature import standardscaler as jax_ss
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.pipeline import PipelineModel as JaxPipelineModel
from flink_ml_tpu.serving import MicroBatchServer as JaxServer
from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
from flink_ml_tpu_torch import SparseBatch, StreamTable, Table, config, flow
from flink_ml_tpu_torch.ckpt import faults as port_faults
from flink_ml_tpu_torch.data import modelstore as port_store
from flink_ml_tpu_torch.models.classification import logisticregression as port_lr
from flink_ml_tpu_torch.models.feature import bucketizer as port_bucketizer
from flink_ml_tpu_torch.models.feature import normalizer as port_normalizer
from flink_ml_tpu_torch.models.feature import standardscaler as port_ss
from flink_ml_tpu_torch.obs import hist, memledger
from flink_ml_tpu_torch.pipeline import PipelineModel
from flink_ml_tpu_torch.serving import MicroBatchServer, ServerOverloaded, _Readback, serve_stream
from flink_ml_tpu_torch.utils import metrics

WAIT_S = 60.0
SCALER_TOL = dict(rtol=1e-6, atol=1e-7)
LR_TOL = dict(rtol=1e-5, atol=1e-6)
#: ROADMAP C.19: on the CPU a served row and its eager twin may be ulps apart
MAX_ULP = 2
D = 4

JAX = types.SimpleNamespace(ss=jax_ss, normalizer=jax_normalizer, bucketizer=jax_bucketizer, lr=jax_lr,
                            PM=JaxPipelineModel, Server=JaxServer, Table=JaxTable,
                            SparseBatch=JaxSparseBatch, store=jax_store)
PORT = types.SimpleNamespace(ss=port_ss, normalizer=port_normalizer, bucketizer=port_bucketizer,
                             lr=port_lr, PM=PipelineModel, Server=MicroBatchServer, Table=Table,
                             SparseBatch=SparseBatch, store=port_store)


@pytest.fixture(autouse=True)
def _both_on_one_device():
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        with config.use_device("cpu"):
            yield


def _scaler_pipeline(p, d=D):
    rng = np.random.RandomState(11)
    ss = p.ss.StandardScalerModel()
    ss.mean = rng.randn(d)
    ss.std = np.abs(rng.randn(d)) + 0.1
    ss.set_input_col("features").set_output_col("scaled")
    norm = p.normalizer.Normalizer().set_p(2.0).set_input_col("scaled").set_output_col("norm")
    return p.PM([ss, norm])


def _bucketizer_pipeline(p):
    stage = (p.bucketizer.Bucketizer().set_input_cols("a").set_output_cols("oa")
             .set_splits_array([[0.0, 1.0, 2.0]]))
    return p.PM([stage])


def _lr_pipeline(p, seed, d=16):
    m = p.lr.LogisticRegressionModel()
    m.coefficient = np.random.RandomState(seed).randn(d)
    m.set_features_col("features").set_prediction_col("pred")
    return p.PM([m])


def _dense(sizes, seed=3, d=D, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, d).astype(dtype) for n in sizes]


def _sparse(sizes, seed=4, d=16, nnz=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, d, (n, nnz)).astype(np.int32), rng.rand(n, nnz).astype(np.float32))
            for n in sizes]


def _tables(p, arrays, col="features", d=16):
    if arrays and isinstance(arrays[0], tuple):
        return [p.Table({col: p.SparseBatch(d, i, v)}) for i, v in arrays]
    return [p.Table({col: a}) for a in arrays]


def _host(col):
    if isinstance(col, (SparseBatch, JaxSparseBatch)):
        return np.asarray(col.indices), np.asarray(col.values)
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


def _drain(server):
    """server.results() on a thread, joined with a timeout."""
    out = []
    errors = []

    def consume():
        try:
            out.extend(server.results())
        except BaseException as e:  # noqa: BLE001 - handed to the test
            errors.append(e)

    worker = flow.spawn(consume, name="t.results")
    worker.join(timeout=WAIT_S)
    assert not worker.is_alive(), "results() did not end"
    if errors:
        raise errors[0]
    return out


def _push(server, tables, tenants=None):
    seqs = [server.submit(t, tenant=None if tenants is None else tenants[i])
            for i, t in enumerate(tables)]
    server.close()
    return seqs, {r.seq: r for r in _drain(server)}


# ---------------------------------------------------------------------------
# served outputs against the JAX server, in every mode
# ---------------------------------------------------------------------------

MODES = ["pull", "request", "fixed", "continuous"]


def _serve(p, pm, tables, mode, col):
    kwargs = dict(in_flight=2, buckets=(8, 32))
    if mode == "pull":
        outs = list(p.Server(pm, **kwargs).serve(tables))
        return [(o.num_rows, _host(o.column(col))) for o in outs]
    server = p.Server(pm, admission=16, batching=mode, form_rows=32, form_budget_ms=20.0, **kwargs)
    seqs, results = _push(server, tables)
    assert sorted(results) == seqs
    return [(results[s].table.num_rows, _host(results[s].table.column(col))) for s in seqs]


@pytest.mark.parametrize("mode", MODES)
def test_dense_pipeline_served_equal_jax_and_eager(mode):
    arrays = _dense([3, 5, 2, 8, 1, 4, 7, 2, 13, 16])
    port_pm = _scaler_pipeline(PORT)
    got = _serve(PORT, port_pm, _tables(PORT, arrays), mode, "norm")
    want = _serve(JAX, _scaler_pipeline(JAX), _tables(JAX, arrays), mode, "norm")
    assert [n for n, _ in got] == [n for n, _ in want] == [a.shape[0] for a in arrays]
    for (_, g), (_, w), a in zip(got, want, arrays):
        np.testing.assert_allclose(g, w, **SCALER_TOL)
        eager = port_pm.transform(Table({"features": torch.as_tensor(a)}))[0].column("norm")
        np.testing.assert_array_max_ulp(g, eager.numpy(), maxulp=MAX_ULP)


@pytest.mark.parametrize("mode", ["pull", "request"])
def test_served_tensor_columns_are_host_readable(mode):
    """Numpy reads a served column on any device, as it reads the JAX
    server's device arrays (ROADMAP C.41): the served tensor columns are
    `HostReadable` views, in the pull loop and for an unsliced push
    result."""
    from flink_ml_tpu_torch.table import HostReadable

    arrays = _dense([8, 8])
    pm = _scaler_pipeline(PORT)
    tables = [Table({"features": torch.as_tensor(a)}) for a in arrays]
    if mode == "pull":
        served = list(MicroBatchServer(pm, in_flight=2, buckets=(8,)).serve(tables))
    else:
        server = MicroBatchServer(pm, in_flight=2, buckets=(8,), admission=16, batching=mode)
        seqs, results = _push(server, tables)
        served = [results[s].table for s in seqs]
    for out, a in zip(served, arrays):
        for name in out.column_names:
            assert type(out.column(name)) is HostReadable, name
        want = pm.transform(Table({"features": torch.as_tensor(a)}))[0].column("norm").numpy()
        np.testing.assert_array_equal(np.asarray(out.column("norm")), want)


@pytest.mark.parametrize("mode", MODES)
def test_sparse_lr_served_equal_jax_and_eager(mode):
    arrays = _sparse([5, 11, 1, 7, 3, 9])
    port_pm = _lr_pipeline(PORT, 1)
    for col, tol in (("rawPrediction", LR_TOL), ("pred", None)):
        got = _serve(PORT, port_pm, _tables(PORT, arrays), mode, col)
        want = _serve(JAX, _lr_pipeline(JAX, 1), _tables(JAX, arrays), mode, col)
        for (n, g), (m, w), (idx, vals) in zip(got, want, arrays):
            assert n == m == idx.shape[0]
            if tol is None:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, **tol)
            eager = port_pm.transform(Table({"features": SparseBatch(
                16, torch.as_tensor(idx), torch.as_tensor(vals))}))[0].column(col)
            if tol is None:
                np.testing.assert_array_equal(g, eager.numpy())
            else:
                np.testing.assert_array_max_ulp(g, eager.numpy(), maxulp=MAX_ULP)


def test_modes_agree_within_ulps_on_the_cpu_c19():
    """ROADMAP C.19: on the CPU the three modes and the pull loop agree
    within MAX_ULP, and not always bit for bit: these rows of the scaler
    pipeline come out of the Normalizer's `norms ** (1 / p)` (torch's
    vectorized pow, or its scalar tail, by the row's offset in the batch)
    an ulp apart in some mode."""
    arrays = _dense([3, 5, 2, 8, 1, 4, 7, 2], seed=9)
    pm = _scaler_pipeline(PORT)
    runs = [_serve(PORT, pm, _tables(PORT, arrays), mode, "norm") for mode in MODES]
    differ = False
    for run in runs[1:]:
        for (n, a), (m, b) in zip(run, runs[0]):
            assert n == m
            np.testing.assert_array_max_ulp(a, b, maxulp=MAX_ULP)
            differ |= not np.array_equal(a, b)
    assert differ, "C.19 no longer shows here: the CPU modes agree bit for bit"


def _tenant_run(p, mode, arrays, tenants):
    store = p.store.ModelStore(budget_bytes=None)
    for i, key in enumerate(("t0", "t1", "t2")):
        store.register(key, _lr_pipeline(p, 10 + i), quota=8)
    server = p.Server(store=store, in_flight=2, admission=16, buckets=(8, 32),
                      batching=mode, form_rows=32, form_budget_ms=20.0)
    if p is PORT:
        server.warmup(_tables(p, arrays[:1])[0])
    seqs, results = _push(server, _tables(p, arrays), tenants)
    return [(results[s].tenant, results[s].status, _host(results[s].table.column("rawPrediction")))
            for s in seqs], store


@pytest.mark.parametrize("mode", ["request", "fixed", "continuous"])
def test_store_tenants_served_equal_jax(mode):
    arrays = _sparse([4, 9, 2, 6, 5, 1, 8, 3], seed=6)
    tenants = ["t0", "t1", "t0", "t2", "t1", "t0", "t2", "t0"]
    got, store = _tenant_run(PORT, mode, arrays, tenants)
    want, _ = _tenant_run(JAX, mode, arrays, tenants)
    for (tg, sg, g), (tw, sw, w), (idx, vals), tenant in zip(got, want, arrays, tenants):
        assert (tg, sg) == (tw, sw) == (tenant, "ok")
        np.testing.assert_allclose(g, w, **LR_TOL)
        own = _lr_pipeline(PORT, 10 + int(tenant[1]))
        eager = own.transform(Table({"features": SparseBatch(
            16, torch.as_tensor(idx), torch.as_tensor(vals))}))[0].column("rawPrediction")
        np.testing.assert_array_max_ulp(g, eager.numpy(), maxulp=MAX_ULP)
    assert store.stats["models"] == 3


# ---------------------------------------------------------------------------
# padding, guards, the window (tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_padding_rows_and_buckets_equal_jax():
    arrays = _dense([7, 5, 3, 8, 6, 2, 9])
    counts = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        server = p.Server(_scaler_pipeline(p))
        outs = list(server.serve(_tables(p, arrays)))
        counts[name] = ([o.num_rows for o in outs], server.health().bucketsSeen)
    assert counts["port"] == counts["jax"] == ([7, 5, 3, 8, 6, 2, 9], 2)


def _guard_run(p, in_flight, batches):
    got = []
    with pytest.raises(ValueError) as ei:
        for out in p.Server(_bucketizer_pipeline(p), in_flight=in_flight).serve(
                [p.Table({"a": np.array(b, np.float32)}) for b in batches]):
            got.append(np.asarray(out.column("oa")).tolist())
    return got, str(ei.value)


@pytest.mark.parametrize("in_flight,batches", [
    (2, [[0.5, 1.5], [0.5, 99.0], [1.5, 0.5]]),
    (3, [[0.5, 99.0], [0.5, 1.5], [1.5, 0.5]]),
    (1, [[0.5, 1.5], [1.5, 1.5], [np.nan, 0.5], [0.5, 0.5]]),
])
def test_deferred_guard_error_raised_in_order_equal_jax(in_flight, batches):
    got = _guard_run(PORT, in_flight, batches)
    assert got == _guard_run(JAX, in_flight, batches)
    assert "invalid value" in got[1].lower() or "nan" in got[1].lower()


def test_push_per_request_error_does_not_kill_stream():
    statuses = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        server = p.Server(_bucketizer_pipeline(p), in_flight=2, admission=8)
        seqs, results = _push(server, [p.Table({"a": np.array(v, np.float32)}) for v in
                                       ([0.5, 1.5], [0.5, 99.0], [1.5, 0.5])])
        statuses[name] = [(results[s].status, type(results[s].error).__name__) for s in seqs]
        assert server.health().errors == 1
    assert statuses["port"] == statuses["jax"] == [("ok", "NoneType"), ("error", "ValueError"),
                                                   ("ok", "NoneType")]


def test_one_transform_sync_per_batch_whatever_the_depth():
    from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
    from flink_ml_tpu_torch.models.feature.vectorassembler import VectorAssembler

    rng = np.random.RandomState(1)
    ss = port_ss.StandardScalerModel()
    ss.mean, ss.std = rng.randn(5), np.abs(rng.randn(5)) + 0.1
    ss.set_input_col("assembled").set_output_col("scaled")
    pm = PipelineModel([
        VectorAssembler().set_input_cols("va", "vb").set_output_col("assembled"), ss,
        port_normalizer.Normalizer().set_p(2.0).set_input_col("scaled").set_output_col("norm"),
        port_bucketizer.Bucketizer().set_input_cols("raw").set_output_cols("bucket")
        .set_splits_array([[-100.0, 0.0, 100.0]]),
        Binarizer().set_input_cols("bucket").set_output_cols("bin").set_thresholds(0.5)])
    batches = [Table({"va": rng.randn(6, 2).astype(np.float32), "vb": rng.randn(6, 3).astype(np.float32),
                      "raw": rng.randn(6).astype(np.float32)}) for _ in range(4)]
    for mode in MODES:
        before = metrics.get_counter("iteration.host_sync.transform")
        if mode == "pull":
            outs = list(MicroBatchServer(pm).serve(batches))
        else:
            _, results = _push(MicroBatchServer(pm, batching=mode, form_rows=6), batches)
            outs = list(results.values())
        assert len(outs) == 4
        assert metrics.get_counter("iteration.host_sync.transform") - before == 4, mode


def test_guard_free_batches_pay_one_sync_too():
    before = metrics.get_counter("iteration.host_sync.transform")
    outs = list(MicroBatchServer(_scaler_pipeline(PORT)).serve(_tables(PORT, _dense([5, 8, 3]))))
    assert len(outs) == 3
    assert metrics.get_counter("iteration.host_sync.transform") - before == 3


def test_empty_stream_and_empty_batch():
    pm = _scaler_pipeline(PORT)
    assert serve_stream(pm, StreamTable.from_batches([])) == []
    outs = serve_stream(pm, StreamTable.from_batches(_tables(PORT, _dense([0, 4]))))
    assert [t.num_rows for t in outs] == [0, 4]


def test_server_rejects_bad_arguments():
    with pytest.raises(TypeError):
        MicroBatchServer(object())
    with pytest.raises(ValueError, match="batching"):
        MicroBatchServer(_scaler_pipeline(PORT), batching="nope")


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pm = _scaler_pipeline(PORT)
    with config.use_device("cpu"):
        pass
    prev = config._override
    config._override = None
    try:
        with pytest.raises(RuntimeError, match="CUDA device"):
            MicroBatchServer(pm)
    finally:
        config._override = prev


def test_early_termination_releases_window():
    pm = _scaler_pipeline(PORT)
    server = MicroBatchServer(pm, in_flight=3)
    before = metrics.get_counter("serving.cancelled", 0)
    it = server.serve(_tables(PORT, _dense([4] * 6)))
    got = [next(it), next(it)]
    it.close()
    assert len(got) == 2 and len(server._window) == 0 and server._window.closed
    released = metrics.get_counter("serving.cancelled", 0) - before
    assert released > 0 and server.health().cancelled == released


def test_deferred_guard_error_releases_window():
    server = MicroBatchServer(_bucketizer_pipeline(PORT), in_flight=3)
    with pytest.raises(ValueError, match="invalid value"):
        list(server.serve([Table({"a": np.array(v, np.float32)}) for v in
                           ([0.5, 99.0], [0.5, 1.5], [1.5, 0.5])]))
    assert len(server._window) == 0 and server._window.closed


# ---------------------------------------------------------------------------
# admission, deadlines, retries, health
# ---------------------------------------------------------------------------

def test_submit_rejects_when_admission_full():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=3)
    submitted = rejected = 0
    for a in _dense([8] * 40):
        try:
            server.submit(Table({"features": a}))
            submitted += 1
        except ServerOverloaded as e:
            rejected += 1
            assert e.depth <= e.capacity == 3
    server.close()
    results = _drain(server)
    assert len(results) == submitted and rejected > 0
    assert [r.seq for r in results] == sorted(r.seq for r in results)
    h = server.health()
    assert h.rejected == rejected and h.submitted == submitted
    assert server._requests.stats.peak_depth <= 3 and server._window.stats.peak_depth <= 2


def test_submit_deadline_expires_before_dispatch():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=8)
    seqs = [server.submit(Table({"features": a}), deadline_ms=0.0) for a in _dense([8] * 3)]
    server.close()
    results = {r.seq: r for r in _drain(server)}
    assert set(results) == set(seqs)
    assert all(r.status in ("expired", "late") for r in results.values())
    h = server.health()
    assert h.expired + h.late == 3


def test_transient_fault_retried_bit_identical():
    pm = _scaler_pipeline(PORT)
    tables = _tables(PORT, _dense([5, 9, 7]))
    clean = serve_stream(pm, tables)
    with config.transient_retry_mode(3):
        with port_faults.flaky("serving.batch", times=2) as plan:
            retried = serve_stream(pm, tables)
    assert plan.failures == 2
    for a, b in zip(clean, retried):
        np.testing.assert_array_equal(a.column("norm").numpy(), b.column("norm").numpy())
    with config.transient_retry_mode(0):
        with port_faults.flaky("serving.batch", times=1):
            with pytest.raises(port_faults.TransientFault):
                serve_stream(pm, tables)


def test_health_snapshot_and_ledger():
    memledger.reset()
    try:
        server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2)
        list(server.serve(_tables(PORT, _dense([4, 4]))))
        h = server.health()
        assert h.inFlight == 2 and h.windowDepth == 0 and h.bucketsSeen == 1
        assert h.emaBatchMs >= 0.0
        assert h.hbmLiveBytes == memledger.live_bytes() and h.hbmPeakBytes == memledger.peak_bytes() > 0
        assert h.hbmLiveBytes <= h.hbmPeakBytes
    finally:
        memledger.reset()


@pytest.fixture
def _clean_hist():
    hist.reset()
    hist.configure(True)
    yield hist
    hist.reset()
    hist.configure(True)


def test_stage_latency_percentiles(_clean_hist):
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16)
    for a in _dense([8] * 8):
        server.submit(Table({"features": a}))
    server.close()
    assert all(r.status == "ok" for r in _drain(server))
    h = server.health()
    for stage in ("queueWait", "batchForm", "dispatch", "readback"):
        p = h.stageLatencyMs[stage]
        assert p["count"] >= 8 and 0.0 <= p["p50"] <= p["p99"] <= p["p999"], stage
    assert h.stageLatencyMs["deadlineMargin"] is None
    server2 = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16)
    server2.submit(Table({"features": _dense([8])[0]}), deadline_ms=60_000.0)
    server2.close()
    assert [r.status for r in _drain(server2)] == ["ok"]
    assert server2.health().stageLatencyMs["deadlineMargin"]["count"] >= 1


def test_bit_identical_with_histograms_off(_clean_hist):
    pm = _scaler_pipeline(PORT)
    tables = _tables(PORT, _dense([5, 13, 9]))
    on = serve_stream(pm, tables)
    assert hist.percentiles("serving.dispatchMs")["count"] >= 3
    hist.reset()
    hist.configure(False)
    off = serve_stream(pm, tables)
    assert hist.snapshot() == {}
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.column("norm").numpy(), b.column("norm").numpy())


def test_deadline_miss_cause_attribution(_clean_hist):
    base = [metrics.get_counter(f"serving.deadlineMiss{s}", 0) for s in ("", ".expired", ".late")]
    pm = _scaler_pipeline(PORT)
    server = MicroBatchServer(pm, in_flight=2, admission=8)
    server.submit(Table({"features": _dense([8])[0]}), deadline_ms=0.0)
    server.close()
    (r,) = _drain(server)
    assert r.status == "expired"
    late = MicroBatchServer(pm, in_flight=2)
    late._out = flow.BoundedChannel(4, name="t.results")
    staged, n, _ = late._stage_batch(Table({"features": _dense([8])[0]}))
    out, pending = pm.transform_deferred(staged)
    late._retire((((0, time.monotonic() - 1.0, 0, n, None),), out,
                  _Readback(pending, out, [], staged), n))
    assert late._out.get(timeout=0).status == "late"
    after = [metrics.get_counter(f"serving.deadlineMiss{s}", 0) for s in ("", ".expired", ".late")]
    assert [a - b for a, b in zip(after, base)] == [2, 1, 1]
    assert hist.percentiles("serving.lateByMs")["count"] >= 1


# ---------------------------------------------------------------------------
# continuous and fixed batching, tenants
# ---------------------------------------------------------------------------

def test_continuous_bucket_full_flushes_immediately():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16, buckets=(8,),
                              batching="continuous", form_rows=8, form_budget_ms=10_000.0)
    before = metrics.get_counter("serving.coalesced", 0)
    t0 = time.monotonic()
    for a in _dense([4, 4]):
        server.submit(Table({"features": a}))
    it = server._out
    results = [it.get(timeout=WAIT_S), it.get(timeout=WAIT_S)]
    dt = time.monotonic() - t0
    server.close()
    _drain(server)
    assert [(r.status, r.table.num_rows) for r in results] == [("ok", 4), ("ok", 4)]
    assert dt < 5.0 and metrics.get_counter("serving.coalesced", 0) >= before + 2


def test_continuous_form_budget_flushes_partial_batch():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16,
                              batching="continuous", form_rows=64, form_budget_ms=30.0)
    t0 = time.monotonic()
    server.submit(Table({"features": _dense([2])[0]}))
    r = server._out.get(timeout=WAIT_S)
    dt = time.monotonic() - t0
    server.close()
    _drain(server)
    assert r.status == "ok" and r.table.num_rows == 2 and dt < 5.0


def test_fixed_batching_waits_for_full_bucket():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16, batching="fixed",
                              form_rows=8)
    server.submit(Table({"features": _dense([4])[0]}))
    time.sleep(0.25)
    assert len(server._out) == 0
    server.close()
    (r,) = _drain(server)
    assert r.status == "ok" and r.table.num_rows == 4


def test_continuous_never_coalesces_across_tenants():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16,
                              batching="continuous", form_rows=8, form_budget_ms=60.0)
    before = metrics.get_counter("serving.coalesced", 0)
    _, results = _push(server, _tables(PORT, _dense([4, 4])), tenants=["a", "b"])
    assert sorted(r.tenant for r in results.values()) == ["a", "b"]
    assert all(r.status == "ok" for r in results.values())
    assert metrics.get_counter("serving.coalesced", 0) == before


def test_continuous_incompatible_signature_flushes_old_first():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16,
                              batching="continuous", form_rows=64, form_budget_ms=60.0)
    before = metrics.get_counter("serving.coalesced", 0)
    server.submit(Table({"features": _dense([3])[0]}))
    server.submit(Table({"features": _dense([3], dtype=np.float64)[0]}))
    server.close()
    results = _drain(server)
    assert [r.seq for r in results] == [0, 1]
    assert [(r.status, r.table.num_rows) for r in results] == [("ok", 3), ("ok", 3)]
    assert metrics.get_counter("serving.coalesced", 0) == before


def test_continuous_expired_while_forming_is_shed():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=2, admission=16, batching="fixed",
                              form_rows=64)
    server.submit(Table({"features": _dense([2])[0]}), deadline_ms=30.0)
    time.sleep(0.08)
    server.close()
    (r,) = _drain(server)
    assert r.status == "expired"


def test_tenant_quota_rejects_are_typed_and_attributed():
    server = MicroBatchServer(_scaler_pipeline(PORT), in_flight=1, admission=32,
                              batching="continuous", form_rows=4, tenant_quotas={"A": 2})
    before = metrics.get_counter("serving.rejected.tenant.A", 0)
    accepted = rejected = 0
    for a in _dense([4] * 12):
        try:
            server.submit(Table({"features": a}), tenant="A")
            accepted += 1
        except ServerOverloaded as e:
            rejected += 1
            assert e.channel == "serving.tenant.A" and e.capacity == 2
    assert rejected > 0
    server.close()
    results = _drain(server)
    assert len(results) == accepted and all(r.tenant == "A" for r in results)
    assert metrics.get_counter("serving.rejected.tenant.A", 0) == before + rejected
    h = server.health()
    assert h.tenantAdmission["A"]["rejected"] == rejected and h.tenantAdmission["A"]["capacity"] == 2


def test_warmup_pages_tenants_and_drives_every_bucket():
    store = port_store.ModelStore(budget_bytes=None)
    for i, key in enumerate(("t0", "t1")):
        store.register(key, _lr_pipeline(PORT, i))
    server = MicroBatchServer(store=store, buckets=(8, 32))
    out = store.warmup_programs(server, _tables(PORT, _sparse([3]))[0])
    assert out["programs"] == 4.0 and sorted(store.resident_keys()) == ["t0", "t1"]
    assert server.health().bucketsSeen == 2


def test_pull_loop_takes_tenant_pairs():
    """The port's pull loop also takes (tenant, Table) pairs, each served by
    its tenant's store model: the same rows as the push API gives."""
    arrays = _sparse([4, 9, 2, 6], seed=8)
    tenants = ["t0", "t1", "t0", "t1"]
    store = port_store.ModelStore(budget_bytes=None)
    for i, key in enumerate(("t0", "t1")):
        store.register(key, _lr_pipeline(PORT, 20 + i))
    tables = _tables(PORT, arrays)
    pulled = list(MicroBatchServer(store=store, buckets=(8, 32)).serve(zip(tenants, tables)))
    _, pushed = _push(MicroBatchServer(store=store, buckets=(8, 32)), tables, tenants)
    for i, out in enumerate(pulled):
        np.testing.assert_array_equal(out.column("rawPrediction").numpy(),
                                      _host(pushed[i].table.column("rawPrediction")))
    with pytest.raises(TypeError, match="no default model"):
        list(MicroBatchServer(store=store).serve(tables[:1]))


@pytest.mark.parametrize("mode", ["request", "continuous"])
def test_server_faults_end_the_stream_data_errors_do_not(mode):
    """A RuntimeError from the dispatch (a kernel that fails to build, a
    refused capture) ends the push stream and results() raises it; a data
    error comes back as that request's "error" result."""
    pm = _scaler_pipeline(PORT)
    real = pm.transform_deferred
    calls = {"n": 0}

    def flaky_backend(table):
        calls["n"] += 1
        if calls["n"] == 2:
            raise ValueError("bad request")
        if calls["n"] == 3:
            raise RuntimeError("nvcc failed to build the kernel")
        return real(table)

    pm.transform_deferred = flaky_backend
    server = MicroBatchServer(pm, admission=8, batching=mode, form_rows=4, form_budget_ms=1.0)
    for a in _dense([4, 4, 4, 4]):  # each fills its bucket: one request a batch
        server.submit(Table({"features": a}))
    server.close()
    with pytest.raises(RuntimeError, match="nvcc"):
        _drain(server)
    assert server.health().errors == 1
