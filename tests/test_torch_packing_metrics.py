"""The port's readback funnel and metrics registry against the JAX package's.

`utils/packing.packed_device_get` gets the same seeded numpy arrays as
the JAX function (as CPU tensors and as `jax.Array`s): equal host values,
shapes and dtypes, host inputs passed through, one accounted host sync of
the named kind per call with a tensor, none without. `utils/metrics` runs
the same sequence of timers, gauges and counters as the JAX registry: the
same snapshot keys, counts, gauges and counters, and the same
`snapshot_delta`. The linear fit and its host transform each pay one
readback through the funnel (`_linear.packed_to_host`).
"""

import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.obs import tracing as jax_tracing
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu.utils import packing as jax_packing
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch.models import _linear
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.obs import tracing
from flink_ml_tpu_torch.utils import metrics, packing


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(-5, 5, (7,)).astype(np.int32),
            np.asarray(rng.random() > 0.5),
            rng.standard_normal((2, 0, 3)).astype(np.float32)]


def _syncs(registry, kind):
    return (registry.get_counter("iteration.host_sync"),
            registry.get_counter(f"iteration.host_sync.{kind}"))


@pytest.mark.parametrize("count", [1, 2, 4])
def test_packed_device_get_matches_jax(count):
    arrays = _arrays(count)[:count]
    jax_before, before = _syncs(jax_metrics, "fit"), _syncs(metrics, "fit")
    want = jax_packing.packed_device_get(*[jax.device_put(a) for a in arrays], sync_kind="fit")
    got = packing.packed_device_get(*[torch.from_numpy(np.array(a)) for a in arrays],
                                    sync_kind="fit")
    for g, w, a in zip(got, want, arrays):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype == a.dtype and g.shape == a.shape
        np.testing.assert_array_equal(g, w)
    jax_after, after = _syncs(jax_metrics, "fit"), _syncs(metrics, "fit")
    assert [b - a for a, b in zip(before, after)] == [1, 1]
    assert [b - a for a, b in zip(jax_before, jax_after)] == [1, 1]


def test_host_inputs_pass_through_without_a_sync():
    arrays = _arrays(5)
    before = _syncs(metrics, "readback")
    got = packing.packed_device_get(*arrays)
    assert _syncs(metrics, "readback") == before
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g, a)
    mixed = packing.packed_device_get(arrays[0], torch.from_numpy(arrays[1]))
    np.testing.assert_array_equal(mixed[1], arrays[1])
    assert _syncs(metrics, "readback")[1] == before[1] + 1


def test_readback_accounting_matches_jax():
    for registry, account in ((jax_metrics, jax_tracing), (metrics, tracing)):
        before = registry.snapshot()
        account.account_readback(64, 0.001, arrays=2)
        account.account_host_sync("transform", count=3)
        delta = registry.snapshot_delta(before, registry.snapshot())
        assert delta["counters"]["readback.count"] == 1
        assert delta["counters"]["readback.bytes"] == 64
        assert delta["counters"]["iteration.host_sync"] == 3
        assert delta["counters"]["iteration.host_sync.transform"] == 3
        assert delta["timers"]["readback"]["count"] == 1


def _drive(registry):
    with registry.timed("pipeline.fit"):
        pass
    registry.record_time("pipeline.transform", 0.25)
    registry.record_time("pipeline.transform", 0.5)
    registry.set_gauge("pipeline.fused_segments", 2)
    registry.inc_counter("jit.traces")
    registry.inc_counter("jit.traces", 4)
    return registry.snapshot()


def test_metrics_registry_matches_jax():
    deltas = []
    for registry in (jax_metrics, metrics):
        before = registry.snapshot()
        traces = registry.get_counter("jit.traces")
        transform_s = registry.timer_totals().get("pipeline.transform", 0.0)
        delta = registry.snapshot_delta(before, _drive(registry))
        assert registry.get_counter("jit.traces") == traces + 5
        assert registry.get_gauge("pipeline.fused_segments") == 2
        assert registry.get_gauge("missing", 7) == 7
        assert registry.timer_totals()["pipeline.transform"] == pytest.approx(transform_s + 0.75)
        deltas.append(delta)
    want, got = deltas
    assert got["counters"] == want["counters"] == {"jit.traces": 5}
    assert got["gauges"]["pipeline.fused_segments"] == want["gauges"]["pipeline.fused_segments"]
    assert sorted(got["timers"]) == sorted(want["timers"])
    for name in want["timers"]:
        assert got["timers"][name]["count"] == want["timers"][name]["count"]
    assert got["timers"]["pipeline.transform"]["totalMs"] == pytest.approx(750.0)
    assert got["timers"]["pipeline.transform"]["lastMs"] == pytest.approx(500.0)
    metrics.reset()
    assert metrics.snapshot() == {"timers": {}, "gauges": {}, "counters": {}}


def test_profile_trace_writes_a_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path)):
        torch.ones(16).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))


def test_fit_and_host_transform_each_read_back_once():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((64, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    table = Table({"features": X, "label": y})
    with config.use_device("cpu"):
        before = metrics.snapshot()
        model = LogisticRegression().set_max_iter(3).fit(table)
        fit = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
        before = metrics.snapshot()
        out = model.transform(table)[0]
        transform = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
    assert fit["iteration.host_sync"] == fit["iteration.host_sync.fit"] == 1
    assert transform["iteration.host_sync"] == transform["iteration.host_sync.transform"] == 1
    assert out.column("rawPrediction").dtype == np.float64


def test_packed_to_host_keeps_float64():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.tensor([1, 2], dtype=torch.int32)
    before = metrics.get_counter("iteration.host_sync.fit")
    ha, hb = _linear.packed_to_host(a, b)
    assert metrics.get_counter("iteration.host_sync.fit") == before + 1
    assert ha.dtype == hb.dtype == np.float64 and ha.shape == (2, 3)
    np.testing.assert_array_equal(ha, a.numpy())
    np.testing.assert_array_equal(hb, [1.0, 2.0])
