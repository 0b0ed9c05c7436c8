"""Flow control, fault sites, histograms, the timeline, the ledger and the
overload policies of flink_ml_tpu_torch against the JAX package.

Each case of tests/test_flow.py runs on both packages (`flow`, `ckpt.faults`,
`config`, `utils.metrics`) and must give the same record, exactly: the
items consumed, the channel's stats, the counters moved, the errors
raised. `hist.percentiles` must equal the JAX package's for the same
recorded values. The lossy ingest policies ("shed_oldest", "sample") must
shed the same items in the port's `Prefetcher` and online ingest as in the
JAX package's (the `flow.shed` counters move alike): the source holds its
second item back until the consumer has the first, so the items the
window keeps do not depend on thread timing. Every wait on a thread is
bounded by a timeout.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import jax

import flink_ml_tpu.config as jax_config
import flink_ml_tpu.flow as jax_flow
from flink_ml_tpu import StreamTable as JaxStreamTable
from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.ckpt import faults as jax_faults
from flink_ml_tpu.linalg import DenseVector as JaxDenseVector
from flink_ml_tpu.models.classification import onlinelogisticregression as jax_olr
from flink_ml_tpu.models.clustering import onlinekmeans as jax_okm
from flink_ml_tpu.obs import hist as jax_hist
from flink_ml_tpu.parallel import mesh as mesh_lib
from flink_ml_tpu.parallel import prefetch as jax_prefetch
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import StreamTable, Table
from flink_ml_tpu_torch import config as port_config
from flink_ml_tpu_torch import flow as port_flow
from flink_ml_tpu_torch.ckpt import faults as port_faults
from flink_ml_tpu_torch.linalg import DenseVector
from flink_ml_tpu_torch.models.classification import onlinelogisticregression as port_olr
from flink_ml_tpu_torch.models.clustering import onlinekmeans as port_okm
from flink_ml_tpu_torch.obs import hist as port_hist
from flink_ml_tpu_torch.obs import memledger, timeline, tracing
from flink_ml_tpu_torch.parallel import prefetch as port_prefetch
from flink_ml_tpu_torch.utils import metrics as port_metrics

WAIT_S = 30.0
FTRL_TOL = dict(rtol=1e-5, atol=1e-6)

PKGS = {
    "jax": types.SimpleNamespace(flow=jax_flow, faults=jax_faults, config=jax_config,
                                 metrics=jax_metrics),
    "port": types.SimpleNamespace(flow=port_flow, faults=port_faults, config=port_config,
                                  metrics=port_metrics),
}


def _join(worker):
    worker.join(timeout=WAIT_S)
    assert not worker.is_alive(), "worker did not finish"


def _counter(p, name):
    return p.metrics.get_counter(name, 0)


# ---------------------------------------------------------------------------
# the cases of tests/test_flow.py, each a function of one package
# ---------------------------------------------------------------------------

def block_lossless_in_order(p):
    chan = p.flow.BoundedChannel(3, name="t.block")
    _join_later = p.flow.pump(range(50), chan, transform=lambda i: i * i)
    got = list(chan)
    _join(_join_later)
    s = chan.stats
    return got, s.puts, s.gets, s.shed, s.rejected, s.peak_depth <= 3


def block_backpressures_producer(p):
    staged = []
    chan = p.flow.BoundedChannel(2, name="t.credit")
    worker = p.flow.pump(range(100), chan, transform=lambda i: staged.append(i) or i)
    first = chan.get(timeout=WAIT_S)
    time.sleep(0.05)
    bounded = len(staged) <= 1 + 2 + 1
    chan.cancel()
    _join(worker)
    return first, bounded, chan.credits() >= 0


def shed_oldest_bounds(p):
    capacity = 4
    chan = p.flow.BoundedChannel(capacity, policy=p.flow.SHED_OLDEST, name="t.shed")
    accepted, consumed = [], []
    for burst in range(8):
        for i in range(capacity * 25):
            accepted.append(chan.put(burst * 100 + i))
        consumed.append(chan.get(timeout=0))
    s = chan.stats
    return all(accepted), consumed, len(chan), s.shed, s.max_lag, s.max_lag < capacity, chan.cancel()


def sample_keeps_prefix(p):
    chan = p.flow.BoundedChannel(2, policy=p.flow.SAMPLE, name="t.sample")
    puts = [chan.put("a"), chan.put("b"), chan.put("c")]
    return puts, chan.stats.shed, chan.get(timeout=0), chan.get(timeout=0)


def reject_typed(p):
    chan = p.flow.BoundedChannel(2, policy=p.flow.REJECT, name="t.reject")
    chan.put(1)
    chan.put(2)
    with pytest.raises(p.flow.ChannelRejected) as ei:
        chan.put(3)
    e = ei.value
    chan.get(timeout=0)
    return e.depth, e.capacity, e.channel, chan.stats.rejected, chan.put(3), str(e)


def put_get_timeouts(p):
    chan = p.flow.BoundedChannel(1, name="t.timeout")
    with pytest.raises(TimeoutError) as e1:
        chan.get(timeout=0.01)
    chan.put("x")
    with pytest.raises(TimeoutError) as e2:
        chan.put("y", timeout=0.01)
    return str(e1.value), str(e2.value)


def close_then_drain(p):
    chan = p.flow.BoundedChannel(4, name="t.close")
    chan.put(1)
    chan.put(2)
    chan.close()
    got = [chan.get(timeout=0), chan.get(timeout=0)]
    with pytest.raises(p.flow.ChannelClosed):
        chan.get(timeout=0)
    with pytest.raises(p.flow.ChannelClosed):
        chan.put(3)
    return got, chan.closed


def cancel_returns_queued(p):
    chan = p.flow.BoundedChannel(4, name="t.cancel")
    chan.put("a")
    chan.put("b")
    return chan.cancel(), len(chan)


def error_in_order(p):
    chan = p.flow.BoundedChannel(8, name="t.err")
    chan.put(1)
    chan.close(error=RuntimeError("boom"))
    first = chan.get(timeout=0)
    with pytest.raises(RuntimeError, match="boom"):
        chan.get(timeout=0)
    return first


def channel_counters(p):
    shed0, rej0 = _counter(p, "flow.shed"), _counter(p, "flow.reject")
    chan = p.flow.BoundedChannel(1, policy=p.flow.SHED_OLDEST, name="t.metrics")
    chan.put(1)
    chan.put(2)
    shed = _counter(p, "flow.shed") - shed0
    chan2 = p.flow.BoundedChannel(1, policy=p.flow.REJECT, name="t.metrics2")
    chan2.put(1)
    with pytest.raises(p.flow.ChannelRejected):
        chan2.put(2)
    return (shed, _counter(p, "flow.reject") - rej0, p.metrics.get_gauge("flow.peakQueueDepth", 0) >= 1,
            p.metrics.get_gauge("flow.lag.t.metrics") is None)


def offer_is_policy_free(p):
    chan = p.flow.BoundedChannel(2, policy=p.flow.REJECT, name="t.offer")
    return [chan.offer(i) for i in range(4)], chan.stats.rejected, chan.full()


def source_error_propagates(p):
    def items():
        yield 1
        yield 2
        raise OSError("source died")

    chan = p.flow.BoundedChannel(8, name="p.err")
    worker = p.flow.pump(items(), chan)
    got = []
    with pytest.raises(OSError, match="source died"):
        for x in chan:
            got.append(x)
    _join(worker)
    return got


def transform_error_propagates(p):
    chan = p.flow.BoundedChannel(8, name="p.terr")
    worker = p.flow.pump(range(10), chan, transform=lambda i: 1 // (3 - i) and i)
    with pytest.raises(ZeroDivisionError):
        list(chan)
    _join(worker)
    return True


def consumer_cancel_stops_producer(p):
    staged = []

    def stage(i):
        staged.append(i)
        return i

    chan = p.flow.BoundedChannel(2, name="p.cancel")
    worker = p.flow.pump(range(1000), chan, transform=stage)
    first = chan.get(timeout=WAIT_S)
    chan.cancel()
    _join(worker)
    return first, len(staged) <= 6


def worker_completes(p):
    chan = p.flow.BoundedChannel(4, name="p.done")
    worker = p.flow.pump(range(5), chan)
    got = list(chan)
    _join(worker)
    return got


def spawn_runs_named_daemon(p):
    seen = []
    worker = p.flow.spawn(lambda: seen.append(threading.current_thread().name), name="probe")
    _join(worker)
    return seen, worker.daemon


def transient_retried_to_success(p):
    calls = {"n": 0}

    def flaky_fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise p.flow.TransientError("blip")
        return "ok"

    before = _counter(p, "flow.retry")
    out = p.flow.with_retries(flaky_fn, retries=5, base_delay_s=1e-4, site="s")
    return out, calls["n"], _counter(p, "flow.retry") - before


def budget_exhaustion(p):
    err = p.flow.TransientError("persistent")

    def always():
        raise err

    with pytest.raises(p.flow.TransientError) as ei:
        p.flow.with_retries(always, retries=2, base_delay_s=1e-4)
    return ei.value is err, ei.value.retry_attempts


def non_retryable(p):
    calls = {"n": 0}

    def data_error():
        calls["n"] += 1
        raise ValueError("bad data")

    with pytest.raises(ValueError):
        p.flow.with_retries(data_error, retries=5)
    return calls["n"]


def injected_fault_is_a_crash(p):
    calls = {"n": 0}

    def killed():
        calls["n"] += 1
        raise p.faults.InjectedFault("site", 1)

    with pytest.raises(p.faults.InjectedFault):
        p.flow.with_retries(killed, retries=10)
    return calls["n"]


def zero_budget_fails_fast(p):
    calls = {"n": 0}

    def once():
        calls["n"] += 1
        raise p.flow.TransientError("x")

    with p.config.transient_retry_mode(0):
        with pytest.raises(p.flow.TransientError):
            p.flow.with_retries(once)
    return calls["n"]


def deadline_bounds_time(p):
    def always():
        raise p.flow.TransientError("slow")

    t0 = time.perf_counter()
    with pytest.raises(p.flow.TransientError) as ei:
        p.flow.with_retries(always, retries=10_000, base_delay_s=0.02, deadline_s=0.05)
    return time.perf_counter() - t0 < 2.0, ei.value.retry_attempts < 10_000


def oserror_is_transient(p):
    calls = {"n": 0}

    def io():
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("fs blip")
        return 7

    return p.flow.with_retries(io, retries=2, base_delay_s=1e-4), calls["n"]


def flaky_fails_then_succeeds(p):
    outcomes = []
    with p.faults.flaky("soak.site", times=2) as plan:
        for _ in range(4):
            try:
                p.faults.tick("soak.site")
                outcomes.append("pass")
            except p.faults.TransientFault as e:
                outcomes.append(str(e))
    return outcomes, plan.failures, plan.hits


def transient_retryable_injected_not(p):
    with p.faults.flaky("retry.site", times=2):
        out = p.flow.with_retries(lambda: p.faults.tick("retry.site") or "ok", retries=3,
                                  base_delay_s=1e-4)
    return (issubclass(p.faults.TransientFault, p.flow.TransientError),
            issubclass(p.faults.InjectedFault, p.flow.TransientError), out)


def flaky_and_inject_coexist(p):
    with p.faults.inject("fatal.site", after=1) as plan:
        with p.faults.flaky("blip.site", times=1):
            with pytest.raises(p.faults.TransientFault):
                p.faults.tick("blip.site")
            with pytest.raises(p.faults.InjectedFault) as ei:
                p.faults.tick("fatal.site")
            p.faults.tick("fatal.site")  # a fired plan stays quiet
    return plan.fired, plan.hits, str(ei.value), p.faults.armed()


def unmatched_site_passes(p):
    with p.faults.flaky("somewhere", times=5) as plan:
        p.faults.tick("elsewhere")
    return plan.hits, plan.failures


def failing_map_raises_mid_stream(p):
    items = [np.zeros((3, 2)), np.zeros((4, 2)), np.zeros((5, 2))]
    got = []
    with pytest.raises(p.faults.InjectedFault) as ei:
        for item in p.faults.failing_map(items, after_records=7):
            got.append(item.shape[0])
    return got, ei.value.site, ei.value.hits


def watchdog_flags_beyond_factor(p):
    wd = p.flow.StragglerWatchdog("t.stage", factor=3.0, warmup=3)
    before = _counter(p, "flow.straggler.t.stage")
    flags = [wd.record(0.010) for _ in range(5)] + [wd.record(0.050)]
    return (flags, _counter(p, "flow.straggler.t.stage") - before,
            p.metrics.get_gauge("flow.straggler.t.stage.lastMs"), wd.trailing_mean_s, wd.samples)


def watchdog_warmup_never_flags(p):
    wd = p.flow.StragglerWatchdog("t.warm", factor=2.0, warmup=10)
    return [wd.record(t) for t in (0.001, 0.5, 0.001, 0.9)]


def watchdog_mean_adapts(p):
    wd = p.flow.StragglerWatchdog("t.adapt", factor=3.0, warmup=2, alpha=0.5)
    return [wd.record(0.01) for _ in range(4)] + [wd.record(0.2) for _ in range(8)]


def watchdog_observe(p):
    wd = p.flow.StragglerWatchdog("t.obs", warmup=1)
    with wd.observe():
        pass
    return wd.samples, wd.trailing_mean_s >= 0.0, wd.factor


def escalation_counter_only_by_default(p):
    wd = p.flow.StragglerWatchdog("t.noesc", factor=2.0, warmup=2)
    flags = [wd.record(0.01) for _ in range(3)] + [wd.record(0.03 * (3 ** k)) for k in range(6)]
    return flags, wd.consecutive_flags


def escalation_with_evidence(p):
    wd = p.flow.StragglerWatchdog("t.esc", factor=2.0, warmup=2, escalate=3)
    before = _counter(p, "flow.straggler.t.esc.escalated")
    flags = [wd.record(0.01) for _ in range(3)] + [wd.record(0.5), wd.record(0.5)]
    with pytest.raises(p.flow.PersistentStraggler) as ei:
        wd.record(0.5)
    e = ei.value
    return (flags, e.stage, e.consecutive, e.seconds, e.mean_s,
            _counter(p, "flow.straggler.t.esc.escalated") - before, wd.consecutive_flags, str(e))


def escalation_healthy_sample_resets(p):
    wd = p.flow.StragglerWatchdog("t.reset", factor=3.0, warmup=2, alpha=0.05, escalate=3)
    flags = [wd.record(0.01) for _ in range(4)] + [wd.record(0.1), wd.record(0.1), wd.record(0.01)]
    streak = wd.consecutive_flags
    return flags + [wd.record(0.2), wd.record(0.2)], streak


def escalation_opt_in_via_config(p):
    wd = p.flow.StragglerWatchdog("t.cfg", factor=2.0, warmup=2)
    for _ in range(3):
        wd.record(0.01)
    with p.config.straggler_escalation_mode(2):
        inside = wd.escalate_after
        flag = wd.record(0.5)
        with pytest.raises(p.flow.PersistentStraggler):
            wd.record(0.5)
    return inside, flag, wd.escalate_after


def config_scoped_modes(p):
    c = p.config
    seen = [c.online_overload_policy]
    with c.online_overload_mode("shed_oldest"):
        seen.append(c.online_overload_policy)
    seen.append(c.online_overload_policy)
    with pytest.raises(ValueError):
        with c.online_overload_mode("nope"):
            pass
    prev = c.transient_retries
    with c.transient_retry_mode(7):
        seen.append(c.transient_retries)
    seen.append(c.transient_retries == prev)
    with c.model_store_budget(123):
        seen.append(c.model_store_bytes)
    with c.serving_form_budget(2.5):
        seen.append(c.serving_form_budget_ms)
    with c.model_retention_mode(1):
        seen.append(c.model_versions_retained)
    with c.hbm_budget_mode(10):
        seen.append(c.hbm_budget_bytes)
    defaults = (c.serving_in_flight, c.serving_admission, c.serving_deadline_ms,
                c.serving_form_budget_ms, c.transient_retries, c.retry_base_delay_s,
                c.retry_max_delay_s, c.straggler_factor, c.straggler_escalate,
                c.model_store_bytes, c.model_versions_retained, c.lifecycle_canary_rtol,
                c.lifecycle_health_window, c.lifecycle_error_rate_trigger, c.hbm_budget_bytes)
    return seen, defaults


def unknown_policy_rejected(p):
    with pytest.raises(ValueError) as ei:
        p.flow.BoundedChannel(2, policy="nope")
    return str(ei.value)


FLOW_CASES = {f.__name__: f for f in (
    block_lossless_in_order, block_backpressures_producer, shed_oldest_bounds, sample_keeps_prefix,
    reject_typed, put_get_timeouts, close_then_drain, cancel_returns_queued, error_in_order,
    channel_counters, offer_is_policy_free, source_error_propagates, transform_error_propagates,
    consumer_cancel_stops_producer, worker_completes, spawn_runs_named_daemon,
    transient_retried_to_success, budget_exhaustion, non_retryable, injected_fault_is_a_crash,
    zero_budget_fails_fast, deadline_bounds_time, oserror_is_transient, flaky_fails_then_succeeds,
    transient_retryable_injected_not, flaky_and_inject_coexist, unmatched_site_passes,
    failing_map_raises_mid_stream, watchdog_flags_beyond_factor, watchdog_warmup_never_flags,
    watchdog_mean_adapts, watchdog_observe, escalation_counter_only_by_default,
    escalation_with_evidence, escalation_healthy_sample_resets, escalation_opt_in_via_config,
    config_scoped_modes, unknown_policy_rejected)}

#: what the cases of tests/test_flow.py assert, held on the port's record
EXPECTED = {
    "block_lossless_in_order": lambda r: r == ([i * i for i in range(50)], 50, 50, 0, 0, True),
    "block_backpressures_producer": lambda r: r == (0, True, True),
    "shed_oldest_bounds": lambda r: r[0] and r[2] <= 4 and r[3] > 0 and r[5],
    "sample_keeps_prefix": lambda r: r == ([True, True, False], 1, "a", "b"),
    "reject_typed": lambda r: r[:5] == (2, 2, "t.reject", 1, True),
    "close_then_drain": lambda r: r == ([1, 2], True),
    "cancel_returns_queued": lambda r: r == (["a", "b"], 0),
    "error_in_order": lambda r: r == 1,
    "channel_counters": lambda r: r == (1, 1, True, True),
    "source_error_propagates": lambda r: r == [1, 2],
    "consumer_cancel_stops_producer": lambda r: r == (0, True),
    "worker_completes": lambda r: r == list(range(5)),
    "transient_retried_to_success": lambda r: r == ("ok", 3, 2),
    "budget_exhaustion": lambda r: r == (True, 3),
    "non_retryable": lambda r: r == 1,
    "injected_fault_is_a_crash": lambda r: r == 1,
    "zero_budget_fails_fast": lambda r: r == 1,
    "deadline_bounds_time": lambda r: r == (True, True),
    "oserror_is_transient": lambda r: r == (7, 2),
    "transient_retryable_injected_not": lambda r: r == (True, False, "ok"),
    "watchdog_warmup_never_flags": lambda r: not any(r),
    "escalation_counter_only_by_default": lambda r: r[1] == 6,
}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_flow_case_equals_jax(case):
    """Each case gives the same record on both packages (exactly), and the
    port's record meets what tests/test_flow.py asserts."""
    fn = FLOW_CASES[case]
    want = fn(PKGS["jax"])
    got = fn(PKGS["port"])
    assert got == want
    if case in EXPECTED:
        assert EXPECTED[case](got), got


# ---------------------------------------------------------------------------
# obs/hist.py: the same percentiles for the same values
# ---------------------------------------------------------------------------

def _values(kind, rng):
    if kind == "uniform_ms":
        return rng.uniform(0.01, 50.0, 5000)
    if kind == "lognormal":
        return rng.lognormal(0.0, 3.0, 5000)
    if kind == "with_zeros_and_negatives":
        return np.concatenate([rng.normal(0.0, 1.0, 500), np.zeros(50)])
    if kind == "extremes":
        return np.array([1e-30, 1e-12, 1.0, 3.0, 1e12, 1e30, 2.0 ** -47, 2.0 ** 47])
    if kind == "few":
        return np.array([4.0, 1.5])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["uniform_ms", "lognormal", "with_zeros_and_negatives",
                                  "extremes", "few"])
def test_hist_percentiles_equal_jax(kind):
    values = _values(kind, np.random.default_rng(3))
    name = f"t.hist.{kind}"
    for h in (jax_hist, port_hist):
        h.configure(True)
        h._hists.pop(name, None)
        for v in values:
            h.record(name, float(v))
    got, want = port_hist.percentiles(name), jax_hist.percentiles(name)
    assert got == want
    assert port_hist.get(name).to_dict() == jax_hist.get(name).to_dict()
    merged_port = port_hist.Histogram("m").merge(port_hist.get(name)).merge(
        port_hist.Histogram.from_dict(port_hist.get(name).to_dict()))
    merged_jax = jax_hist.Histogram("m").merge(jax_hist.get(name)).merge(
        jax_hist.Histogram.from_dict(jax_hist.get(name).to_dict()))
    assert merged_port.to_dict() == merged_jax.to_dict()
    for h in (jax_hist, port_hist):
        h._hists.pop(name, None)


def test_hist_disabled_records_nothing_and_empty_is_none():
    name = "t.hist.off"
    try:
        port_hist.configure(False)
        port_hist.record(name, 1.0)
        assert name not in port_hist.snapshot()
    finally:
        port_hist.configure(True)
    assert port_hist.percentiles(name) is None
    assert port_hist.Histogram().percentile(0.5) is None
    assert port_hist.BUCKETS == jax_hist.BUCKETS
    assert [port_hist.bucket_upper_bound(i) for i in range(96)] == \
        [jax_hist.bucket_upper_bound(i) for i in range(96)]


# ---------------------------------------------------------------------------
# obs/timeline.py, obs/tracing.py span, obs/memledger.py
# ---------------------------------------------------------------------------

def test_timeline_ring_records_flow_events_and_spans():
    timeline.configure(ring_size=64)
    try:
        assert timeline.enabled() and tracing.enabled()
        chan = port_flow.BoundedChannel(1, policy=port_flow.SHED_OLDEST, name="t.tl")
        chan.put(1)
        chan.put(2)
        with tracing.span("t.span", k=1):
            pass
        events = timeline.drain()
        names = [e["name"] for e in events]
        assert names[:3] == ["t.tl.put", "t.tl.shed", "t.tl.put"]
        assert [e["ph"] for e in events if e["name"] == "t.span"] == ["B", "E"]
        assert all(e["lane"] == timeline.LANE_FLOW for e in events[:3])
    finally:
        timeline.configure(None)
    assert not timeline.enabled() and not tracing.enabled()
    assert tracing.span("t.off") is tracing.span("t.off2")  # the shared no-op


def test_timeline_ring_wraps_and_reports_truncation():
    ring = timeline.TimelineRing(16)
    for i in range(40):
        ring.append(("i", "flow", str(i), i, 0, None, None))
    events, truncated = ring.events()
    assert [e[2] for e in events] == [str(i) for i in range(24, 40)]
    assert truncated == 24


def test_span_ring_records_nesting():
    tracing.configure(ring_size=8)
    try:
        with tracing.span("outer", a=1):
            with tracing.span("inner") as s:
                s.set_attr("b", 2)
        records = tracing.drain_ring()
    finally:
        tracing.configure(None)
    inner, outer = records
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parentId"] == outer["spanId"] and outer["parentId"] == 0
    assert inner["attrs"] == {"b": 2} and outer["attrs"] == {"a": 1}
    assert port_metrics.timer_totals()["span.inner"] >= 0.0


def test_memledger_tracks_tensors_until_they_die():
    memledger.reset()
    try:
        a, b = torch.zeros(10), torch.zeros((2, 3), dtype=torch.float64)
        tree = {"x": a, "y": [b, np.zeros(4)]}
        memledger.track(tree, "model")
        memledger.track(tree, "model")  # counted once
        assert memledger.live_bytes("model") == 40 + 48
        assert memledger.tracked_nbytes(tree) == 88
        assert port_metrics.get_gauge("hbm.live.model") == 88
        del tree, a
        assert memledger.live_bytes("model") == 48
        del b
        assert memledger.live_bytes("model") == 0 and memledger.peak_bytes() == 88
        handle = memledger.register("serving", 100)
        assert memledger.snapshot()["categories"] == {"serving": 100}
        memledger.release(handle)
        memledger.release(handle)  # idempotent
        assert memledger.live_bytes() == 0
        with pytest.raises(ValueError, match="unknown ledger category"):
            memledger.register("nope", 1)
    finally:
        memledger.reset()


def test_a_tensor_dying_inside_a_ledger_section_does_not_deadlock():
    """A tracked tensor's finalizer may run while the ledger's lock is held
    (the garbage collector runs at any allocation, say inside `register`):
    its release is applied when the section ends, not deadlocked on."""
    memledger.reset()
    box = [torch.zeros(4)]
    memledger.track(box[0], "scratch")
    seen = []

    def section():
        with memledger._locked():
            box.clear()  # the finalizer runs here, inside the section
        seen.append(memledger.live_bytes("scratch"))

    worker = port_flow.spawn(section, name="t.ledger")
    worker.join(timeout=WAIT_S)
    try:
        assert not worker.is_alive(), "the ledger deadlocked on a finalizer"
        assert seen == [0]
    finally:
        memledger.reset()


def test_memledger_budget_admission_and_oom_wrapping():
    memledger.reset()
    try:
        keep = memledger.track(torch.zeros(25), "model")  # 100 bytes
        with port_config.hbm_budget_mode(150):
            memledger.admit(50, "serving")
            with pytest.raises(memledger.HbmBudgetExceeded) as ei:
                memledger.admit(51, "serving")
            with pytest.raises(memledger.HbmBudgetExceeded):
                with port_config.use_device("cpu"):
                    port_prefetch.stage_to_device((np.zeros(16, np.float64),), category="serving")
        e = ei.value
        assert (e.requested_bytes, e.budget_bytes, e.live_bytes, e.breakdown) == (51, 150, 100, {"model": 100})
        assert memledger.wrap_oom(ValueError("x")) is None
        wrapped = memledger.wrap_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried"))
        assert isinstance(wrapped, memledger.HbmExhausted)
        assert wrapped.snapshot["liveBytes"] == 100
        del keep
    finally:
        memledger.reset()


def test_staging_is_accounted_and_ledgered():
    memledger.reset()
    try:
        h2d = port_metrics.get_counter("h2d.bytes")
        with port_config.use_device("cpu"):
            staged = port_prefetch.stage_to_device(
                (np.arange(6, dtype=np.float64).reshape(3, 2), np.arange(3, dtype=np.int32)),
                dtype=torch.float32, category="serving").wait()
        assert port_metrics.get_counter("h2d.bytes") - h2d == 6 * 4 + 3 * 4
        assert memledger.live_bytes("serving") == 36
        assert staged[0].dtype == torch.float32 and staged[1].dtype == torch.int32
        del staged
        assert memledger.live_bytes("serving") == 0
    finally:
        memledger.reset()


# ---------------------------------------------------------------------------
# buckets and padding (parallel/prefetch.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,buckets", [(1, None), (8, None), (9, None), (700, None), (0, None),
                                       (5, [16, 64]), (65, [16, 64]), (64, [16, 64])])
def test_next_bucket_equals_jax(n, buckets):
    assert port_prefetch.next_bucket(n, buckets) == jax_prefetch.next_bucket(n, buckets)


@pytest.mark.parametrize("layout", ["dense", "vector", "sparse", "tensor"])
def test_pad_and_slice_rows_equal_jax(layout):
    from flink_ml_tpu.table import SparseBatch as JaxSparseBatch
    from flink_ml_tpu_torch import SparseBatch

    rng = np.random.default_rng(5)
    if layout == "sparse":
        idx, vals = rng.integers(0, 9, (5, 3)).astype(np.int32), rng.random((5, 3))
        got = port_prefetch.pad_rows(SparseBatch(9, idx, vals), 5, 8)
        want = jax_prefetch.pad_rows(JaxSparseBatch(9, idx, vals), 5, 8)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.values, want.values)
        cut = port_prefetch.slice_rows(got, 5)
        np.testing.assert_array_equal(cut.indices, idx)
        return
    col = rng.random((5, 4)) if layout != "vector" else rng.random(5)
    want = jax_prefetch.pad_rows(col, 5, 8)
    got = port_prefetch.pad_rows(torch.as_tensor(col) if layout == "tensor" else col, 5, 8)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(port_prefetch.slice_rows(got, 5)), col)


# ---------------------------------------------------------------------------
# the lossy ingest policies: the same items shed as in the JAX package
# ---------------------------------------------------------------------------

class _HeldSource:
    """Items whose second waits until the consumer took the first; `done`
    is set once the last was taken by the producer."""

    def __init__(self, items):
        self.items = list(items)
        self.first_taken = threading.Event()
        self.done = threading.Event()

    def __iter__(self):
        yield self.items[0]
        assert self.first_taken.wait(WAIT_S), "the consumer never took the first item"
        yield from self.items[1:]
        self.done.set()


def _prefetch_run(prefetch, metrics, policy):
    shed = metrics.get_counter("flow.shed", 0)
    source = _HeldSource(range(12))
    it = prefetch.Prefetcher(lambda i: i * 10, depth=3, policy=policy).iterate(source)
    got = [next(it)]
    source.first_taken.set()
    if policy != "block":  # a lossy window never stops the producer
        assert source.done.wait(WAIT_S)
    got += list(it)
    return got, metrics.get_counter("flow.shed", 0) - shed


@pytest.mark.parametrize("policy", ["block", "shed_oldest", "sample"])
def test_prefetcher_policies_shed_what_jax_sheds(policy):
    with port_config.use_device("cpu"):
        got = _prefetch_run(port_prefetch, port_metrics, policy)
    want = _prefetch_run(jax_prefetch, jax_metrics, policy)
    assert got == want
    expected = {"block": list(range(0, 120, 10)), "shed_oldest": [0, 90, 100, 110],
                "sample": [0, 10, 20, 30]}[policy]
    assert got[0] == expected
    assert got[1] == (0 if policy == "block" else 8)


def test_prefetcher_early_close_cancels_and_joins():
    staged = []
    with port_config.use_device("cpu"):
        prefetcher = port_prefetch.Prefetcher(lambda i: staged.append(i) or i, depth=2)
        it = prefetcher.iterate(range(1000))
        assert next(it) == 0
        it.close()
    assert prefetcher.channel.closed and len(staged) <= 6


D = 6
ROWS = 16


def _online_tables(table_cls, kind):
    rng = np.random.default_rng(11)
    tables = []
    for _ in range(10):
        X = rng.standard_normal((ROWS, D))
        cols = {"features": X}
        if kind == "lr":
            cols["label"] = (X @ np.arange(1.0, D + 1.0) > 0).astype(np.float64)
        tables.append(table_cls(cols))
    return tables


def _online_run(kind, table_cls, stream_cls, vector_cls, module, metrics, policy, overload_mode):
    shed = metrics.get_counter("flow.shed", 0)
    source = _HeldSource(_online_tables(table_cls, kind))
    if kind == "lr":
        est = (module.OnlineLogisticRegression().set_global_batch_size(ROWS).set_reg(0.1)
               .set_elastic_net(0.5)
               .set_initial_model_data(table_cls({"coefficient": [vector_cls(np.zeros(D))]})))
    else:
        est = (module.OnlineKMeans().set_global_batch_size(ROWS).set_k(2).set_decay_factor(0.5)
               .set_initial_model_data(module.generate_random_model_data(2, D, 1.0, seed=7)))
    with overload_mode(policy):
        model = est.fit(stream_cls(source))
        versions = [(model.process_updates(1), _arrays(model))]
        source.first_taken.set()
        if policy != "block":  # a lossy window never stops the producer
            assert source.done.wait(WAIT_S)
        while True:
            before = model.model_version
            if model.process_updates(1) == before:
                break
            versions.append((model.model_version, _arrays(model)))
    return versions, metrics.get_counter("flow.shed", 0) - shed


def _arrays(model):
    if hasattr(model, "centroids"):
        return np.array(model.centroids)
    return np.array(model.coefficient)


@pytest.mark.parametrize("kind", ["lr", "kmeans"])
@pytest.mark.parametrize("policy", ["shed_oldest", "sample"])
def test_online_ingest_sheds_what_jax_sheds(kind, policy):
    """The online estimators' ingest under `config.online_overload_policy`:
    the same global batches folded as in the JAX package, the same
    `flow.shed`, each version's model at the FTRL / KMeans tolerances."""
    modules = {"lr": (port_olr, jax_olr), "kmeans": (port_okm, jax_okm)}[kind]
    with port_config.use_device("cpu"):
        got, got_shed = _online_run(kind, Table, StreamTable, DenseVector, modules[0], port_metrics,
                                    policy, port_config.online_overload_mode)
    with mesh_lib.use_mesh(mesh_lib.create_mesh(devices=jax.devices()[:1])):
        want, want_shed = _online_run(kind, JaxTable, JaxStreamTable, JaxDenseVector, modules[1],
                                      jax_metrics, policy, jax_config.online_overload_mode)
    assert got_shed == want_shed > 0
    assert [v for v, _ in got] == [v for v, _ in want] == [1, 2, 3]
    tol = FTRL_TOL if kind == "lr" else dict(rtol=1e-5, atol=1e-5)
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)
    # which batches were folded: "sample" keeps the ones right after the
    # held first batch (as a lossless ingest folds them), "shed_oldest"
    # the newest
    with port_config.use_device("cpu"):
        lossless, shed = _online_run(kind, Table, StreamTable, DenseVector, modules[0],
                                     port_metrics, "block", port_config.online_overload_mode)
    assert shed == 0 and len(lossless) == 10
    same_as_lossless = np.allclose(got[1][1], lossless[1][1], **tol)
    assert same_as_lossless == (policy == "sample")
