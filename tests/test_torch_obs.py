"""The port's observability (flink_ml_tpu_torch/obs/) against the JAX
package's, on the same inputs.

- timeline: the same seeded event sequences through both packages'
  `to_chrome` and `dispatch_attribution` give the same documents (the
  process name aside); `dump_jsonl`/`load_events` round trip within and
  across the packages; `export_chrome_file` writes `to_chrome`;
- memory ledger: the same register/release/watermark sequences give the
  same `peak_since`, `fit_peak_scope` and `record_fleet_fit_peak` gauges,
  `ranked_entries` and a `dump_snapshot`/`load_dump` round trip;
- exporters: the same snapshots give the same JSON and Prometheus text,
  the same collisions and the same benchmark-entry gauges;
- tracing: the JSONL file sink's schema, `event`, `current_span`,
  `add_attr`, `emit_completed`, `set_dispatch_depth`, the no-op path, one
  span per instrumented call; a small LogisticRegression fit and transform
  under the ring give the JAX package's spans, attributes and parent
  chains (the capture spans' count aside: XLA compiles other programs);
- the device epoch cache keeps the ledger's `batchCache` equal to its own
  bytes through hits, misses, replacements and evictions.
"""

import json

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification.logisticregression import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.obs import exporters as jax_exporters
from flink_ml_tpu.obs import hist as jax_hist
from flink_ml_tpu.obs import memledger as jax_memledger
from flink_ml_tpu.obs import timeline as jax_timeline
from flink_ml_tpu.obs import tracing as jax_tracing
from flink_ml_tpu.utils import metrics as jax_metrics
from flink_ml_tpu_torch import Table, config
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.obs import exporters, hist, memledger, timeline, tracing
from flink_ml_tpu_torch.utils import metrics

LANES = ["host:MainThread", "dispatch", "device", "readback", "h2d", "flow", "memory"]


def _events(seed, n=60):
    """A seeded timeline: begin/end pairs (some broken, as by a ring's
    wrap), complete, instant and counter events, with dispatch chunks
    that carry epoch ranges."""
    rng = np.random.default_rng(seed)
    out, t, ref = [], 0.0, 0
    for _ in range(n):
        t += float(rng.integers(1, 50))
        lane = LANES[int(rng.integers(len(LANES)))]
        kind = rng.integers(5)
        if kind == 0:
            ref += 1
            out.append({"ph": "B", "lane": lane, "name": f"span{ref}", "tsUs": t, "durUs": 0.0,
                        "ref": ref})
            if rng.random() < 0.8:
                out.append({"ph": "E", "lane": lane, "name": f"span{ref}",
                            "tsUs": t + float(rng.integers(1, 30)), "durUs": 0.0, "ref": ref,
                            "args": {"k": int(rng.integers(9))}})
        elif kind == 1:
            start = int(rng.integers(0, 20))
            out.append({"ph": "X", "lane": "dispatch", "name": "dispatch.chunk", "tsUs": t,
                        "durUs": float(rng.integers(1, 20)),
                        "args": {"start": start, "end": start + int(rng.integers(1, 4))}})
        elif kind == 2:
            out.append({"ph": "X", "lane": lane, "name": "readback" if lane == "readback"
                        else "device.chunk(est)", "tsUs": t, "durUs": float(rng.integers(1, 40))})
        elif kind == 3:
            out.append({"ph": "i", "lane": lane, "name": "mark", "tsUs": t, "durUs": 0.0})
        else:
            out.append({"ph": "C", "lane": "memory", "name": "hbm", "tsUs": t, "durUs": 0.0,
                        "args": {"model": int(rng.integers(1000))}})
    if rng.random() < 0.5:  # an end whose begin fell off the ring
        out.insert(0, {"ph": "E", "lane": "host:MainThread", "name": "lost", "tsUs": 0.5,
                       "durUs": 0.0, "ref": 999})
    return out


def _same_process(doc):
    for ev in doc["traceEvents"]:
        if ev.get("name") == "process_name":
            ev["args"]["name"] = "?"
    return doc


@pytest.mark.parametrize("seed", range(6))
def test_to_chrome_and_attribution_match_jax(seed):
    events = _events(seed)
    got = _same_process(timeline.to_chrome(json.loads(json.dumps(events))))
    want = _same_process(jax_timeline.to_chrome(json.loads(json.dumps(events))))
    assert got == want
    assert timeline.dispatch_attribution(list(events)) == jax_timeline.dispatch_attribution(
        list(events))
    attribution = timeline.dispatch_attribution(list(events))
    if attribution:
        parts = sum(attribution[k] for k in ("dispatchMs", "deviceMs", "readbackMs",
                                             "idleGapMs"))
        assert parts == pytest.approx(attribution["wallMs"], rel=1e-9)
        assert attribution["wallMs"] == pytest.approx(attribution["windowMs"], rel=1e-9)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jsonl_dump_and_load_round_trip(tmp_path, writer):
    events = _events(42)
    path = str(tmp_path / "timeline.jsonl")
    (timeline if writer == "port" else jax_timeline).dump_jsonl(path, events)
    with open(path, "a") as f:
        f.write('{"ph": "B", "lane"')  # a killed process's torn last line
    assert timeline.load_events(path) == jax_timeline.load_events(path) == events
    doc = timeline.export_chrome_file(str(tmp_path / "trace.json"), timeline.load_events(path))
    assert json.load(open(tmp_path / "trace.json")) == doc == timeline.to_chrome(events)


def test_the_live_ring_exports():
    timeline.configure(ring_size=256)
    try:
        with tracing.span("outer", k=1):
            timeline.record_complete(timeline.LANE_DISPATCH, "dispatch.chunk", 0, 10, start=0,
                                     end=1)
            with tracing.span("inner"):
                timeline.record_instant(timeline.LANE_FLOW, "shed")
        doc = timeline.to_chrome()
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"outer", "inner", "shed", "dispatch.chunk", "thread_name"} <= names
        assert doc["otherData"] == {"unmatchedDropped": 0, "truncated": 0}
    finally:
        timeline.configure(None)


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------

def _ledger_run(mod, registry, seed):
    """A seeded register/release/watermark sequence; returns what it read."""
    rng = np.random.default_rng(seed)
    mod.reset()
    handles, reads = [], []
    tok = mod.mark_peak()
    for step in range(40):
        if handles and rng.random() < 0.4:
            mod.release(handles.pop(int(rng.integers(len(handles)))))
        else:
            cat = mod.CATEGORIES[int(rng.integers(len(mod.CATEGORIES)))]
            handles.append(mod.register(cat, int(rng.integers(1, 10_000)), shape=(step,),
                                        dtype="float32", site=f"s{step}"))
        if step % 10 == 9:
            reads.append(mod.peak_since(tok, close=False))
    with mod.fit_peak_scope():
        mod.release(mod.register("optimizer", 123_456))
    reads.append(registry.get_gauge("hbm.peak.fit"))
    with mod.fit_peak_scope(member=3):
        mod.register("fleet", 7)
    reads.append(registry.get_gauge("hbm.peak.fit.member.3"))
    mod.record_fleet_fit_peak(99, 70)
    reads.append([registry.get_gauge(f"hbm.peak.fit.member.{i}") for i in (0, 63)])
    reads.append(registry.get_gauge("hbm.peak.fit.member.64", None))
    reads.append(mod.peak_since(tok))
    reads.append(mod.ranked_entries(5))
    snap = mod.snapshot(5)
    reads.append({k: snap[k] for k in ("liveBytes", "peakBytes", "entryCount", "categories")})
    return reads


@pytest.mark.parametrize("seed", range(4))
def test_ledger_peaks_match_jax(seed, tmp_path):
    want = _ledger_run(jax_memledger, jax_metrics, seed)
    got = _ledger_run(memledger, metrics, seed)
    assert got == want
    path = str(tmp_path / "dump.json")
    snap = memledger.dump_snapshot(path)
    assert memledger.load_dump(path) == json.loads(json.dumps(snap))
    assert jax_memledger.load_dump(path) == memledger.load_dump(path)
    memledger.reset()
    jax_memledger.reset()


def test_every_stage_fit_is_a_peak_scope():
    rng = np.random.default_rng(1)
    table = Table({"features": rng.standard_normal((64, 3)),
                   "label": (rng.random(64) > 0.5).astype(np.float64)})
    metrics.set_gauge("hbm.peak.fit", -1)
    with config.use_device("cpu"):
        LogisticRegression().set_max_iter(2).set_global_batch_size(32).fit(table)
    assert metrics.get_gauge("hbm.peak.fit") >= 0


def test_device_epoch_cache_keeps_ledger_parity():
    from flink_ml_tpu_torch.data.devicecache import DeviceEpochCache
    from flink_ml_tpu_torch.parallel.prefetch import Staged

    memledger.reset()
    cache = DeviceEpochCache(budget_bytes=1000)
    counts = {k: metrics.get_counter(k) for k in ("devicecache.hit", "devicecache.miss",
                                                  "devicecache.evict")}

    def staged(nbytes):
        buf = torch.zeros(nbytes // 4)
        return Staged(buf, None, buf)

    rng = np.random.default_rng(3)
    for _ in range(50):
        key = int(rng.integers(6))
        if cache.get(key) is None:
            cache.put(key, staged(int(rng.integers(1, 100)) * 4))
        cache.check_ledger_parity()
        assert metrics.get_gauge("devicecache.bytes") == cache.stats["residentBytes"]
    cache.put(0, staged(600))
    cache.put(1, staged(600))  # evicts 0
    cache.check_ledger_parity()
    assert metrics.get_counter("devicecache.evict") > counts["devicecache.evict"]
    assert metrics.get_counter("devicecache.hit") - counts["devicecache.hit"] == cache.hits
    cache.clear()
    cache.check_ledger_parity()
    assert memledger.live_bytes("batchCache") == 0


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _registry_snapshot(seed):
    rng = np.random.default_rng(seed)
    names = ["jit.traces", "fleet.fits", "bank.hits", "serving.records", "hbm.peak.fit",
             "readback", "iteration.host_sync.fit"]
    snap = {"counters": {}, "gauges": {}, "timers": {}}
    for name in names:
        kind = ("counters", "gauges", "timers")[int(rng.integers(3))]
        if kind == "timers":
            snap[kind][name] = {"totalMs": float(rng.random() * 100), "count": int(
                rng.integers(1, 9)), "meanMs": 1.0}
        else:
            snap[kind][name] = int(rng.integers(100))
    return snap


def _hists(seed):
    rng = np.random.default_rng(seed)
    name = f"test.exporters{seed}.latencyMs"
    for v in rng.random(50) * 1000:
        hist.record(name, float(v))
        jax_hist.record(name, float(v))
    return {name: hist.snapshot()[name]}, {name: jax_hist.snapshot()[name]}


@pytest.mark.parametrize("seed", range(4))
def test_exporters_match_jax(seed):
    snap = _registry_snapshot(seed)
    port_h, jax_h = _hists(seed)
    assert port_h == jax_h
    assert exporters.snapshot_json(snap) == jax_exporters.snapshot_json(snap)
    assert exporters.snapshot_prometheus(snap, hists=port_h) == \
        jax_exporters.snapshot_prometheus(snap, hists=jax_h)
    entry = {"name": "fit", "totalTimeMs": 3.5, "hostSyncCount": 1, "recompileCount": 0,
             "peakHbmBytes": 123, "notAField": 1, "retryCount": True}
    assert exporters.bench_entry_prometheus(entry) == jax_exporters.bench_entry_prometheus(entry)


def test_name_collisions_match_jax():
    snap = {"counters": {"a.b": 1, "a_b": 2}, "gauges": {"x_count": 1},
            "timers": {"x": {"totalMs": 1.0, "count": 1}}}
    got = exporters.check_name_collisions(snap, {})
    assert got == jax_exporters.check_name_collisions(snap, {}) and len(got) == 2
    with pytest.raises(ValueError, match="collision"):
        exporters.snapshot_prometheus(snap, hists={})
    assert exporters.check_name_collisions(metrics.snapshot(), hist.snapshot(False)) == []


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_jsonl_sink_and_the_span_api(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    assert tracing.span("x") is tracing.span("y")  # the shared no-op
    tracing.configure(trace_file=path)
    try:
        assert tracing.enabled()
        with tracing.span("outer", a=1) as outer:
            assert tracing.current_span() is outer
            tracing.add_attr("b", 2)
            tracing.event("mark", c=3)
            tracing.emit_completed("done", 0, 0.001, category="readback")
            with pytest.raises(KeyError):
                with tracing.span("failing"):
                    raise KeyError("x")
        tracing.set_dispatch_depth(3)
    finally:
        tracing.configure()
    assert tracing.current_span() is None and not tracing.enabled()
    assert metrics.get_gauge("iteration.dispatch_depth") == 3
    records = [json.loads(line) for line in open(path)]
    assert all(set(r) == {"name", "spanId", "parentId", "startUs", "durUs", "attrs"}
               for r in records)
    by_name = {r["name"]: r for r in records}
    outer = by_name["outer"]
    assert outer["attrs"] == {"a": 1, "b": 2} and outer["parentId"] == 0
    for name in ("mark", "done", "failing"):
        assert by_name[name]["parentId"] == outer["spanId"]
    assert by_name["failing"]["attrs"] == {"error": "KeyError"}
    assert by_name["done"]["durUs"] == pytest.approx(1000.0)


def test_capture_accounting():
    compiles = metrics.get_counter("jit.compiles")
    tracing.configure(ring_size=16)
    try:
        tracing.account_compile(0.25, kernel="k")
        (record,) = tracing.drain_ring()
    finally:
        tracing.configure()
    assert metrics.get_counter("jit.compiles") - compiles == 1
    assert record["name"] == "jit.compile" and record["attrs"] == {"category": "compile",
                                                                  "kernel": "k"}
    assert hist.percentiles("jit.compileMs") is not None


def _chains(records, skip=()):
    """(name, attrs, parent chain) of each record, the capture spans apart;
    `skip` names spans left out, their children given to their parents."""
    by_id = {r["spanId"]: r for r in records}
    for r in records:
        while by_id.get(r["parentId"], {}).get("name") in skip:
            r["parentId"] = by_id[r["parentId"]]["parentId"]
    records = [r for r in records if r["name"] not in skip]

    def chain(r):
        out, p = [], by_id.get(r["parentId"])
        while p is not None:
            out.append(p["name"])
            p = by_id.get(p["parentId"])
        return tuple(out)

    plain = [(r["name"], json.dumps(r["attrs"], sort_keys=True), chain(r)) for r in records
             if r["name"] != "jit.compile"]
    compiles = {chain(r) for r in records if r["name"] == "jit.compile"}
    return plain, compiles


def test_fit_and_transform_spans_match_jax():
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((72, 4))  # a shape no other test fits
    label = (feats[:, 0] > 0).astype(np.float64)
    runs = {}
    for pkg, tr, T, LR in (("jax", jax_tracing, JaxTable, JaxLogisticRegression),
                           ("port", tracing, Table, LogisticRegression)):
        tr.configure(ring_size=4096)
        try:
            with config.use_device("cpu"):
                model = LR().set_max_iter(3).set_global_batch_size(24).fit(
                    T({"features": feats, "label": label}))
                model.transform(T({"features": feats}))
            ring = tr.drain_ring()
        finally:
            tr.configure()
        # the port's whole fit runs in the `iteration.run` span (mode
        # whole_fit) of the JAX package's batched whole fit; its flat path
        # has none (ROADMAP C.23)
        runs[pkg] = _chains(ring, skip=("iteration.run",) if pkg == "port" else ())
        if pkg == "port":
            assert [r["attrs"] for r in ring if r["name"] == "iteration.run"] == [
                {"mode": "whole_fit", "epochs": 3}]
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] and runs["port"][1] <= runs["jax"][1]


def test_one_span_per_instrumented_call():
    from flink_ml_tpu_torch.api import Transformer

    class Base(Transformer):
        def transform(self, *inputs):
            return list(inputs)

    class Child(Base):
        pass

    assert Child.transform is Base.transform and Base.transform._obs_instrumented
    tracing.configure(ring_size=16)
    try:
        Child().transform(Table({"a": np.zeros(2)}))
        records = tracing.drain_ring()
    finally:
        tracing.configure()
    assert [(r["name"], r["attrs"]) for r in records] == [("stage.transform",
                                                            {"stage": "Child"})]
