"""The trace report (flink_ml_tpu_torch/obs/report.py) against the JAX
package's, on the same records.

Seeded span trees (pipeline stages, stage fits and transforms, epochs,
runs, categorized readback/compile/cache/collective spans, bank events,
timeline-style B/E/X/i records, malformed and truncated lines) go through
both packages' `load_trace`, `sanitize_records`, `Trace`,
`stage_records`, `epoch_records`, `run_summaries` and `render_report`:
the same records, breakdowns and report text, but for the compile-cost
section, whose title and unattributed row name the port's captures (its
rows are compared where both attribute the same kernels). The port's
`render_report` renders the ring of a traced LogisticRegression pipeline
fit and transform, and `render_device_profile` reads a torch.profiler
chrome trace through `traceprof.analyze_trace`.
"""

import json

import numpy as np
import pytest

from flink_ml_tpu.obs import report as jax_report
from flink_ml_tpu_torch import Pipeline, Table, config
from flink_ml_tpu_torch.models.classification.logisticregression import LogisticRegression
from flink_ml_tpu_torch.models.feature.standardscaler import StandardScaler
from flink_ml_tpu_torch.obs import report, tracing

CATS = ["readback", "compile", "cache", "collective", None]


def _records(seed, n_stages=3, epochs=4):
    rng = np.random.default_rng(seed)
    out, ids, t = [], iter(range(1, 10_000)), 0.0

    def rec(name, parent, start, dur, **attrs):
        r = {"name": name, "spanId": next(ids), "parentId": parent, "startUs": start,
             "durUs": dur, "attrs": attrs}
        out.append(r)
        return r

    for i in range(n_stages):
        stage = rec("pipeline.stage", 0, t, 10_000.0, index=i, stage=f"S{i}",
                    op="fit" if i % 2 == 0 else "transform")
        inner = rec("stage.fit", stage["spanId"], t + 10, 9_000.0, stage=f"S{i}")
        run = rec("iteration.run", inner["spanId"], t + 20, 8_000.0, mode="device",
                  epochs=epochs, finalCriteria=float(rng.random()))
        for e in range(epochs):
            ep = rec("iteration.epoch", run["spanId"], t + 30 + 1_000 * e, 900.0, epoch=e)
            for _ in range(int(rng.integers(1, 4))):
                cat = CATS[int(rng.integers(len(CATS)))]
                child = rec("work", ep["spanId"], t + 40 + 1_000 * e,
                            float(rng.integers(1, 200)),
                            **({"category": cat} if cat else {}))
                if cat == "cache" and rng.random() < 0.5:  # nested: paid by its parent
                    rec("readback", child["spanId"], t + 41 + 1_000 * e, 1.0,
                        category="readback", bytes=8)
        rec("collective.allreduce", inner["spanId"], t + 50, 0.0, category="collective",
            bytes=int(rng.integers(1, 999)))
        rec("bank.compile", inner["spanId"], t + 60, 300.0, kernel=f"k{i % 2}",
            category="compile")
        rec("bank.hit", inner["spanId"], t + 70, 0.0, kernel=f"k{i % 2}", category="cache")
        rec("bank.load", 0, t + 80, 0.0, kernel="k0", category="cache")
        t += 12_000.0
    rec("stage.transform", 0, t, 500.0, stage="Lone")
    return out


def _strip_compile(text):
    sections = text.split("\n\n")
    return [s for s in sections if not s.startswith("== Compile cost")]


@pytest.mark.parametrize("seed", range(5))
def test_report_matches_jax(seed):
    records = _records(seed)
    for mod in (report, jax_report):
        assert mod.sanitize_records(json.loads(json.dumps(records)))[1] == 0
    trace, jax_trace = report.Trace(records), jax_report.Trace(records)
    assert report.stage_records(trace) == jax_report.stage_records(jax_trace)
    assert report.epoch_records(trace) == jax_report.epoch_records(jax_trace)
    assert report.run_summaries(trace) == jax_report.run_summaries(jax_trace)
    for r in records:
        assert trace.breakdown(r) == jax_trace.breakdown(r)
    assert report.compile_cost(trace) == jax_report.compile_cost(jax_trace)
    got, want = report.render_report(records), jax_report.render_report(records)
    assert _strip_compile(got) == _strip_compile(want)
    assert "== Compile cost (captures and the program bank) ==" in got


@pytest.mark.parametrize("seed", range(3))
def test_load_and_sanitize_match_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    records = _records(seed, n_stages=2)
    timeline_style = [
        {"ph": "B", "lane": "host:MainThread", "name": "t.span", "tsUs": 5.0, "ref": 7},
        {"ph": "E", "lane": "host:MainThread", "name": "t.span", "tsUs": 9.0, "ref": 7,
         "args": {"a": 1}},
        {"ph": "E", "lane": "host:MainThread", "name": "orphan", "tsUs": 9.5, "ref": 8},
        {"ph": "X", "lane": "readback", "name": "readback", "tsUs": 1.0, "durUs": 2.0},
        {"ph": "i", "lane": "flow", "name": "shed", "tsUs": 3.0},
        {"ph": "B", "lane": "host:MainThread", "name": "open", "tsUs": 10.0, "ref": 9},
        ["not", "a", "record"],
        {"neither": "span nor event"},
    ]
    mixed = records + timeline_style
    rng.shuffle(mixed)
    path = tmp_path / "trace.jsonl"
    with open(path, "w") as f:
        for r in mixed:
            f.write(json.dumps(r) + "\n")
        f.write('{"name": "torn", "spanId"')
    loaded = report.load_trace(str(path))
    assert loaded == jax_report.load_trace(str(path))
    got = report.sanitize_records(json.loads(json.dumps(loaded)))
    want = jax_report.sanitize_records(json.loads(json.dumps(loaded)))
    assert got == want and got[1] >= 4


def test_compile_cost_attributes_captures():
    records = [
        {"name": "jit.compile", "spanId": 1, "parentId": 0, "startUs": 0.0, "durUs": 2000.0,
         "attrs": {"category": "compile", "kernel": "flink_ml_tpu_torch.ops.k"}},
        {"name": "jit.compile", "spanId": 2, "parentId": 0, "startUs": 5.0, "durUs": 500.0,
         "attrs": {"category": "compile"}},
        {"name": "bank.hit", "spanId": 3, "parentId": 0, "startUs": 9.0, "durUs": 0.0,
         "attrs": {"kernel": "flink_ml_tpu_torch.ops.k"}},
    ]
    rows = report.compile_cost(report.Trace(records))
    assert rows == [
        {"kernel": "flink_ml_tpu_torch.ops.k", "compiles": 1, "compileMs": 2.0, "bankHits": 1,
         "bankLoads": 0},
        {"kernel": "(unattributed compile)", "compiles": 1, "compileMs": 0.5, "bankHits": 0,
         "bankLoads": 0},
    ]


def test_report_renders_a_traced_pipeline():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((80, 3))
    table = Table({"features": feats, "label": (feats[:, 1] > 0).astype(np.float64)})
    tracing.configure(ring_size=1 << 12)
    try:
        with config.use_device("cpu"):
            model = Pipeline([
                StandardScaler().set_input_col("features").set_output_col("scaled"),
                LogisticRegression().set_features_col("scaled").set_max_iter(3)
                .set_global_batch_size(40),
            ]).fit(table)
            model.transform(table)
        records = tracing.drain_ring()
    finally:
        tracing.configure()
    clean, dropped = report.sanitize_records(records)
    assert dropped == 0
    trace = report.Trace(clean)
    stages = report.stage_records(trace)
    assert [(r["attrs"]["stage"], r["attrs"]["op"]) for r in stages][:2] == [
        ("StandardScaler", "fit"), ("LogisticRegression", "fit")]
    for r in clean:  # every parent resolves
        assert r["parentId"] == 0 or r["parentId"] in trace.by_id
    text = report.render_report(clean)
    assert "== Per-stage breakdown ==" in text and "TOTAL" in text


def test_render_device_profile_reads_a_chrome_trace(tmp_path):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 30.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70.0, "dur": 10.0},
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    text = report.render_device_profile(str(tmp_path))
    assert "deviceBusyMs: 0.1" in text and "deviceIdleShare: 0.500" in text
    assert "deviceEvents: 3" in text and "gemm" in text
