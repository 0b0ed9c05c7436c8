"""Benchmark runner and CLI: JSON-config-driven stage benchmarking.

Port of flink_ml_tpu/benchmark/runner.py, a redesign of flink-ml-benchmark
(Benchmark.java:45-60, BenchmarkUtils.java:74-144, BenchmarkResult.java).
The config format is the reference's: a JSON object of named entries, each
with a `stage` {className, paramMap}, an `inputData` generator spec and an
optional `modelData` one. Java class names resolve to the port's classes,
so the reference's shipped configs (`conf/*.json`) run unchanged.
Results use the reference's schema (totalTimeMs, inputRecordNum,
inputThroughput, outputRecordNum, outputThroughput) plus the JAX
runner's extensions under the same names (`RESULT_KEYS`): phaseTimesMs,
the per-phase wall-clock breakdown (datagen, fit, transform, collect),
the first-class counters of `obs/exporters.BENCH_FIELDS`, the collective
breakdown, the dispatch attribution and the embedded metrics delta.

CLI (on the card; without one it raises, as every entry point does):

    python -m flink_ml_tpu_torch.benchmark <config.json>
        [--output-file r.json] [--profile-dir traces/]

`--profile-dir` records a torch.profiler trace of the run
(`utils.metrics.profile_trace`). In a test, call `run_benchmark` or
`main` in-process under `config.use_device("cpu")`.
"""

from __future__ import annotations

import importlib
import json
import re
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from ..api import AlgoOperator, Estimator, Model
from ..obs import memledger, timeline, tracing
from ..table import DictTokenMatrix, SparseBatch, Table
from ..utils import metrics, read_write

_BENCH_JAVA_PREFIX = "org.apache.flink.ml.benchmark.datagenerator."
_BENCH_PY_MODULE = "flink_ml_tpu_torch.benchmark.datagenerator"
_JAX_PACKAGE = "flink_ml_tpu."

#: every key of a result, the JAX runner's set
RESULT_KEYS = frozenset({
    "name", "totalTimeMs", "inputRecordNum", "inputThroughput",
    "outputRecordNum", "outputThroughput", "phaseTimesMs", "metrics",
    "hostSyncCount", "dispatchDepth", "fusedSegments", "collectiveBreakdown",
    "wholeFitCount", "wholeFitFallbacks", "fleetSize", "modelsPerSecond",
    "offeredQps", "goodputQps", "saturationQps", "pageInCount",
    "hostDispatchMs", "dispatchGapMs", "gapCount", "dispatchAttribution",
    "h2dBytes", "h2dCount", "deviceCacheHits", "deviceCacheMisses",
    "checkpointCount", "checkpointBytes",
    "retryCount", "shedCount", "rejectCount", "peakQueueDepth",
    "peakHbmBytes", "residentModelBytes",
    "swapCount", "rollbackCount", "promoteRejected",
})


def _resolve_generator(class_name: str):
    """A generator class by its config name: the reference's Java names
    and the JAX package's module name resolve to this package's
    `benchmark.datagenerator`, never to the JAX package."""
    if class_name.startswith(_BENCH_JAVA_PREFIX):
        simple = class_name.rsplit(".", 1)[1]
        return getattr(importlib.import_module(_BENCH_PY_MODULE), simple)
    if class_name.startswith(_JAX_PACKAGE):
        class_name = "flink_ml_tpu_torch." + class_name[len(_JAX_PACKAGE):]
    module_name, _, cls_name = class_name.rpartition(".")
    return getattr(importlib.import_module(module_name), cls_name)


def instantiate_generator(spec: Dict):
    cls = _resolve_generator(spec["className"])
    gen = cls()
    for name, json_value in spec.get("paramMap", {}).items():
        param = gen.get_param(name)
        if param is not None:
            gen.set(param, param.json_decode(json_value))
    return gen


def load_config(path: str) -> Dict:
    """Reads a benchmark config; drops the reference's // license header
    comment lines."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^\s*//.*$", "", text, flags=re.M)
    return json.loads(text)


def run_benchmark(name: str, entry: Dict) -> Dict:
    """BenchmarkUtils.runBenchmark: generate the input, fit and transform
    the stage, time it end to end and report throughput, with the
    per-phase wall-clock breakdown (datagen, fit, transform, collect).

    The result also embeds `metrics`, the registry delta this entry made
    (the phase timers, readback bytes and count, captures, collective and
    data-cache counters), so a written result file carries its own
    evidence."""
    metrics_before = metrics.snapshot()
    timeline_start_us = timeline.now_us()
    hbm_mark = memledger.mark_peak()
    phases: Dict[str, float] = {}

    @contextmanager
    def timed_phase(phase: str):
        start = time.perf_counter()
        with tracing.span("benchmark.phase", benchmark=name, phase=phase):
            try:
                yield
            finally:
                elapsed = time.perf_counter() - start
                phases[phase] = phases.get(phase, 0.0) + elapsed
                metrics.record_time(f"benchmark.{name}.{phase}", elapsed)

    with timed_phase("datagen"):
        stage = read_write.instantiate_with_params(entry["stage"])
        from . import datagenerator as dg

        # a stage whose compute is host work (Stage.prefers_host_input)
        # gets host-born inputs
        dg.set_prefer_host(bool(getattr(stage, "prefers_host_input", False)))
        try:
            input_tables = instantiate_generator(entry["inputData"]).get_data()
        finally:
            dg.set_prefer_host(False)
        _adapt_input_columns(stage, input_tables)
        model_tables: Optional[List[Table]] = None
        if "modelData" in entry:
            model_tables = instantiate_generator(entry["modelData"]).get_data()
            _block_until_ready(model_tables)
        _block_until_ready(input_tables)

    num_input = sum(t.num_rows for t in input_tables)
    start = time.perf_counter()
    # each phase waits for its own device work, so that a phase's compute
    # does not leak into the next one's time
    if isinstance(stage, Estimator):
        with timed_phase("fit"):
            model = stage.fit(*input_tables)
        with timed_phase("transform"):
            outputs = model.transform(*input_tables)
            _block_until_ready(outputs)
    elif isinstance(stage, Model) and model_tables is not None:
        with timed_phase("fit"):
            stage.set_model_data(*model_tables)
        with timed_phase("transform"):
            outputs = stage.transform(*input_tables)
            _block_until_ready(outputs)
    elif isinstance(stage, AlgoOperator):
        with timed_phase("transform"):
            outputs = stage.transform(*input_tables)
            _block_until_ready(outputs)
    else:
        raise TypeError(f"Unsupported stage type {type(stage).__name__}")
    with timed_phase("collect"):
        num_output = sum(t.num_rows for t in outputs)
    elapsed_ms = (time.perf_counter() - start) * 1000.0

    delta = metrics.snapshot_delta(metrics_before, metrics.snapshot())
    # the work phases' wall split into host dispatch (the `iteration.dispatch`
    # timer: every launch of a fit's program or chunk, parallel/dispatch.py
    # `timed_dispatch`) and the gap the host was not dispatching (device
    # execution, readback, idle); gapCount counts the launches
    work_ms = (phases.get("fit", 0.0) + phases.get("transform", 0.0)) * 1000.0
    disp_timer = delta["timers"].get("iteration.dispatch", {})
    host_dispatch_ms = float(disp_timer.get("totalMs", 0.0))
    gap_count = int(disp_timer.get("count", 0))
    counters, gauges = delta["counters"], delta["gauges"]
    trained = counters.get("fleet.modelsTrained", 0)
    return {
        "name": name,
        "totalTimeMs": elapsed_ms,
        "inputRecordNum": num_input,
        "inputThroughput": num_input * 1000.0 / elapsed_ms if elapsed_ms else 0.0,
        "outputRecordNum": num_output,
        "outputThroughput": num_output * 1000.0 / elapsed_ms if elapsed_ms else 0.0,
        "phaseTimesMs": {k: v * 1000.0 for k, v in phases.items()},
        # blocking host syncs this entry paid, and the in-flight depth of
        # its pipelined loops
        "hostSyncCount": int(counters.get("iteration.host_sync", 0)),
        "dispatchDepth": int(gauges.get("iteration.dispatch_depth", 0)),
        # fits run as one program, and fits that fell back to chunks
        "wholeFitCount": int(counters.get("dispatch.whole_fit", 0)),
        "wholeFitFallbacks": int(counters.get("dispatch.whole_fit_fallback", 0)),
        # fleet fits: members trained and the rate over the work phases
        "fleetSize": int(gauges.get("fleet.size", 0)) if trained else 0,
        "modelsPerSecond": trained / (work_ms / 1000.0) if work_ms and trained else 0.0,
        "hostDispatchMs": host_dispatch_ms,
        "dispatchGapMs": max(0.0, work_ms - host_dispatch_ms) if gap_count else 0.0,
        "gapCount": gap_count,
        # segments the transform fused (0: the eager per-stage path)
        "fusedSegments": int(gauges.get("pipeline.fused_segments", 0)),
        # uploads through the accounted stager, the device epoch cache
        "h2dBytes": int(counters.get("h2d.bytes", 0)),
        "h2dCount": int(counters.get("h2d.count", 0)),
        "deviceCacheHits": int(counters.get("devicecache.hit", 0)),
        "deviceCacheMisses": int(counters.get("devicecache.miss", 0)),
        # snapshots written and the bytes they gathered
        "checkpointCount": int(counters.get("checkpoint.count", 0)),
        "checkpointBytes": int(counters.get("checkpoint.bytes", 0)),
        # flow control: retries, shed and rejected items, the deepest queue
        "retryCount": int(counters.get("flow.retry", 0)),
        "shedCount": int(counters.get("flow.shed", 0)),
        "rejectCount": int(counters.get("flow.reject", 0)),
        "peakQueueDepth": int(gauges.get("flow.peakQueueDepth", 0)),
        # device memory: the ledger's peak over the entry (datagen
        # included) and the model constants resident at its end
        "peakHbmBytes": int(memledger.peak_since(hbm_mark)),
        "residentModelBytes": int(memledger.live_bytes("model")),
        # the model lifecycle: swaps, rollbacks, refused promotions
        "swapCount": int(counters.get("lifecycle.swap", 0)),
        "rollbackCount": int(counters.get("lifecycle.rollback", 0)),
        "promoteRejected": int(counters.get("lifecycle.promoteRejected", 0)),
        # serving: the load generator's rates (0 for an entry that serves
        # nothing) and the model store's page-ins
        "offeredQps": float(gauges.get("serving.offeredQps", 0.0)),
        "goodputQps": float(gauges.get("serving.goodputQps", 0.0)),
        "saturationQps": float(gauges.get("serving.saturationQps", 0.0)),
        "pageInCount": int(counters.get("modelstore.pageIn", 0)),
        # per-op collective traffic of the accounted wrappers
        "collectiveBreakdown": collective_breakdown(delta),
        # the timeline's dispatch attribution, when the recorder is on
        "dispatchAttribution": _entry_attribution(timeline_start_us),
        "metrics": delta,
    }


def _entry_attribution(start_us: float) -> Optional[Dict]:
    """This entry's dispatch-wall attribution from the timeline (events
    since `start_us`); None when the timeline is off or no launch was
    recorded. The per-chunk rows are dropped (their count is unbounded):
    the totals and per-epoch means stay."""
    if not timeline.enabled():
        return None
    events, _ = timeline.snapshot_events()
    attr = timeline.dispatch_attribution([e for e in events if e["tsUs"] >= start_us])
    if not attr:
        return None
    attr.pop("chunks", None)
    return attr


def collective_breakdown(delta: Dict) -> Dict[str, Dict]:
    """A metrics delta's `collective.<op>.{calls,bytes,chunks,dense_equiv_bytes}`
    counters as {op: {field: value}}, with `sparseRatio` from its gauge.
    Empty when the entry ran no accounted collective. A copy of the JAX
    runner's helper."""
    out: Dict[str, Dict] = {}
    for name, value in delta.get("counters", {}).items():
        parts = name.split(".")
        if len(parts) != 3 or parts[0] != "collective":
            continue
        op, field = parts[1], parts[2]
        if field in ("calls", "bytes", "chunks", "dense_equiv_bytes"):
            out.setdefault(op, {})[field] = int(value)
    ratio = delta.get("gauges", {}).get("collective.sparse_ratio")
    if out and ratio is not None:
        out["sparseRatio"] = ratio
    return out


def _adapt_input_columns(stage, input_tables: List[Table]) -> None:
    """Compensate for broken upstream configs: five reference configs
    (normalizer, maxabsscaler, vectorslicer, elementwiseproduct,
    polynoimalexpansion) generate one column named 'featuresCol' while the
    stage keeps its default input column, which fails on the reference
    too. When the stage's input column is missing and the generated table
    has exactly one column, point the stage at that column and say so on
    stderr. A copy of the JAX runner's helper."""
    if len(input_tables) != 1 or len(input_tables[0].column_names) != 1:
        return
    only_col = input_tables[0].column_names[0]
    for getter, setter in (
        ("get_input_col", "set_input_col"),
        ("get_features_col", "set_features_col"),
    ):
        if hasattr(stage, getter):
            current = getattr(stage, getter)()
            if current not in input_tables[0] and only_col != current:
                getattr(stage, setter)(only_col)
                print(
                    f"  [config-adapt] {type(stage).__name__}.{getter[4:]}: "
                    f"{current!r} -> {only_col!r} (column absent from generated table)",
                    file=sys.stderr,
                )
            return


def _block_until_ready(tables: List[Table]) -> None:
    """Wait until every column of `tables` on the card is computed, so a
    phase's time holds its work and not only its launches: one scalar
    probe of each tensor (those inside SparseBatch and DictTokenMatrix
    columns too), stacked and read back in one copy, which waits for the
    stream's earlier work. Nothing for CPU tensors and host columns."""
    probes = []
    for t in tables:
        for name in t.column_names:
            col = t.column(name)
            if isinstance(col, SparseBatch):
                arrs = (col.indices, col.values)
            elif isinstance(col, DictTokenMatrix):
                arrs = (col.ids,)
            else:
                arrs = (col,)
            for arr in arrs:
                if isinstance(arr, torch.Tensor) and arr.is_cuda and arr.numel():
                    probes.append(arr[(0,) * arr.ndim].reshape(1).to(torch.float32))
    if probes:
        t0 = time.perf_counter()
        # the phase's timing barrier, accounted below; tpulint's host-sync rule
        # does not reach here (its entries are fit/transform and serving)
        host = torch.cat(probes).cpu()
        tracing.account_readback(host.numel() * host.element_size(),
                                 time.perf_counter() - t0, len(probes))


def execute_benchmarks(config: Dict) -> Dict[str, Dict]:
    results = {}
    names = [k for k in config if k != "version"]
    print(f"Found {len(names)} benchmarks.")
    for name in names:
        print(f"Running benchmark {name}.")
        results[name] = run_benchmark(name, config[name])
        r = results[name]
        phase_str = "  ".join(f"{k}: {v:.1f}" for k, v in r["phaseTimesMs"].items())
        print(
            f"  totalTimeMs: {r['totalTimeMs']:.1f}  "
            f"inputThroughput: {r['inputThroughput']:.1f} rec/s  [{phase_str}]"
        )
    print("Benchmarks execution completed.")
    return results


def main(argv: List[str]) -> None:
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    from .. import config as port_config

    port_config.device()  # the card, or the caller's use_device: raises with neither
    config_path = argv[0]
    output_file = None
    if "--output-file" in argv:
        output_file = argv[argv.index("--output-file") + 1]
    profile_dir = None
    if "--profile-dir" in argv:
        profile_dir = argv[argv.index("--profile-dir") + 1]
    config = load_config(config_path)
    if profile_dir:
        with metrics.profile_trace(profile_dir):
            results = execute_benchmarks(config)
        print(f"Profiler trace written to {profile_dir}.")
    else:
        results = execute_benchmarks(config)
    if output_file:
        payload = {
            name: {"stage": config[name]["stage"], "results": r}
            for name, r in results.items()
        }
        with open(output_file, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"Benchmark results saved as json in {output_file}.")
    else:
        print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main(sys.argv[1:])
