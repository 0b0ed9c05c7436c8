"""One run of one cell of the port's benchmark.

`python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
makes the cell's table on the card from the seed, warms the shapes its
traffic uses, runs the traffic's closed loop for `--seconds`, compares a
sample of the answers with the plain reference and prints one JSON line:
`correct`, `attempted`, `failed`, `metrics`, `device` (and with
`--trace 1` `breakdown`), and last `checks`, each number compared beside
its limit, which also close standard error.

With `--trace 0` the metrics are the cell's end-to-end metrics
(BENCHMARK.json `end_to_end`); with `--trace 1` its per-layer metrics,
read from the same untraced window (the program's counters and timers,
host time) and from a traced slice of the loop that follows it
(`TRACE_SECONDS` under torch.profiler: device busy and idle, kernel time).
Each metric is read by `metrics/<name>.py`; a reader that finds nothing
leaves its metric out.

A run fails, printing no result, when the card or the cell's chips are
missing, and when a module of JAX or of the JAX package is loaded by the
time the result would be printed (`forbidden_modules`).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from . import compare, load, program, trace as trace_mod
from .plugins import ROOT, data_file, plugin

BENCHMARK = ROOT.parent / "BENCHMARK.json"
#: top-level module names that no process of the benchmark may load
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "flink_ml_tpu"})
#: seconds of the loop traced after the window of a `--trace 1` run
TRACE_SECONDS = 1.0


class NoCard(RuntimeError):
    """The run's machine lacks the card or the chips the cell asks for."""


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, each
    module's name taken up to its first dot and compared whole:
    `flink_ml_tpu_torch` is not `flink_ml_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


def benchmark_spec(path: Path = BENCHMARK) -> Dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell of BENCHMARK.json with the files it names: its
    configuration, its traffic mix (`traffic/<mix>.json`) and its limits
    (`limits/<cell>.json`)."""

    def __init__(self, spec: Dict, name: str):
        entries = [w for w in spec["workloads"] if w["name"] == name]
        if not entries:
            raise LookupError(f"no workload named {name!r} in BENCHMARK.json")
        (entry,) = entries
        self.name, self.chips = name, int(entry["chips"])
        (config,) = [c for c in spec["configs"] if c["name"] == entry["config"]]
        with open(ROOT.parent / config["file"]) as f:
            self.config = json.load(f)
        self.mix = data_file("traffic", entry["traffic"])
        self.limits = data_file("limits", name)
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, name)]


@dataclass
class RunRecord:
    """What the metric readers read: the cell, its window, the program's
    counters over the window, the traced slice's reduction, the card."""

    cell: Cell
    setup_s: float
    window: load.Window
    counters: Dict
    trace: Optional[Dict]
    peaks: Optional[Dict]

    @property
    def request(self) -> str:
        return self.cell.mix["request"]

    def count(self, name: str, *args):
        """(bytes, operations) from `counts/<name>.py`."""
        return plugin("counts", name).count(*args)

    def floor_s(self, nbytes: float, flops: float) -> Optional[float]:
        """The least seconds the card's published peaks allow for the
        bytes and the float32 operations; None off a card of the table."""
        if self.peaks is None:
            return None
        return max(nbytes / self.peaks["hbm_bytes_per_s"], flops / self.peaks["fp32_flops_per_s"])


def process_start() -> float:
    """The process's start on the `time.perf_counter` clock, from
    /proc (10 ms resolution); now, where /proc cannot tell."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            started_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - started_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def card(chips: int):
    """The device of a run on the card; NoCard without CUDA or with fewer
    cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} are here")
    return torch.device("cuda", 0)


def _peaks(device_name: str) -> Optional[Dict]:
    """The published peaks of a card by its name (`peaks/*.json`)."""
    for path in sorted((ROOT / "peaks").glob("*.json")):
        with open(path) as f:
            table = json.load(f)
        if device_name in table:
            return table[device_name]
    return None


def prepare(cell: Cell, seed: int, device):
    """The cell's table made from the seed on `device` and its traffic
    warmed, inside the program's device scope: (the table's tensors, the
    workload, {"table_s", "warm_s"})."""
    import torch

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = synced()
    tensors = plugin("data", cell.config["data"]["kind"]).make(cell.config["data"], seed, device)
    t1 = synced()
    work = load.Workload(cell.mix, cell.config, tensors, seed, device)
    work.warm()
    return tensors, work, {"table_s": t1 - t0, "warm_s": synced() - t1}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float) -> Dict:
    """One run of `cell` on `device`; the result's fields, checks last."""
    import torch

    on_card = device.type == "cuda"
    entered = time.perf_counter()
    with program.device_scope(device):
        tensors, work, parts = prepare(cell, seed, device)
        setup_s = time.perf_counter() - started
        print(f"portbench: setup {setup_s:.3f} s: {entered - started:.3f} s the interpreter, "
              f"torch and CUDA's start, {parts['table_s']:.3f} s the table, "
              f"{parts['warm_s']:.3f} s the warm-up", file=sys.stderr)
        before = program.counters_snapshot()
        window = work.run(seconds)
        counters = program.counters_delta(before, program.counters_snapshot())
        traced = None
        attempted, failed = window.attempted, window.failed
        if trace and on_card:
            part, traced = trace_mod.traced(
                lambda annotate: work.run(min(seconds, TRACE_SECONDS), start=work.sent,
                                          annotate=annotate))
            attempted, failed = attempted + part.attempted, failed + part.failed
        peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
        answers = work.answers()
        del work
        reference = compare.Reference(cell.config, tensors)
        numbers = compare.measure(cell.limits, answers, reference)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    record = RunRecord(cell, setup_s, window, counters, traced, _peaks(name) if on_card else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = plugin("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": failed == 0 and window.completed > 0 and compare.within(numbers, cell.limits),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": name, "count": cell.chips,
                   "memory_peak_bytes": peak},
    }
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {
            "device_ops": trace_mod.top({k: v[0] for k, v in traced["kernels"].items()}),
            "idle_gaps": trace_mod.top(traced["idle_by_host"]),
        }
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    return result


def report(result: Dict, err=sys.stderr, out=sys.stdout) -> None:
    """The result: a summary and the checks as the last lines of standard
    error, the JSON line as the last line of standard output."""
    print(f"portbench: correct={result['correct']} attempted={result['attempted']} "
          f"failed={result['failed']}", file=err)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(args, started: float) -> int:
    cell = Cell(benchmark_spec(), args.workload)
    try:
        device = card(cell.chips)
    except NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), device, started)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}: no process of the benchmark may "
              "import JAX or the JAX package", file=sys.stderr)
        return 3
    report(result)
    return 0
