"""Trace reduction: JSONL spans -> per-stage / per-epoch breakdown tables.

Port of flink_ml_tpu/obs/report.py. Consumes the JSONL a run writes under
`FLINK_ML_TPU_TRACE_FILE` (or the ring's records) and answers where the
wall time of each pipeline stage and training epoch went, split into

- `collective` — collective funnels (none on one card),
- `readback`   — device-to-host transfers (the packed readbacks),
- `compile`    — program captures (utils/lazyjit.py, fused segments),
- `cache`      — the data caches and the program bank's loads,
- `compute`    — the residual: device execution + host compute dispatched
  under the span (synchronous host-driven steps make this the dominant
  real-work bucket).

Category times are summed over each container's *outermost* categorized
descendants, so nested categorized spans never double-count and the five
buckets sum to the container's wall time exactly.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

CATEGORIES = ("collective", "readback", "compile", "cache")
_STAGE_NAMES = ("pipeline.stage", "stage.fit", "stage.transform")


def load_trace(path: str) -> List[Dict]:
    """Parse a JSONL trace file; tolerates trailing partial lines."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def sanitize_records(records: Iterable[Dict]) -> "Tuple[List[Dict], int]":
    """Normalize a possibly ring-truncated / mid-span-truncated record
    stream into well-formed span records: timeline-style begin/end events
    (`ph` B/E) are paired into spans, complete/instant timeline events
    become spans, and records missing the span schema are dropped.
    Returns (clean records, dropped count) — dropped counts unmatched
    begins/ends (their partner fell off the ring or the file was cut
    mid-span) plus unrecognizable records. Never raises."""
    clean: List[Dict] = []
    dropped = 0
    open_begins: Dict[object, Dict] = {}
    synth_id = -1  # synthesized span ids stay clear of real ones
    for r in records:
        if not isinstance(r, dict):
            dropped += 1
            continue
        ph = r.get("ph")
        if ph == "B":
            open_begins[(r.get("lane"), r.get("ref"), r.get("name"))] = r
            continue
        if ph == "E":
            begin = open_begins.pop((r.get("lane"), r.get("ref"), r.get("name")), None)
            if begin is None:
                dropped += 1  # begin fell off the ring
                continue
            clean.append(
                {
                    "name": r.get("name", "?"),
                    "spanId": r.get("ref") if r.get("ref") is not None else synth_id,
                    "parentId": 0,
                    "startUs": float(begin.get("tsUs", 0.0)),
                    "durUs": max(
                        0.0, float(r.get("tsUs", 0.0)) - float(begin.get("tsUs", 0.0))
                    ),
                    "attrs": r.get("args") or {},
                }
            )
            synth_id -= 1
            continue
        if ph in ("X", "i"):
            clean.append(
                {
                    "name": r.get("name", "?"),
                    "spanId": synth_id,
                    "parentId": 0,
                    "startUs": float(r.get("tsUs", 0.0)),
                    "durUs": float(r.get("durUs", 0.0)),
                    "attrs": r.get("args") or {},
                }
            )
            synth_id -= 1
            continue
        if "name" in r and "spanId" in r:
            r.setdefault("parentId", 0)
            r.setdefault("startUs", 0.0)
            r.setdefault("durUs", 0.0)
            r.setdefault("attrs", {})
            clean.append(r)
            continue
        dropped += 1
    dropped += len(open_begins)  # ends lost to truncation
    return clean, dropped


class Trace:
    """Indexed view of a span list: parent/child links + category sums."""

    def __init__(self, records: Iterable[Dict]):
        # defensively span-shaped only: callers SHOULD sanitize first
        # (sanitize_records), but a stray malformed record must degrade
        # to "skipped", not a KeyError ten frames down
        self.records = [
            r for r in records if isinstance(r, dict) and "spanId" in r
        ]
        self.by_id = {r["spanId"]: r for r in self.records}
        self.children: Dict[int, List[Dict]] = {}
        for r in self.records:
            self.children.setdefault(r.get("parentId", 0), []).append(r)

    def ancestors(self, record: Dict):
        parent = self.by_id.get(record.get("parentId", 0))
        while parent is not None:
            yield parent
            parent = self.by_id.get(parent.get("parentId", 0))

    def descendants(self, record: Dict):
        stack = list(self.children.get(record["spanId"], ()))
        while stack:
            r = stack.pop()
            yield r
            stack.extend(self.children.get(r["spanId"], ()))

    @staticmethod
    def category(record: Dict) -> Optional[str]:
        return (record.get("attrs") or {}).get("category")

    def _categorized_between(self, record: Dict, container: Dict) -> bool:
        """True when a categorized span sits strictly between `record` and
        `container` on the parent chain."""
        parent = self.by_id.get(record.get("parentId", 0))
        while parent is not None and parent["spanId"] != container["spanId"]:
            if self.category(parent) in CATEGORIES:
                return True
            parent = self.by_id.get(parent.get("parentId", 0))
        return False

    def breakdown(self, record: Dict) -> Dict[str, float]:
        """Wall-time split of one container span: categorized time from its
        outermost categorized descendants, `compute` as the residual."""
        wall = float(record.get("durUs", 0.0))
        out = {c: 0.0 for c in CATEGORIES}
        for d in self.descendants(record):
            cat = self.category(d)
            if cat not in out:
                continue
            # outermost-categorized only: a readback nested inside a cache
            # span (or any categorized ancestor below `record`) is already
            # paid by its enclosing categorized span
            if self._categorized_between(d, record):
                continue
            out[cat] += float(d.get("durUs", 0.0))
        out["compute"] = max(0.0, wall - sum(out.values()))
        out["wall"] = wall
        return out

    def collective_stats(self, record: Dict) -> Dict[str, Dict[str, float]]:
        """Trace-time collective op events under a container: count + bytes
        per op (zero-duration marks)."""
        stats: Dict[str, Dict[str, float]] = {}
        for d in self.descendants(record):
            name = d.get("name", "")
            if not name.startswith("collective."):
                continue
            attrs = d.get("attrs") or {}
            agg = stats.setdefault(name[len("collective."):], {"count": 0, "bytes": 0})
            agg["count"] += 1
            agg["bytes"] += int(attrs.get("bytes", 0))
        return stats


def stage_records(trace: Trace) -> List[Dict]:
    """The stage-level containers: `pipeline.stage` spans when a Pipeline
    ran, else outermost `stage.fit`/`stage.transform` spans."""
    pipeline_stages = [r for r in trace.records if r.get("name") == "pipeline.stage"]
    if pipeline_stages:
        return sorted(pipeline_stages, key=lambda r: r.get("startUs", 0.0))
    out = []
    for r in trace.records:
        if r.get("name") not in ("stage.fit", "stage.transform"):
            continue
        if any(a.get("name") in _STAGE_NAMES for a in trace.ancestors(r)):
            continue
        out.append(r)
    return sorted(out, key=lambda r: r.get("startUs", 0.0))


def epoch_records(trace: Trace) -> List[Dict]:
    return sorted(
        (r for r in trace.records if r.get("name") == "iteration.epoch"),
        key=lambda r: r.get("startUs", 0.0),
    )


def run_summaries(trace: Trace) -> List[Dict]:
    """`iteration.run` records — the per-run summary a loop without a host
    step per epoch (a captured whole fit) emits instead of epoch spans."""
    return sorted(
        (r for r in trace.records if r.get("name") == "iteration.run"),
        key=lambda r: r.get("startUs", 0.0),
    )


def compile_cost(trace: Trace) -> List[Dict]:
    """Per-kernel capture cost and the program bank's hit/load split.

    A `jit.compile` span (a capture) with a `kernel` attribute is that
    kernel's; `bank.compile` spans (the JAX package's bank compiles) too;
    a `jit.compile` span with neither aggregates into one unattributed
    row. `bank.hit` / `bank.load` events count calls served by banked
    graphs and warm-loaded entries per kernel."""
    rows: Dict[str, Dict] = {}

    def row(kernel: str) -> Dict:
        return rows.setdefault(
            kernel,
            {"kernel": kernel, "compiles": 0, "compileMs": 0.0,
             "bankHits": 0, "bankLoads": 0},
        )

    for r in trace.records:
        name = r.get("name")
        kernel = (r.get("attrs") or {}).get("kernel") or "?"
        if name == "bank.compile":
            entry = row(kernel)
            entry["compiles"] += 1
            entry["compileMs"] += float(r.get("durUs", 0.0)) / 1000.0
        elif name == "bank.hit":
            row(kernel)["bankHits"] += 1
        elif name == "bank.load":
            row(kernel)["bankLoads"] += 1
        elif name == "jit.compile" and (r.get("attrs") or {}).get("kernel"):
            entry = row(kernel)
            entry["compiles"] += 1
            entry["compileMs"] += float(r.get("durUs", 0.0)) / 1000.0
        elif name == "jit.compile" and not any(
            a.get("name") == "bank.compile" for a in trace.ancestors(r)
        ):
            entry = row("(unattributed compile)")
            entry["compiles"] += 1
            entry["compileMs"] += float(r.get("durUs", 0.0)) / 1000.0
    return sorted(
        rows.values(), key=lambda e: (-e["compileMs"], e["kernel"])
    )


def _stage_label(record: Dict) -> str:
    attrs = record.get("attrs") or {}
    stage = attrs.get("stage", "?")
    if record.get("name") == "pipeline.stage":
        op = attrs.get("op", "")
        idx = attrs.get("index")
        prefix = f"[{idx}] " if idx is not None else ""
        return f"{prefix}{stage}.{op}" if op else f"{prefix}{stage}"
    op = record["name"].rsplit(".", 1)[-1]
    return f"{stage}.{op}"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    def fmt(cells):
        return "  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                         for i, (c, w) in enumerate(zip(cells, widths)))
    lines = [fmt(headers), fmt(["-" * w for w in widths])]
    lines.extend(fmt(r) for r in rows)
    return "\n".join(lines)


def _breakdown_row(label: str, b: Dict[str, float]) -> List[str]:
    wall = b["wall"]
    cells = [label, f"{wall / 1000.0:.1f}"]
    for cat in ("compute",) + CATEGORIES:
        pct = 100.0 * b.get(cat, 0.0) / wall if wall > 0 else 0.0
        cells.append(f"{b.get(cat, 0.0) / 1000.0:.1f} ({pct:.0f}%)")
    return cells


def render_report(records: List[Dict], max_epochs: int = 20) -> str:
    """The human-readable report: stage table, epoch table, run summaries,
    collective traffic, and the dominant time category."""
    trace = Trace(records)
    sections = []
    headers = ["", "wallMs", "compute", "collective", "readback", "compile", "cache"]

    stages = stage_records(trace)
    totals = {c: 0.0 for c in ("wall", "compute") + CATEGORIES}
    if stages:
        rows = []
        for r in stages:
            b = trace.breakdown(r)
            rows.append(_breakdown_row(_stage_label(r), b))
            for k in totals:
                totals[k] += b.get(k, 0.0)
        rows.append(_breakdown_row("TOTAL", totals))
        sections.append("== Per-stage breakdown ==\n" + _table(headers, rows))
    else:
        sections.append("== Per-stage breakdown ==\n(no stage spans in trace)")

    epochs = epoch_records(trace)
    if epochs:
        rows = []
        shown = epochs if len(epochs) <= max_epochs else epochs[:max_epochs]
        etotals = {c: 0.0 for c in ("wall", "compute") + CATEGORIES}
        for r in epochs:
            b = trace.breakdown(r)
            for k in etotals:
                etotals[k] += b.get(k, 0.0)
        for r in shown:
            b = trace.breakdown(r)
            label = f"epoch {(r.get('attrs') or {}).get('epoch', '?')}"
            rows.append(_breakdown_row(label, b))
        if len(epochs) > len(shown):
            rows.append([f"... {len(epochs) - len(shown)} more", "", "", "", "", "", ""])
        rows.append(_breakdown_row(f"TOTAL ({len(epochs)} epochs)", etotals))
        sections.append("== Per-epoch breakdown ==\n" + _table(headers, rows))

    runs = run_summaries(trace)
    if runs:
        lines = []
        for r in runs:
            attrs = r.get("attrs") or {}
            n = attrs.get("epochs")
            wall_ms = float(r.get("durUs", 0.0)) / 1000.0
            per = f", {wall_ms / n:.2f} ms/epoch" if n else ""
            lines.append(
                f"- mode={attrs.get('mode', '?')} epochs={n} "
                f"wallMs={wall_ms:.1f}{per}"
                + (f" finalCriteria={attrs['finalCriteria']:.4g}"
                   if "finalCriteria" in attrs else "")
            )
        sections.append(
            "== Iteration runs (on-device loops report one summary span) ==\n"
            + "\n".join(lines)
        )

    cost = compile_cost(trace)
    if cost:
        # the text table elides the middle of long kernel ids
        def _elide(kernel: str, width: int = 72) -> str:
            if len(kernel) <= width:
                return kernel
            half = (width - 3) // 2
            return kernel[:half] + "..." + kernel[-half:]

        rows = [
            [
                _elide(e["kernel"]),
                str(e["compiles"]),
                f"{e['compileMs']:.1f}",
                str(e["bankHits"]),
                str(e["bankLoads"]),
            ]
            for e in cost
        ]
        rows.append([
            "TOTAL",
            str(sum(e["compiles"] for e in cost)),
            f"{sum(e['compileMs'] for e in cost):.1f}",
            str(sum(e["bankHits"] for e in cost)),
            str(sum(e["bankLoads"] for e in cost)),
        ])
        sections.append(
            "== Compile cost (captures and the program bank) ==\n"
            + _table(
                ["kernel", "compiles", "compileMs", "bankHits", "bankLoads"],
                rows,
            )
        )

    # collective traffic across the whole trace
    root = {"spanId": 0, "durUs": 0.0}
    trace.children.setdefault(0, [])
    coll = trace.collective_stats(root)
    if coll:
        rows = [
            [op, str(int(s["count"])), f"{int(s['bytes'])}"]
            for op, s in sorted(coll.items())
        ]
        sections.append(
            "== Collective ops (recorded at trace time; bytes = payload per call) ==\n"
            + _table(["op", "calls", "bytes"], rows)
        )

    if totals["wall"] > 0:
        cats = OrderedDict((c, totals.get(c, 0.0)) for c in ("compute",) + CATEGORIES)
        dominant = max(cats, key=cats.get)
        pct = 100.0 * cats[dominant] / totals["wall"]
        sections.append(
            f"Dominant category: {dominant} "
            f"({cats[dominant] / 1000.0:.1f} ms, {pct:.0f}% of stage wall time)"
        )

    return "\n\n".join(sections)


def render_device_profile(path: str) -> str:
    """Cross-reference a torch.profiler chrome trace
    (traceprof.analyze_trace; a directory: its newest *.json) against the
    span accounting."""
    import glob
    import os

    from ..utils.traceprof import analyze_trace

    if os.path.isdir(path):
        candidates = sorted(glob.glob(os.path.join(path, "*.json")) +
                            glob.glob(os.path.join(path, "*.json.gz")), key=os.path.getmtime)
        if not candidates:
            return f"== Device profile ==\n(no chrome trace under {path})"
        path = candidates[-1]
    stats = analyze_trace(path)
    idle = stats.get("deviceIdleShare")
    lines = [
        f"deviceBusyMs: {stats['deviceBusyMs']:.1f}",
        f"windowMs: {stats['windowMs']:.1f}",
        "deviceIdleShare: " + (f"{idle:.3f}" if idle is not None else "not measured"),
        f"deviceEvents: {stats['deviceEvents']}",
    ]
    top = stats.get("topKernels", {})
    if top:
        lines.append("top kernels: " + ", ".join(
            f"{k[:40]} {v['durUs'] / 1000.0:.1f}ms" for k, v in list(top.items())[:5]
        ))
    return "== Device profile (" + path + ") ==\n" + "\n".join(lines)
