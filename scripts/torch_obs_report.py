#!/usr/bin/env python
"""torch_obs_report — render a span trace of flink_ml_tpu_torch into
per-stage/per-epoch breakdowns (the port's counterpart of
scripts/obs_report.py: the same flags, output and exit codes; it imports
only flink_ml_tpu_torch, so it runs where JAX is not installed).

Usage:
    python scripts/torch_obs_report.py TRACE.jsonl [options]
    python scripts/torch_obs_report.py --hbm-dump DUMP.json

Options:
    --device-profile PATH   Cross-reference a torch.profiler chrome trace
                            (a directory: its newest *.json or *.json.gz;
                            or the file) via utils/traceprof.analyze_trace
                            — device-busy time vs the host-side span
                            accounting.
    --hbm-dump PATH         Render a device-memory forensic dump (the
                            JSON an `HbmExhausted` writes when
                            FLINK_ML_TPU_HBM_DUMP is set, or any
                            memledger.dump_snapshot output): per-category
                            live bytes, peak watermark, and the ranked
                            entry table with allocation sites. Works
                            standalone (no trace file) or alongside one.
    --max-epochs N          Rows to print in the epoch table (default 20;
                            the TOTAL row always aggregates all epochs).
    --format text|json      Output format (default text). JSON emits the
                            raw breakdown tables (for dashboards / CI
                            assertions). `--json` is the legacy alias.

Robustness: ring-truncated and mid-span-truncated trace files are
expected inputs — unparseable lines, unmatched begin/end pairs (timeline
dumps) and malformed records are dropped with a warning on stderr, never
a crash.

Capture a trace by running any workload with
`FLINK_ML_TPU_TRACE_FILE=/tmp/trace.jsonl` set, e.g.:

    FLINK_ML_TPU_TRACE_FILE=/tmp/fit.jsonl python my_fit.py   # imports flink_ml_tpu_torch
    python scripts/torch_obs_report.py /tmp/fit.jsonl

The report splits each pipeline stage / training epoch into compute,
collective, readback, compile and cache time (categories sum to the
span's wall time — `compute` is the residual) and flags the dominant
category (flink_ml_tpu_torch/obs/report.py).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flink_ml_tpu_torch.obs import report  # noqa: E402


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} {unit}"
        n /= 1024.0


def render_hbm_dump(dump):
    """The forensic ledger snapshot (memledger.snapshot shape) as the
    ranked text table the out-of-memory postmortem starts from."""
    lines = [
        f"HBM ledger: {_fmt_bytes(dump.get('liveBytes', 0))} live across "
        f"{dump.get('entryCount', 0)} entr(ies), "
        f"peak {_fmt_bytes(dump.get('peakBytes', 0))}",
        "",
        "  by category:",
    ]
    categories = dump.get("categories") or {}
    for cat, nbytes in categories.items():
        lines.append(f"    {cat:<16} {_fmt_bytes(nbytes):>12}")
    if not categories:
        lines.append("    (none live)")
    entries = dump.get("topEntries") or []
    if entries:
        lines += ["", f"  top {len(entries)} entries by bytes:"]
        for e in entries:
            shape = "x".join(str(d) for d in e["shape"]) if e.get("shape") else "?"
            lines.append(
                f"    {_fmt_bytes(e.get('nbytes', 0)):>12}  "
                f"{e.get('category', '?'):<14} {shape:<14} "
                f"{e.get('dtype') or '?':<10} {e.get('site') or '?'}"
            )
    return "\n".join(lines)


def main(argv):
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if "--hbm-dump" in argv:
        from flink_ml_tpu_torch.obs import memledger

        dump_path = argv[argv.index("--hbm-dump") + 1]
        print(render_hbm_dump(memledger.load_dump(dump_path)))
        if argv[0] == "--hbm-dump":  # standalone mode, no trace to render
            return 0
        print()
    trace_path = argv[0]
    max_epochs = 20
    if "--max-epochs" in argv:
        max_epochs = int(argv[argv.index("--max-epochs") + 1])
    fmt = "text"
    if "--format" in argv:
        fmt = argv[argv.index("--format") + 1]
        if fmt not in ("text", "json"):
            print(f"unknown --format {fmt!r} (text|json)", file=sys.stderr)
            return 2
    if "--json" in argv:  # legacy alias
        fmt = "json"
    records, dropped = report.sanitize_records(report.load_trace(trace_path))
    if dropped:
        print(
            f"warning: dropped {dropped} unmatched/malformed record(s) "
            "(ring- or mid-span-truncated trace)",
            file=sys.stderr,
        )
    if not records:
        print(f"No span records in {trace_path}.", file=sys.stderr)
        return 1

    if fmt == "json":
        trace = report.Trace(records)
        payload = {
            "stages": [
                {
                    "label": report._stage_label(r),
                    "attrs": r.get("attrs", {}),
                    **trace.breakdown(r),
                }
                for r in report.stage_records(trace)
            ],
            "epochs": [
                {"attrs": r.get("attrs", {}), **trace.breakdown(r)}
                for r in report.epoch_records(trace)
            ],
            "runs": [
                {"attrs": r.get("attrs", {}), "wallUs": r.get("durUs", 0.0)}
                for r in report.run_summaries(trace)
            ],
            "compileCost": report.compile_cost(trace),
        }
        print(json.dumps(payload, indent=2))
    else:
        print(f"Trace: {trace_path} ({len(records)} spans)\n")
        print(report.render_report(records, max_epochs=max_epochs))

    if "--device-profile" in argv:
        profile = argv[argv.index("--device-profile") + 1]
        print()
        print(report.render_device_profile(profile))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
