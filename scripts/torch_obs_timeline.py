#!/usr/bin/env python
"""torch_obs_timeline — render a flight-recorder dump of flink_ml_tpu_torch
as a Perfetto timeline (the port's counterpart of scripts/obs_timeline.py:
the same flags, output and exit codes; it imports only flink_ml_tpu_torch,
so it runs where JAX is not installed).

Usage:
    python scripts/torch_obs_timeline.py EVENTS.jsonl [options]

Options:
    -o, --output PATH    Write the Chrome trace-event JSON here (default:
                         EVENTS.timeline.json next to the input). Open it
                         directly in https://ui.perfetto.dev or
                         chrome://tracing.
    --attribution        Also print the dispatch-wall attribution
                         (wall = dispatch + device + readback + idle-gap,
                         totals + per-epoch means) derived from the
                         dispatch/device/readback lanes.
    --json               Print the attribution as JSON instead of text
                         (implies --attribution).

Input: the JSONL a run dumps when `FLINK_ML_TPU_TIMELINE_FILE` is set
(flink_ml_tpu_torch/obs/timeline.py writes the ring at process exit), or
a span-trace JSONL from `FLINK_ML_TPU_TRACE_FILE` — span records are
converted to complete events on a single host lane so either capture
opens in Perfetto.

Robustness contract: ring truncation and files cut mid-line are expected
inputs — unmatched begin/end events and unparseable lines are dropped
with a warning on stderr, never a crash.

Capture example (a traced chunked fit):

    python scripts/torch_smoke_fit_timeline.py /tmp/fit.events.jsonl
    python scripts/torch_obs_timeline.py /tmp/fit.events.jsonl -o /tmp/fit.json
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flink_ml_tpu_torch.obs import timeline  # noqa: E402


def _span_records_to_events(records):
    """Convert span-trace JSONL records ({name, startUs, durUs, attrs})
    into timeline X events on one host lane (Perfetto nests by duration)."""
    events = []
    for r in records:
        if not isinstance(r, dict) or "startUs" not in r:
            continue
        events.append(
            {
                "ph": "X",
                "lane": "host:trace",
                "name": r.get("name", "?"),
                "tsUs": float(r.get("startUs", 0.0)),
                "durUs": float(r.get("durUs", 0.0)),
                "args": r.get("attrs") or None,
            }
        )
    return events


def load_any(path: str):
    """Timeline-event JSONL or span-trace JSONL -> timeline events,
    skipping unparseable (truncated) lines with a count."""
    events, spans, skipped = [], [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(rec, dict):
                skipped += 1
            elif "ph" in rec and "lane" in rec:
                events.append(rec)
            elif "startUs" in rec and "name" in rec:
                spans.append(rec)
            else:
                skipped += 1
    events.extend(_span_records_to_events(spans))
    events.sort(key=lambda e: e.get("tsUs", 0.0))
    return events, skipped


def main(argv):
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    in_path = argv[0]
    out_path = None
    for flag in ("-o", "--output"):
        if flag in argv:
            out_path = argv[argv.index(flag) + 1]
    if out_path is None:
        base = in_path[:-6] if in_path.endswith(".jsonl") else in_path
        out_path = base + ".timeline.json"

    try:
        events, skipped = load_any(in_path)
    except OSError as e:
        print(f"torch_obs_timeline: cannot read {in_path}: {e}", file=sys.stderr)
        return 2
    if skipped:
        print(
            f"warning: skipped {skipped} unparseable line(s) (truncated capture?)",
            file=sys.stderr,
        )
    if not events:
        print(f"No timeline events in {in_path}.", file=sys.stderr)
        return 1

    doc = timeline.to_chrome(events)
    dropped = doc.get("otherData", {}).get("unmatchedDropped", 0)
    if dropped:
        print(
            f"warning: dropped {dropped} unmatched begin/end event(s) "
            "(ring truncation)",
            file=sys.stderr,
        )
    with open(out_path, "w") as f:
        json.dump(doc, f)
    lanes = sum(1 for e in doc["traceEvents"] if e.get("name") == "thread_name")
    print(
        f"Wrote {out_path}: {len(doc['traceEvents'])} trace events on "
        f"{lanes} lanes (open in https://ui.perfetto.dev)."
    )

    if "--attribution" in argv or "--json" in argv:
        attr = timeline.dispatch_attribution(events)
        if not attr:
            print("No dispatch-lane events: attribution unavailable.")
            return 0
        if "--json" in argv:
            print(json.dumps(attr, indent=2))
        else:
            print(
                "\nDispatch-wall attribution "
                "(wall = dispatch + device + readback + idle-gap):"
            )
            print(
                f"  window {attr['windowMs']:.1f} ms over {attr['gapCount']} "
                f"chunk(s)"
                + (f", {attr['epochs']} epochs" if "epochs" in attr else "")
            )
            for key in ("dispatchMs", "deviceMs", "readbackMs", "idleGapMs"):
                share = 100.0 * attr[key] / attr["windowMs"] if attr["windowMs"] else 0.0
                print(f"  {key:12s} {attr[key]:10.1f} ms  ({share:.0f}%)")
            if "perEpoch" in attr:
                per = attr["perEpoch"]
                print(
                    "  per epoch: "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in per.items())
                )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
