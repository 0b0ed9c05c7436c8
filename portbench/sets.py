"""Runs of one cell, one process each, in one call, and their spread:

    python -m portbench.sets --workload <cell> --seeds 1,2,3 [--seconds 10]
        [--trace 0] [--label set1] [--out chiprun_out/portbench]

Each seed's run is `python -m portbench ...` as the benchmark's command
runs it, one after the other. Every run's result line (with its exit
code, wall time, and the end of its standard error where it failed) is
appended to `<out>/<cell>.<label>.jsonl`. The last line printed gives,
for each metric, the median and the spread of the runs: the distance
between the first and third quartiles (`statistics.quantiles(n=4)`) as a
share of the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    """(median, (q3 - q1) / median) of the values."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench.sets")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--trace", type=int, default=0, choices=(0, 1))
    parser.add_argument("--label", default="set")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "portbench"))
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.{args.label}.jsonl")
    values = {}
    with open(path, "a") as log:
        for seed in (int(s) for s in args.seeds.split(",") if s):
            cmd = [sys.executable, "-m", "portbench", "--workload", args.workload,
                   "--seed", str(seed), "--seconds", f"{args.seconds:g}",
                   "--trace", str(args.trace)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            row = {"seed": seed, "rc": proc.returncode, "wall_s": time.perf_counter() - t0}
            lines = proc.stdout.strip().splitlines()
            try:
                row["result"] = json.loads(lines[-1])
            except (IndexError, ValueError):
                row["result"] = None
            if proc.returncode != 0 or row["result"] is None or not row["result"]["correct"]:
                row["stderr_tail"] = proc.stderr[-4000:]
            else:
                row["stderr_tail"] = proc.stderr[-600:]
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + "\n")
            if row["result"]:
                for name, m in row["result"]["metrics"].items():
                    values.setdefault(name, []).append(m["value"])
        summary = {"workload": args.workload, "label": args.label, "runs": {}}
        for name, vals in values.items():
            med, share = spread(vals)
            summary["runs"][name] = {"n": len(vals), "median": med, "spread": share,
                                     "values": vals}
        line = json.dumps(summary)
        print(line, flush=True)
        log.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
