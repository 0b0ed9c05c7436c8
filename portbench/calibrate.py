"""The readings that a cell's limits are set from, on the card, in one
process:

    python -m portbench.calibrate --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--seconds 2] [--also score_gap]
        [--out chiprun_out/portbench]

For each seed the cell's table is made, its traffic warmed and run for a
short window at the cell's own load, and each of the cell's numbers read
from the sampled answers, as a run reads them (the program's readings).
For each control seed the control answers the same sampled requests: the
plain reference in TF32 arithmetic put in the program's place, judged by
the same numbers against the float64 reference (the control's readings).
A limit lies above the largest program reading and below the smallest
control reading (PERF.md gives both and the limit). The benchmark's own
runs never run the control.

`--also` reads further checks beside the cell's own, compared with
nothing: a number that PERF.md names as not compared, with its readings.

Each reading is a JSON line on standard output and in
`<out>/calibrate_<cell>.jsonl`; the last line sums them up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import compare, harness, program


def readings(cell, seed: int, seconds: float, control: bool, device, names=None):
    """{"seed", "program": {number: value}, "control"?: {...}, "answers"}
    for the cell's compared numbers, or for `names`."""
    names = list(cell.limits) if names is None else names
    with program.device_scope(device):
        tensors, work, _ = harness.prepare(cell, seed, device)
        window = work.run(seconds)
        answers = work.answers()
        del work
        reference = compare.Reference(cell.config, tensors)
        row = {"seed": seed, "requests": window.completed, "failed": window.failed,
               "answers": len(answers),
               "program": compare.measure(names, answers, reference)}
        if control:
            tf32 = compare.Reference(cell.config, tensors, "tf32")
            row["control"] = compare.measure(names, compare.control_answers(answers, tf32),
                                             reference)
        del answers, reference, tensors
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--control-seeds", default="", help="seeds that also read the control")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--also", default="",
                        help="comma-separated checks read beside the cell's own (not compared)")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "portbench"))
    args = parser.parse_args(argv)
    cell = harness.Cell(harness.benchmark_spec(), args.workload)
    device = harness.card(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    names = list(cell.limits) + [n for n in args.also.split(",") if n and n not in cell.limits]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"calibrate_{cell.name}.jsonl")
    rows = []
    with open(path, "a") as log:
        for seed in sorted(set(seeds) | controls):
            t0 = time.perf_counter()
            row = readings(cell, seed, args.seconds, seed in controls, device, names)
            row["seconds"] = time.perf_counter() - t0
            row["device"] = torch.cuda.get_device_name(device)
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + "\n")
        summary = {"cell": cell.name, "limits": cell.limits, "program_max": {}, "control_min": {}}
        for name in names:
            got = [r["program"][name] for r in rows if r["program"][name] is not None]
            ctl = [r["control"][name] for r in rows if "control" in r
                   and r["control"][name] is not None]
            summary["program_max"][name] = max(got) if got else None
            summary["control_min"][name] = min(ctl) if ctl else None
        line = json.dumps(summary)
        print(line, flush=True)
        log.write(line + "\n")
    found = harness.forbidden_modules()
    if found:
        print(f"calibrate: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
