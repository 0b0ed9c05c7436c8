#!/usr/bin/env python3
"""Attribute a change in chip_smoke.py's host-bound paths (phase 9's
RegexTokenizer, phase 12's serving) to the program funnel or not, on the
card.

    python3 scripts/chip_host_attribution.py [--parent DIR] [--order default,off,forget,parent]

Each variant runs chip_smoke.py's phases 1-12 in a process of its own (the
run stops once phase 12 is done), one after another:

- `default`: the tree as it is;
- `off`: `FLINK_ML_TPU_WHOLE_FIT=off`, every whole fit op by op, so no fit
  graph is captured or kept;
- `forget`: the program caches emptied (`lazyjit.forget_graphs`, then
  `torch.cuda.empty_cache`) just before phase 9;
- `parent`: chip_smoke.py of another checkout (`--parent`, such as the
  parent commit unpacked with `git archive`).

At phase 9's start each variant logs the device memory allocated and
reserved and the objects the garbage collector tracks, and during phase 9
it times the collector's passes (`gc.callbacks`). Each variant's output
goes to chiprun_out/attribution/<i>-<variant>.log; the script prints one JSON
summary: RegexTokenizer's first and warm transform ms, phases 9 and 12's
seconds, the serving modes' requests/s, the collector's time in phase 9,
and the card's name and power limit.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "chiprun_out", "attribution")

#: run in each variant's process: chip_smoke's phases 1-12 with the probe
CHILD = r"""
import gc, sys, time
import torch
import chip_smoke as cs

FORGET = sys.argv[1] == "forget"


class Done(Exception):
    pass


def probed(phase):
    def run(*args, **kwargs):
        if FORGET:
            from flink_ml_tpu_torch.utils import lazyjit
            lazyjit.forget_graphs()
            torch.cuda.empty_cache()
        gc_s = [0.0, 0]
        start = [0.0]

        def timer(step, info):
            if step == "start":
                start[0] = time.perf_counter()
            else:
                gc_s[0] += time.perf_counter() - start[0]
                gc_s[1] += info["generation"] == 2
        cs.log(f"attribution: phase 9 starts with {torch.cuda.memory_allocated() / 2**30:.3f} "
               f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
               f"{len(gc.get_objects())} objects tracked")
        gc.callbacks.append(timer)
        try:
            return phase(*args, **kwargs)
        finally:
            gc.callbacks.remove(timer)
            cs.log(f"attribution: phase 9 spent {gc_s[0]:.3f} s in the collector "
                   f"({gc_s[1]} full passes)")
    return run


def stop(*args, **kwargs):
    raise Done()


cs.slice8_phase = probed(cs.slice8_phase)
cs.checkpoint_phase = stop  # phase 13 on is not attributed
try:
    cs.main()
except Done:
    cs.log("attribution: stopped after phase 12")
"""

PATTERNS = {
    "regex_first_ms": r"  regextokenizer: first transform ([\d.]+) ms",
    "regex_warm_ms": r"  regextokenizer: first transform [\d.]+ ms; "
                     r"warm median transform ([\d.]+) ms",
    "phase9_s": r"  phase 9 took ([\d.]+) s",
    "phase12_s": r"  phase 12 took ([\d.]+) s",
    "phase9_gc_s": r"attribution: phase 9 spent ([\d.]+) s in the collector",
    "phase9_gc_full_passes": r"attribution: phase 9 spent [\d.]+ s in the collector \((\d+) full",
    "phase9_allocated_gib": r"attribution: phase 9 starts with ([\d.]+) GiB allocated",
    "phase9_reserved_gib": r"GiB allocated, ([\d.]+) GiB reserved",
    "phase9_objects": r"GiB reserved, (\d+) objects tracked",
}
MODES = ("pull", "request", "fixed", "continuous")


def parse(text):
    out = {}
    for key, pattern in PATTERNS.items():
        m = re.search(pattern, text)
        out[key] = float(m.group(1)) if m else None
    for mode in MODES:
        m = re.search(rf"  {mode}: \d+ requests .*?: (\d+) requests/s", text)
        out[f"{mode}_requests_per_s"] = float(m.group(1)) if m else None
    out["stopped_after_phase_12"] = "attribution: stopped after phase 12" in text
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout's root, run as the `parent` variant")
    ap.add_argument("--order", default="default,off,forget,parent",
                    help="the variants, comma-separated, in the order they run")
    ap.add_argument("--timeout", type=float, default=1100.0, help="seconds a variant may take")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    summary = {"card": card, "variants": []}
    for i, variant in enumerate(v for v in args.order.split(",") if v):
        if variant == "parent" and not args.parent:
            continue
        env = dict(os.environ)
        if variant == "off":
            env["FLINK_ML_TPU_WHOLE_FIT"] = "off"
        cwd = os.path.abspath(args.parent) if variant == "parent" else HERE
        log = os.path.join(OUT, f"{i}-{variant}.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, "-c", CHILD, variant], cwd=cwd, env=env,
                                  stdout=f, stderr=subprocess.STDOUT, timeout=args.timeout)
        with open(log) as f:
            row = parse(f.read())
        row.update(variant=variant, rc=proc.returncode, wall_s=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        summary["variants"].append(row)
    print(card)
    print(json.dumps(summary))
    return 0 if all(r["rc"] == 0 and r["stopped_after_phase_12"]
                    for r in summary["variants"]) else 1


if __name__ == "__main__":
    sys.exit(main())
