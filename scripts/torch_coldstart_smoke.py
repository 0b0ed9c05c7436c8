#!/usr/bin/env python
"""Cold-start smoke for the program bank of flink_ml_tpu_torch (the port's
counterpart of scripts/coldstart_smoke.py: the same workload, modes, JSON
keys and exit codes; it imports only flink_ml_tpu_torch, so it runs where
JAX is not installed).

One deterministic serving workload (a StandardScaler → Normalizer fused
pipeline, seed-pinned model constants and example batch) run in three
modes by a FRESH process each time:

- ``populate`` — fill the bank: ``MicroBatchServer.warmup`` drives every
  (bucket) program through the fused segments, capturing each and
  back-filling its signature into ``<bankdir>``.
- ``serve`` — the no-capture probe: serve the FIRST request, whose
  segment warm-loads the bank before it runs (each banked signature
  captured as a ``jit.bankLoads``, inside firstServeMs), and assert
  in-process that the serve captured nothing it had to wait for and
  compiled nothing (`jit.traces` / `jit.compiles` deltas both zero).
  Exit 1 otherwise.
- ``baseline`` — the same fresh-process first serve with the bank off
  (every program is captured at its first call), for the bank-on vs
  bank-off cold-start walls.

The JAX script also installs XLA's compile hooks and persistent
compilation cache; the port compiles no XLA programs and has neither, so
only `config.program_bank_dir` is set. A capture ticks `jit.compiles`
through `obs.tracing.account_compile`.

Prints one JSON object on stdout: coldStartMs (process start → first
result), firstServeMs, serveTraceCount, serveCompileCount,
bankHits/bankMisses/bankLoads, bankLoadMs, and a sha256 of the output
column for cross-process bit-identity checks.

The workload runs on the card; a caller that wants the CPU runs `main`
under `flink_ml_tpu_torch.config.use_device("cpu")`.

Usage: python scripts/torch_coldstart_smoke.py <bankdir> populate|serve|baseline
"""

import hashlib
import json
import os
import sys
import time

_T0 = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D = 16
BUCKETS = (8, 32)
ROWS = 8  # == smallest bucket: the padded batch IS the request batch


def build_workload():
    """The deterministic (seed-pinned) serving pipeline + example batch:
    populate and serve children MUST build identical programs or the
    bank signatures would never match across processes."""
    import numpy as np

    from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
    from flink_ml_tpu_torch.models.feature.standardscaler import StandardScalerModel
    from flink_ml_tpu_torch.pipeline import PipelineModel
    from flink_ml_tpu_torch.table import Table

    rng = np.random.default_rng(7)
    scaler = StandardScalerModel()
    scaler.mean = rng.standard_normal(D)
    scaler.std = np.abs(rng.standard_normal(D)) + 0.1
    scaler.set_input_col("features").set_output_col("scaled")
    norm = Normalizer().set_p(2.0).set_input_col("scaled").set_output_col("norm")
    model = PipelineModel([scaler, norm])
    example = Table(
        {"features": rng.standard_normal((ROWS, D)).astype(np.float32)}
    )
    return model, example


def main(argv):
    if len(argv) != 3 or argv[2] not in ("populate", "serve", "baseline"):
        print(
            f"usage: {argv[0]} <bankdir> populate|serve|baseline",
            file=sys.stderr,
        )
        return 2
    bank_dir, mode = argv[1], argv[2]

    from flink_ml_tpu_torch import config
    from flink_ml_tpu_torch.serving import MicroBatchServer
    from flink_ml_tpu_torch.utils import metrics

    if mode != "baseline":
        config.program_bank_dir = bank_dir

    import numpy as np

    model, example = build_workload()
    server = MicroBatchServer(model, buckets=BUCKETS)

    if mode == "populate":
        info = server.warmup(example)
        print(json.dumps({"mode": mode, **info}))
        return 0

    before = metrics.snapshot()
    t0 = time.perf_counter()
    out = list(server.serve(iter([example])))[0]
    first_serve_ms = (time.perf_counter() - t0) * 1000.0
    cold_start_ms = (time.perf_counter() - _T0) * 1000.0
    delta = metrics.snapshot_delta(before, metrics.snapshot())["counters"]
    snap = metrics.snapshot()["counters"]
    digest = hashlib.sha256(
        np.ascontiguousarray(
            np.asarray(out.column("norm"), dtype=np.float32)
        ).tobytes()
    ).hexdigest()
    payload = {
        "mode": mode,
        "coldStartMs": cold_start_ms,
        "firstServeMs": first_serve_ms,
        "serveTraceCount": float(delta.get("jit.traces", 0)),
        "serveCompileCount": float(delta.get("jit.compiles", 0)),
        "bankHits": float(snap.get("bank.hits", 0)),
        "bankMisses": float(snap.get("bank.misses", 0)),
        "bankLoads": float(snap.get("jit.bankLoads", 0)),
        "bankLoadMs": metrics.snapshot()["timers"]
        .get("bank.load", {})
        .get("totalMs", 0.0),
        "outSha": digest,
    }
    print(json.dumps(payload))
    if mode == "serve":
        if payload["serveTraceCount"] != 0 or payload["serveCompileCount"] != 0:
            print(
                "cold-start SLA violated: first serve traced or compiled "
                f"(traces={payload['serveTraceCount']}, "
                f"compiles={payload['serveCompileCount']})",
                file=sys.stderr,
            )
            return 1
        if payload["bankHits"] == 0 or payload["bankLoads"] == 0:
            print("bank never hit — warmup did not populate?", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
