#!/usr/bin/env python
"""torch_smoke_fit_timeline — traced LR fits of flink_ml_tpu_torch for the
flight-recorder artifact (the port's counterpart of
scripts/smoke_fit_timeline.py: the same fits, output and exit codes; it
imports only flink_ml_tpu_torch, so it runs where JAX is not installed).

Runs TWO small SGD fits with the timeline ring enabled and dumps each
event JSONL (FLINK_ML_TPU_TIMELINE_FILE wins for the first if set):

1. a chunked (checkpointed, `whole_fit` off) fit — the multi-chunk
   dispatch pipeline timeline, -> EVENTS_OUT.jsonl. The port's chunks
   end at checkpoint boundaries only, so the interval of 8 epochs gives
   the 7 chunks of the 56-epoch fit;
2. the SAME fit through the whole-fit program (`whole_fit` auto, a
   snapshot at the fit's end only) — the single-dispatch timeline,
   -> EVENTS_OUT base + "-wholefit.jsonl".

Render both with scripts/torch_obs_timeline.py: the one-dispatch claim is
visually checkable in Perfetto. The chunked timeline carries the `memory`
counter lane (hbm.live per category), the device-memory track.

After the fits, a third probe re-runs the chunked fit under a deliberately
tiny device-memory budget (config.hbm_budget_mode) and asserts it fails
with the *typed* HbmBudgetExceeded carrying a category breakdown — budget
admission stays deterministic and clean (no raw allocator error, no
partial dispatch).

The fits run on the card; a caller that wants the CPU runs `main` under
`flink_ml_tpu_torch.config.use_device("cpu")`.

Usage: python scripts/torch_smoke_fit_timeline.py [EVENTS_OUT.jsonl]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fit(timeline, config, out_path, mode, checkpoint_interval, label):
    import numpy as np

    from flink_ml_tpu_torch.ops.losses import BINARY_LOGISTIC_LOSS
    from flink_ml_tpu_torch.ops.optimizer import SGD

    rng = np.random.RandomState(3)
    X = rng.randn(400, 8).astype(np.float32)
    y = (X @ np.linspace(1, -1, 8) > 0).astype(np.float32)
    timeline.configure(ring_size=65536)
    with config.whole_fit_mode(mode), tempfile.TemporaryDirectory() as ckpt_dir:
        sgd = SGD(
            max_iter=56,
            global_batch_size=100,
            tol=0.0,
            checkpoint_dir=ckpt_dir,
            checkpoint_interval=checkpoint_interval,
        )
        _, _, epochs = sgd.optimize(np.zeros(8), X, y, None, BINARY_LOGISTIC_LOSS)
    n = timeline.dump_jsonl(out_path)
    attr = timeline.dispatch_attribution()
    timeline.configure()  # reset the ring between the two fits
    print(f"smoke fit ({label}): {epochs} epochs, {n} timeline events -> {out_path}")
    if attr:
        print(
            "attribution: "
            + ", ".join(
                f"{k} {attr[k]:.1f}ms"
                for k in ("windowMs", "dispatchMs", "deviceMs", "readbackMs", "idleGapMs")
            )
            + f" over {attr['gapCount']} chunks"
        )
    return attr


def _budget_probe(config):
    """Re-run the chunked fit under a ~1 KiB device-memory budget and
    demand the typed, breakdown-carrying HbmBudgetExceeded — never a raw
    allocator error or a silent success."""
    from flink_ml_tpu_torch.obs import memledger, timeline

    with config.hbm_budget_mode(1024):
        try:
            _fit(timeline, config, os.devnull, "off", 8, "budget-probe")
        except memledger.HbmBudgetExceeded as e:
            if not e.breakdown and e.requested_bytes <= 0:
                print(f"ERROR: HbmBudgetExceeded carries no forensics: {e}")
                return 1
            print(f"budget probe: clean typed rejection: {e}")
            return 0
        except Exception as e:  # noqa: BLE001 — the probe exists to type-check this
            print(f"ERROR: budget probe raised {type(e).__name__}, "
                  f"expected HbmBudgetExceeded: {e}")
            return 1
    print("ERROR: budget probe fit succeeded under a 1 KiB HBM budget")
    return 1


def main(argv):
    out_path = argv[0] if argv else os.environ.get(
        "FLINK_ML_TPU_TIMELINE_FILE", "timeline-events.jsonl"
    )
    from flink_ml_tpu_torch import config
    from flink_ml_tpu_torch.obs import timeline

    _fit(timeline, config, out_path, "off", 8, "chunked")

    base, ext = os.path.splitext(out_path)
    whole_path = f"{base}-wholefit{ext or '.jsonl'}"
    attr = _fit(timeline, config, whole_path, "auto", 56, "whole-fit")
    if attr and attr.get("gapCount", 0) != 1:
        print(
            f"ERROR: whole-fit timeline recorded {attr.get('gapCount')} "
            "dispatch->drain cycles, expected the single-dispatch timeline"
        )
        return 1
    return _budget_probe(config)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
