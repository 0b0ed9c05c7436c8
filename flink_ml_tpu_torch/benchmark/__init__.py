"""The benchmark CLI and data generators (`python -m flink_ml_tpu_torch.benchmark`).

Port of flink_ml_tpu/benchmark/: `runner.py` (the config runner and the
CLI) and `datagenerator.py` (the param-driven table sources)."""
