"""The benchmark of the port (`flink_ml_tpu_torch`) on one H100.

Run one cell once with `python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the repository's root; README.md gives
the layout and how a cell, a configuration, a traffic mix or a metric is
added as files.
"""
