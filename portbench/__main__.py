"""`python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""

import time

_STARTED_NOW = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def _args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m portbench",
                                     description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float, help="length of the window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: the per-layer metrics, read beside a traced slice")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = _args()
    from portbench import harness

    sys.exit(harness.main(args, min(harness.process_start(), _STARTED_NOW)))
