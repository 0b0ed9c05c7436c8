"""Shared pieces of the benchmark's tests: the `card` marker (tests that
need the H100 decide inside the test whether it is there, and skip
without it) and cells of BENCHMARK.json cut to a size the CPU runs in a
second."""

import copy
import time

import pytest
import torch

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the H100; the test looks for it itself and skips without it")


@pytest.fixture
def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: the test runs on the card")
    return torch.device("cuda", 0)


def tiny_cell(name, rows=20_000, features=5_000, batch=1_000):
    """The cell `name` with its table cut to `rows` rows (and a sparse
    table to `features` columns) and its batch to `batch` rows."""
    cell = harness.Cell(harness.benchmark_spec(), name)
    cfg = copy.deepcopy(cell.config)
    cfg["data"]["numValues"] = rows
    if "numFeatures" in cfg["data"]:
        cfg["data"]["numFeatures"] = features
    cfg["estimator"]["params"]["globalBatchSize"] = batch
    cell.config = cfg
    return cell


def run_on_cpu(cell, seed=2**31 + 7, seconds=0.3, trace=False):
    """One run of `cell` on the CPU, the look for a card skipped."""
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
