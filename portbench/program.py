"""The system under test, as the benchmark reaches it: the port's public
estimators and tables, its counter registry and its device scope.

This is the only module of the benchmark that imports the program
(`flink_ml_tpu_torch`), and it imports it when a run starts, never when
the module is imported: a checkout without the program fails at that
point, before any result is printed.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict

PACKAGE = "flink_ml_tpu_torch"


def _pkg(module: str):
    return importlib.import_module(f"{PACKAGE}.{module}")


def device_scope(device):
    """The program's device choice for the block: the card by default, the
    CPU under `config.use_device` (the CPU tests)."""
    if device is None or device.type == "cuda":
        return contextlib.nullcontext()
    return _pkg("config").use_device(device)


def estimator(class_path: str, params: Dict):
    """An estimator of the program by its module path, its params set by
    their Flink ML JSON names."""
    module, _, name = class_path.rpartition(".")
    if not module.startswith(PACKAGE + "."):
        raise ValueError(f"estimator {class_path!r} is not a class of {PACKAGE}")
    est = getattr(importlib.import_module(module), name)()
    for key, value in params.items():
        param = est.get_param(key)
        if param is None:
            raise KeyError(f"{class_path} has no param {key!r}")
        est.set(param, param.json_decode(value))
    return est


def table(columns: Dict):
    """A program Table of device columns."""
    return _pkg("table").Table(columns)


def sparse_column(size: int, indices, values):
    """A padded-CSR features column (the program's SparseBatch)."""
    return _pkg("table").SparseBatch(size, indices, values)


def counters_snapshot() -> Dict:
    """The program's timers and counters (`utils.metrics.snapshot`)."""
    return _pkg("utils.metrics").snapshot()


def counters_delta(before: Dict, after: Dict) -> Dict:
    return _pkg("utils.metrics").snapshot_delta(before, after)
