"""The port stands alone and does not hide the device.

- `import flink_ml_tpu_torch` pulls in no JAX;
- no module of the port, and neither chip_smoke.py nor
  scripts/torch_kernel_designs.py, imports jax or flink_ml_tpu;
- an entry point that was not asked for the CPU raises without a card,
  rather than falling back to the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch import SparseBatch, Table, config
from flink_ml_tpu_torch.models.classification.logisticregression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from flink_ml_tpu_torch.table import StreamTable

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "flink_ml_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_kernel_designs.py"]


def test_import_leaves_jax_out():
    code = (
        "import sys, flink_ml_tpu_torch\n"
        "import flink_ml_tpu_torch.models.classification.logisticregression\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flink_ml_tpu' or m.startswith('flink_ml_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "flink_ml_tpu"}, roots


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data():
    rng = np.random.default_rng(0)
    return rng.random((40, 3)), (rng.random(40) > 0.5).astype(np.float64)


def test_device_raises_without_card_or_cpu_request(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        config.device()
    with config.use_device("cpu") as dev:
        assert config.device() == dev == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        config.device()


def test_fit_raises_without_card_or_cpu_request(no_card):
    X, y = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        LogisticRegression().fit(Table({"features": X, "label": y}))


def test_transform_raises_without_card_or_cpu_request(no_card):
    X, _ = _data()
    model = LogisticRegressionModel()
    model.coefficient = np.ones(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.transform(Table({"features": X}))
    sparse = SparseBatch(3, np.zeros((40, 2), np.int32), np.ones((40, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.transform(Table({"features": sparse}))


def test_use_device_cuda_refuses_without_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        with config.use_device("cuda"):
            pass


def test_stream_table_is_a_later_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamTable([])


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line where there
    is no CUDA card (as here)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
