"""No process of the benchmark may load JAX or the JAX package: the check
compares each module's top-level name whole, so the port, whose name
begins with the JAX package's, passes."""

import ast
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent


@pytest.mark.parametrize("module", ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax",
                                    "flink_ml_tpu", "flink_ml_tpu.ops.optimizer"])
def test_catches_jax_and_the_jax_package(module):
    assert harness.forbidden_modules(["torch", "flink_ml_tpu_torch", module]) == \
        [module.split(".")[0]]


def test_lets_the_port_through():
    assert harness.forbidden_modules(["flink_ml_tpu_torch", "flink_ml_tpu_torch.ops",
                                      "flink_ml_tpux", "jaxtyping"]) == []


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    for path in ROOT.rglob("*.py"):
        assert not _imports(path) & harness.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert not _imports(path) & (harness.FORBIDDEN | {"flink_ml_tpu_torch"}), path
        assert "flink_ml_tpu" not in path.read_text().replace("flink_ml_tpu_torch", "")
