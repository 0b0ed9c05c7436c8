"""The port's contract-coverage gates (fusion-coverage,
checkpoint-coverage: flink_ml_tpu_torch/analysis/rules/coverage.py)
against the JAX package's.

Both gates import their package and walk its live class graph. Held:

- both packages' gates return no violation, and the port's rules raise no
  finding on the tree;
- they walk the same 47 concrete AlgoOperator and 24 concrete Estimator
  classes (by module path inside the package and class name);
- each class's `fusable`, whether its `fusable_reason` is non-empty, and
  its `checkpointable` equal its JAX twin's;
- an undeclared subclass made here is flagged by both packages' gates,
  with the same problem, and the port's rule anchors it at its class
  line;
- the walk imports no JAX and no module of the JAX package.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import pytest

from flink_ml_tpu import api as jax_api
from flink_ml_tpu.analysis.rules import coverage as jax_coverage
from flink_ml_tpu_torch import api as port_api
from flink_ml_tpu_torch.analysis import engine
from flink_ml_tpu_torch.analysis.rules import coverage

REPO = Path(__file__).resolve().parent.parent
N_OPERATORS, N_ESTIMATORS = 47, 24


def _by_name(module, base, package):
    return {f"{c.__module__[len(package) + 1:]}.{c.__name__}": c
            for c in module._iter_operator_classes(base)}


@pytest.fixture(scope="module")
def classes():
    return {base: (_by_name(coverage, base, "flink_ml_tpu_torch"),
                   _by_name(jax_coverage, base, "flink_ml_tpu"))
            for base in ("AlgoOperator", "Estimator")}


def test_both_gates_are_clean():
    assert coverage.find_fusion_violations() == []
    assert coverage.find_checkpoint_violations() == []
    assert jax_coverage.find_fusion_violations() == []
    assert jax_coverage.find_checkpoint_violations() == []


@pytest.mark.parametrize("rule", ["fusion-coverage", "checkpoint-coverage"])
def test_the_port_rules_raise_nothing_on_the_tree(rule):
    report = engine.run(rules=[engine.get_rule(rule)])
    assert [f for f in report.findings if f.rule == rule] == []


@pytest.mark.parametrize("base,count", [("AlgoOperator", N_OPERATORS),
                                        ("Estimator", N_ESTIMATORS)])
def test_the_same_classes_are_walked(classes, base, count):
    port, ref = classes[base]
    assert sorted(port) == sorted(ref)
    assert len(port) == count
    assert coverage.count_operator_classes() == N_OPERATORS
    assert coverage.count_estimator_classes() == N_ESTIMATORS


def test_each_fusion_declaration_equals_its_jax_twin(classes):
    port, ref = classes["AlgoOperator"]
    for name, cls in port.items():
        twin = ref[name]
        assert bool(cls.fusable) == bool(twin.fusable), name
        assert bool(str(cls.fusable_reason).strip()) == bool(str(twin.fusable_reason).strip()), name


def test_each_checkpoint_declaration_equals_its_jax_twin(classes):
    port, ref = classes["Estimator"]
    for name, cls in port.items():
        assert cls.checkpointable == ref[name].checkpointable, name


def test_the_funnels_are_the_jax_names_and_exist_in_the_port():
    assert coverage.CHECKPOINT_FUNNELS == jax_coverage.CHECKPOINT_FUNNELS
    homes = {"run_sgd": "models/_linear.py", "optimize_stream": "ops/optimizer.py",
             "iterate_unbounded": "parallel/iteration.py",
             "save_job_snapshot": "ckpt/snapshot.py", "load_job_snapshot": "ckpt/snapshot.py"}
    for funnel, home in homes.items():
        assert f"def {funnel}(" in (REPO / "flink_ml_tpu_torch" / home).read_text(), funnel


class _PortSilent(port_api.Transformer):
    def transform(self, *inputs):
        return list(inputs)


class _JaxSilent(jax_api.Transformer):
    def transform(self, *inputs):
        return list(inputs)


class _PortUndeclared(port_api.Estimator):
    def fit(self, *inputs):
        return None


class _JaxUndeclared(jax_api.Estimator):
    def fit(self, *inputs):
        return None


def test_an_undeclared_subclass_is_flagged_by_both(monkeypatch):
    planted = {("port", "AlgoOperator"): _PortSilent, ("port", "Estimator"): _PortUndeclared,
               ("jax", "AlgoOperator"): _JaxSilent, ("jax", "Estimator"): _JaxUndeclared}
    monkeypatch.setattr(coverage, "_iter_operator_classes",
                        lambda base: iter([planted[("port", base)]]))
    monkeypatch.setattr(jax_coverage, "_iter_operator_classes",
                        lambda base: iter([planted[("jax", base)]]))
    port = coverage.find_fusion_violations() + coverage.find_checkpoint_violations()
    ref = jax_coverage.find_fusion_violations() + jax_coverage.find_checkpoint_violations()
    assert [p for _, p in port] == [p for _, p in ref] == [
        "no transform_kernel and no explicit fusable declaration",
        "no explicit checkpointable declaration"]
    findings = list(coverage.FusionCoverageRule().check_project(engine.Project(root=str(REPO))))
    line = inspect.getsourcelines(_PortSilent)[1]
    assert [(f.path, f.line, f.rule) for f in findings] == [
        ("tests/test_torch_tpulint_coverage.py", line, "fusion-coverage")]


def test_the_walk_imports_no_jax():
    code = ("import sys\n"
            "from flink_ml_tpu_torch.analysis.rules import coverage\n"
            "assert coverage.count_operator_classes() == 47\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flink_ml_tpu.'))]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
