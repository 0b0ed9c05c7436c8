"""Contract-coverage gates: fusion and checkpoint declarations.

Port of flink_ml_tpu/analysis/rules/coverage.py. Unlike the text rules
these import the package and walk its live class graph: a contract
declared through inheritance is still a declaration, and a source scan
cannot see that. Findings anchor to the class definition line.

Both rules hold the same invariant: an opt-in protocol plus a silent
default gives silently wrong new code, so every concrete class must opt
in or say why not:

- `fusion-coverage`: every concrete `AlgoOperator` overrides
  `transform_kernel` (with `fusable = True`) or declares `fusable =
  False` with a non-empty `fusable_reason`;
- `checkpoint-coverage`: every concrete `Estimator` declares
  `checkpointable`; True needs its module to reference a checkpoint
  funnel (`CHECKPOINT_FUNNELS`), False a non-empty `checkpoint_reason`.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
from typing import Iterable, List, Tuple

from ..engine import PACKAGE, Finding, Rule, register
from ..source import code_only

# the fit-path names through which a fit reaches the JobSnapshot API, as in
# JAX; each exists in the port under that name (models/_linear.py,
# ops/optimizer.py, parallel/iteration.py, ckpt/snapshot.py)
CHECKPOINT_FUNNELS = (
    "run_sgd",
    "optimize_stream",
    "iterate_unbounded",
    "save_job_snapshot",
    "load_job_snapshot",
)


#: module name parts the walk skips: the native libraries' wrappers and the
#: build tree (no stage lives there), and CLI entry points (importing a
#: __main__ runs its CLI)
SKIPPED = ("native", "_build", "__main__")


def _iter_operator_classes(base_name: str):
    """Every concrete subclass of api.<base_name> defined in the package.
    No module of the walk builds a kernel at import: the CUDA sources are
    built inside the functions that launch them."""
    package = importlib.import_module(PACKAGE)
    api = importlib.import_module(f"{PACKAGE}.api")

    base = getattr(api, base_name)
    seen = set()
    for info in pkgutil.walk_packages(package.__path__, PACKAGE + "."):
        if any(part in SKIPPED for part in info.name.split(".")):
            continue
        try:
            module = importlib.import_module(info.name)
        except Exception as e:  # pragma: no cover - import rot is its own bug
            raise RuntimeError(f"cannot import {info.name}: {e!r}") from e
        for _, cls in inspect.getmembers(module, inspect.isclass):
            if (
                issubclass(cls, base)
                and not inspect.isabstract(cls)
                and cls.__module__ == module.__name__
                and cls not in seen
            ):
                seen.add(cls)
                yield cls


def _class_location(project, cls) -> Tuple[str, int]:
    try:
        abspath = inspect.getsourcefile(cls)
        line = inspect.getsourcelines(cls)[1]
    except (TypeError, OSError):  # pragma: no cover
        return PACKAGE, 1
    return os.path.relpath(abspath, project.root).replace("\\", "/"), line


def find_fusion_violations() -> List[Tuple[str, str]]:
    """(qualified class name, problem) pairs."""
    AlgoOperator = importlib.import_module(f"{PACKAGE}.api").AlgoOperator

    violations = []
    for cls in _iter_operator_classes("AlgoOperator"):
        has_kernel = cls.transform_kernel is not AlgoOperator.transform_kernel
        # `fusable` must be declared on the class itself (or an own base
        # that overrode the AlgoOperator default) — inheriting the bare
        # default means nobody made the call for this stage
        declared = any(
            "fusable" in k.__dict__ for k in cls.__mro__[:-1] if k is not AlgoOperator
        )
        name = f"{cls.__module__}.{cls.__name__}"
        if has_kernel:
            if (
                not getattr(cls, "fusable", False)
                and cls.__dict__.get("supports_fusion") is None
                and not declared
            ):
                violations.append(
                    (name, "has transform_kernel but fusable is not declared True")
                )
            continue
        if not declared:
            violations.append(
                (name, "no transform_kernel and no explicit fusable declaration")
            )
            continue
        if getattr(cls, "fusable", False):
            violations.append(
                (name, "fusable = True but transform_kernel is not overridden")
            )
            continue
        reason = getattr(cls, "fusable_reason", "")
        if not isinstance(reason, str) or not reason.strip():
            violations.append(
                (name, "fusable = False without a non-empty fusable_reason")
            )
    return violations


def count_operator_classes() -> int:
    return len(list(_iter_operator_classes("AlgoOperator")))


def find_checkpoint_violations() -> List[Tuple[str, str]]:
    """(qualified class name, problem) pairs."""
    Estimator = importlib.import_module(f"{PACKAGE}.api").Estimator

    violations = []
    for cls in _iter_operator_classes("Estimator"):
        name = f"{cls.__module__}.{cls.__name__}"
        declared = any(
            "checkpointable" in k.__dict__
            for k in cls.__mro__[:-1]
            if k is not Estimator
        )
        if not declared:
            violations.append((name, "no explicit checkpointable declaration"))
            continue
        if getattr(cls, "checkpointable", None):
            if not _module_references_funnel(cls):
                violations.append(
                    (
                        name,
                        "checkpointable = True but its module references no "
                        f"checkpoint funnel ({', '.join(CHECKPOINT_FUNNELS)})",
                    )
                )
            continue
        reason = getattr(cls, "checkpoint_reason", "")
        if not isinstance(reason, str) or not reason.strip():
            violations.append(
                (name, "checkpointable = False without a non-empty checkpoint_reason")
            )
    return violations


def count_estimator_classes() -> int:
    return len(list(_iter_operator_classes("Estimator")))


def _module_references_funnel(cls) -> bool:
    """Funnel references on comment/string-stripped source, so a docstring
    that merely *mentions* `run_sgd` does not satisfy the True contract."""
    path = inspect.getsourcefile(cls)
    if path is None:  # pragma: no cover
        return False
    with open(path) as f:
        code = code_only(f.read())
    return any(funnel in code for funnel in CHECKPOINT_FUNNELS)


class _CoverageRule(Rule):
    finder = None  # staticmethod returning (name, problem) pairs

    def check_project(self, project) -> Iterable[Finding]:
        by_name = {}
        for cls in _iter_operator_classes(self.base_name):
            by_name[f"{cls.__module__}.{cls.__name__}"] = cls
        for name, problem in type(self).finder():
            cls = by_name.get(name)
            path, line = (
                _class_location(project, cls) if cls else (PACKAGE, 1)
            )
            yield Finding(
                path=path,
                line=line,
                rule=self.id,
                message=f"{name}: {problem}",
                data=(name, problem),
            )


@register
class FusionCoverageRule(_CoverageRule):
    id = "fusion-coverage"
    title = "stage does not declare its fusion contract"
    rationale = (
        "The transform-kernel protocol (api.py) is opt-in, so a newly added "
        "stage silently lands on the eager per-stage path — exactly the "
        "per-stage dispatch overhead the fusion planner exists to remove. "
        "Every concrete AlgoOperator must override transform_kernel (with "
        "fusable = True) or set fusable = False with a non-empty "
        "fusable_reason saying WHY it cannot run inside a fused program."
    )
    example = "class MyStage(AlgoOperator):  # neither kernel nor fusable declared"
    base_name = "AlgoOperator"
    finder = staticmethod(find_fusion_violations)


@register
class CheckpointCoverageRule(_CoverageRule):
    id = "checkpoint-coverage"
    title = "estimator does not declare its checkpoint contract"
    rationale = (
        "The JobSnapshot subsystem (ckpt/) makes preemption-safe resume a "
        "property of fit paths routed through it; an estimator that is not "
        "silently loses training progress on any preemption. Every concrete "
        "Estimator must set checkpointable = True (and its module must "
        "actually reference a sanctioned funnel — a bare True with no "
        "wiring is a lie the gate rejects) or False with a non-empty "
        "checkpoint_reason."
    )
    example = "class MyEstimator(Estimator):  # no checkpointable declaration"
    base_name = "Estimator"
    finder = staticmethod(find_checkpoint_violations)
