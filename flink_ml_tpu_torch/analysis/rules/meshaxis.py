"""mesh-axis: every collective axis name must exist and ride a constant.

Port of flink_ml_tpu/analysis/rules/meshaxis.py. An axis-name typo does
not fail at once: `all_reduce_sum(x, "dta")` raises only when a rank
reaches it on a mesh of ranks (collectives._axis), and a valid but wrong
axis (`MODEL_AXIS` where `DATA_AXIS` was meant) reduces over the wrong
sub-group of the world in silence. The rule leans on the SPMD layer
(`analysis/spmd.py`):

1. **unknown axis**: an axis literal at a collective call, in a
   `RankSharding` spec, in `create_mesh(axis_names=)` / `Mesh(...)`, or at
   `mesh.axis_index` / `mesh.axis_group`, that no `*_AXIS` constant of
   parallel/mesh.py declares;
2. **constant bypass**: a literal that duplicates a constant (`"data"`
   for `DATA_AXIS`): an axis rename would miss it;
3. **unsharded collective**: a gather or ring shift over an axis the
   operand does not vary on (the interpreter carries the layout from the
   ranked body's call sites): the collective moves bytes to replicate
   what every rank already holds, or the layout is wrong.
"""

from __future__ import annotations

from typing import Iterable

from .. import spmd
from ..engine import PACKAGE, Finding, Rule, register


@register
class MeshAxisRule(Rule):
    id = "mesh-axis"
    title = "collective/spec axis name unknown, literal, or unsharded"
    rationale = (
        "An axis-name typo surfaces only when a rank reaches the collective "
        "on a mesh of ranks, and a valid-but-wrong axis reduces over the wrong "
        "sub-group of the world in silence. Axis names are declared ONCE as "
        "*_AXIS constants in parallel/mesh.py; every collective call, "
        "RankSharding spec, mesh construction and axis_index must use the "
        "constants (a literal would survive an axis rename), name a declared "
        "axis, and gather/shift only over axes the operand is sharded on."
    )
    example = 'grad = collectives.all_reduce_sum(grad, "dta", mesh)  # unknown axis, literal'
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        interp = spmd.interpretation(project)
        reg = spmd.axis_registry(project)
        known = ", ".join(sorted(reg.known_axes)) or "<none declared>"
        for event in interp.of_kind("unknown-axis"):
            if self.applies_to(event.path):
                yield Finding(
                    path=event.path, line=event.line, rule=self.id,
                    message=(f"axis name {event.detail!r} is not declared by any *_AXIS "
                             f"constant in parallel/mesh.py (known: {known}): a rank that "
                             "reaches it raises, or reduces over the wrong sub-group"),
                    data=("unknown-axis", event.detail))
        for event in interp.of_kind("axis-bypass"):
            if self.applies_to(event.path):
                const = event.extra[0] if event.extra else ""
                yield Finding(
                    path=event.path, line=event.line, rule=self.id,
                    message=(f"string literal {event.detail!r} bypasses the "
                             f"{const or '*_AXIS'} constant (parallel/mesh.py): an axis "
                             "rename would miss this site; import the constant instead"),
                    data=("axis-bypass", event.detail, const))
        for event in interp.of_kind("unsharded-collective"):
            if self.applies_to(event.path):
                axis = event.extra[0] if event.extra else "?"
                yield Finding(
                    path=event.path, line=event.line, rule=self.id,
                    message=(f"{event.detail} over axis {axis!r} but the operand is not "
                             "sharded on that axis (per the layout its ranked body was "
                             "called with): the collective replicates a replica, wasted "
                             "wire bytes or a wrong sharding"),
                    data=("unsharded-collective", event.detail, axis))
