"""spec-consistency: a ranked body's layout must tell one story.

Port of flink_ml_tpu/analysis/rules/specconsistency.py. The JAX rule
holds a `shard_map`'s `out_specs` claim against its body; the port has no
such claim beside a body, so it holds the claims its idiom makes
(analysis/spmd.py):

- **unreduced-output**: a ranked body called from outside any ranked body
  (the estimator's entry) returns what every rank keeps, so it is claimed
  uniform over every axis but those a `fleet_sharding` /
  `model_sharding` placement declared on it; and a rank cut's leaf tagged
  `replicated` (`save_job_snapshot` / `save_rank_cut` with a mesh) is read
  back from rank 0's part. A value that still varies publishes one rank's
  partial as the result;
- **double-reduce**: a reduce over an axis the operand is already uniform
  on multiplies it by the axis's size (a reduce over `mesh.flatten(mesh)`'s
  `data` reduces over every axis: a value uniform along `model` is
  counted once per model shard, the shape of ROADMAP C.36). A constant
  fill made on every rank (the zero carry a loop reduces first) adds
  nothing twice;
- **cross-member-reduce**: an adding reduce over `data` of a
  fleet-sharded value (`fleet_sharding`'s `data` is the member axis):
  it adds different members' values together.

The JAX `spec-arity` finding (an `in_specs` list whose length differs
from the body's parameters) has no counterpart: the port binds a ranked
body's parameters at its call sites, where Python checks the count
(ROADMAP C.37). Unknown values suppress findings.
"""

from __future__ import annotations

from typing import Iterable

from .. import spmd
from ..engine import PACKAGE, Finding, Rule, register


@register
class SpecConsistencyRule(Rule):
    id = "spec-consistency"
    title = "ranked body's layout inconsistent with its reductions"
    rationale = (
        "A ranked body's result is a claim nothing checks at run time: a "
        "per-rank partial returned to the estimator publishes one rank's "
        "partial as the global result, a reduce of an already-uniform operand "
        "multiplies it by the rank count (double-counting), and a sum over a "
        "fleet-sharded value adds different members together; all three are "
        "silent numeric corruption. The interpreter carries the layout from "
        "the call sites through the body, so each is caught at lint time."
    )
    example = "return collectives.all_reduce_sum(collectives.all_reduce_sum(g, DATA_AXIS, mesh))"
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        interp = spmd.interpretation(project)
        for event in interp.of_kind("unreduced-output"):
            if not self.applies_to(event.path):
                continue
            axes = ", ".join(event.extra[0]) if event.extra else "?"
            site_line = event.extra[1] if len(event.extra) > 1 else "?"
            yield Finding(
                path=event.path, line=event.line, rule=self.id,
                message=(f"result of {event.detail}() still varies over axis ({axes}) but "
                         f"the claim at line {site_line} says every rank keeps the same "
                         "value: one rank's partial is published as the global result; "
                         "reduce it (all_reduce_sum / all_gather) first, or place it "
                         "with fleet_sharding / model_sharding"),
                data=("unreduced-output", event.detail) + tuple(event.extra[:1]))
        for event in interp.of_kind("double-reduce"):
            if not self.applies_to(event.path):
                continue
            axis = event.extra[0] if event.extra else "?"
            yield Finding(
                path=event.path, line=event.line, rule=self.id,
                message=(f"{event.detail} over axis {axis!r} but the operand is already "
                         "uniform along that axis: the reduction multiplies it by the "
                         "axis size (double-counting); drop the redundant reduce, or "
                         "split the rows over that axis too (mesh.flatten)"),
                data=("double-reduce", event.detail, axis))
        for event in interp.of_kind("cross-member-reduce"):
            if not self.applies_to(event.path):
                continue
            yield Finding(
                path=event.path, line=event.line, rule=self.id,
                message=(f"{event.detail} over 'data' of a fleet-sharded value: "
                         "fleet_sharding's data axis holds different members, so the "
                         "sum adds one member's state into another's; gather the members "
                         "(all_gather) or reduce each member's own rows"),
                data=("cross-member-reduce", event.detail))
