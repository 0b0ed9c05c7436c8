"""precision-determinism: narrowing casts, unsanctioned folds and atomics.

Port of flink_ml_tpu/analysis/rules/precision.py. Three ways a
distributed sum stops being the number the math says, or stops being the
same number on every rank:

1. **A narrowing cast before a reduce.** `.to(torch.bfloat16)`,
   `.half()` or `.bfloat16()` (or an 8-bit type) upstream of an
   all-reduce makes every addend lose mantissa before the sum. Reduce in
   the operand's dtype and narrow the result.
2. **A fold outside the sanctioned ring.** The replica-order folds of
   parallel/collectives.py (`_reduce_bucket_ring`) and parallel/overlap.py
   add the ranks' contributions in one fixed order; a Python loop
   elsewhere that accumulates ring-shifted tensors reassociates the sum.
3. **An atomics scatter of a gathered value** (ROADMAP C.30). In a
   ranked body a value that is the same on every rank because it came out
   of a gather, scattered through an atomics kernel (`sparse_grad`,
   `fleet_grad`: their float atomics add in whatever order the card runs
   them), gives each rank other last bits, and the ranks' models drift
   apart. `collectives.scatter_pairs` (`index_put_(accumulate=True)`,
   whose additions run in a fixed order) is the sanctioned form; the
   kernel is fine on a rank's own rows when a reduce follows, as the 2D
   loss does.
"""

from __future__ import annotations

from typing import Iterable

from .. import spmd
from ..engine import PACKAGE, Finding, Rule, register


@register
class PrecisionDeterminismRule(Rule):
    id = "precision-determinism"
    title = "narrowing cast before a reduction / unsanctioned fold order / atomics"
    rationale = (
        "A cast to bf16/f16 upstream of an all-reduce makes every addend lose "
        "mantissa BEFORE the sum; a manual loop accumulating ring-shifted "
        "tensors outside parallel/collectives.py reassociates the reduction; "
        "and a gathered value scattered through an atomics kernel gives each "
        "rank other bits, so ranks that must agree drift apart (C.30). Reduce "
        "in the operand dtype, fold beside _reduce_bucket_ring, and scatter "
        "gathered pairs with collectives.scatter_pairs."
    )
    example = "total = collectives.all_reduce_sum(grad.to(torch.bfloat16), DATA_AXIS, mesh)"
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        interp = spmd.interpretation(project)
        for event in interp.of_kind("downcast-before-reduce"):
            if self.applies_to(event.path):
                dtype = event.extra[0] if event.extra else "?"
                yield Finding(
                    path=event.path, line=event.line, rule=self.id,
                    message=(f"operand of {event.detail} was narrowed to {dtype} before "
                             "the reduction: every addend loses mantissa before the sum; "
                             "reduce in the operand's dtype (or wider) and cast the "
                             "reduced result instead"),
                    data=("downcast", event.detail, dtype))
        for event in interp.of_kind("order-fold"):
            if self.applies_to(event.path):
                loop_line = event.extra[0] if event.extra else "?"
                yield Finding(
                    path=event.path, line=event.line, rule=self.id,
                    message=(f"loop at line {loop_line} accumulates ring-shifted tensors: "
                             "a hand-written fold outside the replica-order folds of "
                             "parallel/collectives.py; its association differs from the "
                             "all-reduce's. Build on _reduce_bucket_ring or add the new "
                             "schedule beside it"),
                    data=("order-fold", event.detail))
        for event in interp.of_kind("atomic-scatter"):
            if self.applies_to(event.path):
                yield Finding(
                    path=event.path, line=event.line, rule=self.id,
                    message=(f"a gathered value, the same on every rank, goes through the "
                             f"atomics kernel {event.detail}: its float atomics add in the "
                             "card's order, so each rank gets other bits and the ranks "
                             "drift apart (ROADMAP C.30); scatter with "
                             "collectives.scatter_pairs"),
                    data=("atomic-scatter", event.detail))
