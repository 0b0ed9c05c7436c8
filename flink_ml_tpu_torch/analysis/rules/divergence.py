"""collective-divergence: collectives under rank-varying control flow.

Port of flink_ml_tpu/analysis/rules/divergence.py. A collective completes
only when every rank of its group issues it. In a ranked body (a per-rank
loop of the port, parallel/mesh.py) a branch whose condition varies per
rank (a test on `mesh.rank` or `mesh.axis_index`, on the rank's own rows,
a loop whose trip count is per-rank data) lets some ranks reach the
collective while others skip it: the ranks that arrive wait until the
collective timeout and the world dies, with no number to debug.

The static detector is the interpreter's divergence context: entering an
`if`/`while`/`for` (or a comprehension) whose test varies per rank marks
the region, and any collective reached inside it, a raw
`torch.distributed` one too, is flagged with the collective's line and
the branch's. The dynamic dual is the sanitizer's collective-sequence
ledger (`analysis/sanitizer.py`, `compare_rank_sequences`): it records
each rank's (op, axis, shape, dtype) sequence and compares the ranks
after a run, so each side covers the other's blind spot.

The sanctioned shape: the collective's STRUCTURE the same on every rank,
its contribution data-dependent (weight 0, zero padding: the padded-batch
convention), or rank 0's work done inside the branch and its outcome
broadcast outside it.
"""

from __future__ import annotations

from typing import Iterable

from .. import spmd
from ..engine import PACKAGE, Finding, Rule, register


@register
class CollectiveDivergenceRule(Rule):
    id = "collective-divergence"
    title = "collective reachable under a rank-varying branch"
    rationale = (
        "A collective completes only when every rank of its group issues it; "
        "a branch that varies per rank (mesh.rank or axis_index tests, "
        "conditions on the rank's rows, data-dependent loop trip counts) lets "
        "some ranks skip it, and the others wait until the collective timeout "
        "kills the world. Keep the collective STRUCTURE uniform and make the "
        "contribution data-dependent (mask with weight 0 / zero padding), or "
        "broadcast rank 0's outcome outside the branch."
    )
    example = ("if mesh.axis_index(DATA_AXIS) == 0:\n"
               "    x = collectives.all_reduce_sum(x, DATA_AXIS, mesh)")
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        interp = spmd.interpretation(project)
        for event in interp.of_kind("divergent-collective"):
            if not self.applies_to(event.path):
                continue
            branch_line = event.extra[0] if event.extra else "?"
            reason = event.extra[1] if len(event.extra) > 1 else "rank-varying branch"
            axis = event.extra[2] if len(event.extra) > 2 else "?"
            yield Finding(
                path=event.path, line=event.line, rule=self.id,
                message=(f"{event.detail} over axis {axis!r} is reachable only under the "
                         f"branch at line {branch_line} ({reason}): ranks that take the "
                         "other arm never issue the collective, which hangs the world; "
                         "issue it unconditionally and mask the contribution instead"),
                data=("divergent", event.detail, branch_line))
