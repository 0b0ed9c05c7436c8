"""sharding-tags: checkpoint spec tags must be stageable on a mesh.

Port of flink_ml_tpu/analysis/rules/shardingtags.py. A snapshot leaf
carries a sharding-spec tag (`replicated` / `data` / `model` / `host`)
that a RESTORE resolves: `stage_section(mesh=)` places each leaf on this
rank with `parallel/mesh.sharding_for_tag`, and a rank cut's parts are
cut by `shard_axis_for_tag` (parallel/mesh.py and its twin in
ckpt/coordinator.py). `sharding_for_tag` gives any tag it does not know
the replicated placement in silence: a typo restores every rank's whole
leaf where it should have restored a slice, and nothing raises. This
rule holds the chain at the lint step:

1. the literal tag table (`_SPEC_TAGS` in ckpt/snapshot.py) is the one
   source of truth;
2. every non-host tag in it has a `<tag>_sharding` constructor in
   parallel/mesh.py, and every tag that splits a leaf is compared by each
   dispatcher (`sharding_for_tag`, `shard_axis_for_tag` in mesh.py and
   coordinator.py), whose fall-through is the replicated placement;
3. every literal tag at a `save_job_snapshot` / `stage_section` /
   `save_rank_cut` call's `specs=`, and the literal first argument of a
   `sharding_for_tag` / `shard_axis_for_tag` call, names a tag of the table
   (dict KEYS are section names; a local name is followed one assignment
   deep, the `carry_specs` idiom).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name

SNAPSHOT_PATH = f"{PACKAGE}/ckpt/snapshot.py"
MESH_PATH = f"{PACKAGE}/parallel/mesh.py"
COORDINATOR_PATH = f"{PACKAGE}/ckpt/coordinator.py"
SPEC_TABLE_NAME = "_SPEC_TAGS"
#: "host" leaves stay on the host: staged by identity, no mesh constructor
NON_MESH_TAGS = {"host"}
#: the tags whose placement is the dispatchers' fall-through
WHOLE_TAGS = {"replicated", "host"}
#: (path, def name) of the dispatchers a tag reaches at restore
DISPATCHERS = ((MESH_PATH, "sharding_for_tag"), (MESH_PATH, "shard_axis_for_tag"),
               (COORDINATOR_PATH, "shard_axis_for_tag"))
ENTRY_POINTS = ("save_job_snapshot", "stage_section", "save_rank_cut")


def _literal_strings(node: ast.AST) -> Iterable[Tuple[str, int]]:
    """(string, line) for every literal tag of a specs expression, dict
    KEYS skipped (they are section names, not tags)."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            yield node.value, node.lineno
    elif isinstance(node, ast.Dict):
        for value in node.values:
            yield from _literal_strings(value)
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for elt in node.elts:
            yield from _literal_strings(elt)
    elif isinstance(node, ast.BinOp):  # ("replicated",) * len(x)
        yield from _literal_strings(node.left)
        yield from _literal_strings(node.right)
    elif isinstance(node, ast.IfExp):
        yield from _literal_strings(node.body)
        yield from _literal_strings(node.orelse)
    elif isinstance(node, ast.Starred):
        yield from _literal_strings(node.value)


def _spec_table(snapshot_module: SourceModule) -> Tuple[Set[str], int]:
    """The _SPEC_TAGS literals and the line they are declared on."""
    if snapshot_module.tree is not None:
        for node in snapshot_module.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == SPEC_TABLE_NAME):
                return {s for s, _ in _literal_strings(node.value)}, node.lineno
    return set(), 1


def _compared_tags(fn: ast.AST) -> Set[str]:
    """The string literals a dispatcher compares its tag against."""
    tags: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Compare):
            for comp in [sub.left] + list(sub.comparators):
                if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
                    tags.add(comp.value)
    return tags


def _module_def(module: SourceModule, name: str):
    if module is None or module.tree is None:
        return None
    return next((n for n in module.tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == name), None)


def _mesh_constructors(mesh_module: SourceModule) -> Set[str]:
    """Tags for which parallel/mesh.py defines `<tag>_sharding`."""
    if mesh_module.tree is None:
        return set()
    return {n.name[: -len("_sharding")] for n in mesh_module.tree.body
            if isinstance(n, ast.FunctionDef) and n.name.endswith("_sharding")}


@register
class ShardingTagRule(Rule):
    id = "sharding-tags"
    title = "checkpoint sharding tag is not stageable"
    rationale = (
        "Snapshot leaf tags are resolved by parallel/mesh.py's sharding_for_tag "
        "at RESTORE time, and it places any tag it does not know replicated in "
        "silence: a typo restores every rank's whole leaf where a slice was "
        "meant, discovered only when the original fit is gone. The tag table, "
        "the mesh constructors, the dispatchers and every literal tag at a "
        "save/stage call site must agree."
    )
    example = 'save_job_snapshot(..., specs={"model": "fully_sharded"}, mesh=mesh)'
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        snapshot_module = project.module_at(SNAPSHOT_PATH)
        mesh_module = project.module_at(MESH_PATH)
        if snapshot_module is None or mesh_module is None:
            return  # the subsystem is absent: nothing to hold consistent
        tags, table_line = _spec_table(snapshot_module)
        if not tags:
            yield Finding(
                path=SNAPSHOT_PATH, line=table_line, rule=self.id,
                message=(f"cannot locate the literal {SPEC_TABLE_NAME} spec table: the "
                         "sharding-tag consistency chain is unanchored"))
            return
        constructors = _mesh_constructors(mesh_module) | NON_MESH_TAGS
        for tag in sorted(tags):
            if tag not in constructors:
                yield Finding(
                    path=MESH_PATH, line=1, rule=self.id,
                    message=(f"spec tag {tag!r} (ckpt/snapshot.py {SPEC_TABLE_NAME}) has no "
                             f"{tag}_sharding constructor in parallel/mesh.py: no mesh can "
                             "place it"),
                    data=(tag,))
        for path, name in DISPATCHERS:
            fn = _module_def(project.module_at(path), name)
            if fn is None:
                continue
            dispatched = _compared_tags(fn) | WHOLE_TAGS
            for tag in sorted(tags - dispatched):
                yield Finding(
                    path=SNAPSHOT_PATH, line=table_line, rule=self.id,
                    message=(f"spec tag {tag!r} is in {SPEC_TABLE_NAME} but {name} "
                             f"({path.split('/', 1)[1]}) never dispatches it: a restore "
                             "would place it replicated in silence"),
                    data=(tag,))
        for module in project.modules:
            if module.tree is not None:
                yield from self._check_call_sites(module, tags)

    def _check_call_sites(self, module: SourceModule, tags: Set[str]) -> Iterable[Finding]:
        local_literals: Dict[str, List[Tuple[str, int]]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                found = list(_literal_strings(node.value))
                if found:
                    local_literals[node.targets[0].id] = found
        dispatchers = {name for _, name in DISPATCHERS}
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = (dotted_name(node.func) or "").split(".")[-1]
            candidates: List[Tuple[str, int]] = []
            if name in dispatchers and node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                candidates.append((node.args[0].value, node.args[0].lineno))
            elif name in ENTRY_POINTS:
                for kw in node.keywords:
                    if kw.arg != "specs":
                        continue
                    value = kw.value
                    if isinstance(value, ast.Name):
                        candidates += local_literals.get(value.id, [])
                    else:
                        candidates += list(_literal_strings(value))
                    if isinstance(value, ast.Dict):
                        for v in value.values:
                            if isinstance(v, ast.Name):
                                candidates += local_literals.get(v.id, [])
            for tag, line in candidates:
                if tag not in tags:
                    yield Finding(
                        path=module.path, line=line, rule=self.id,
                        message=(f"unknown sharding-spec tag {tag!r}: not in ckpt/snapshot.py "
                                 f"{SPEC_TABLE_NAME} ({', '.join(sorted(tags))}); "
                                 "sharding_for_tag would place it replicated in silence"),
                        data=(tag,))
