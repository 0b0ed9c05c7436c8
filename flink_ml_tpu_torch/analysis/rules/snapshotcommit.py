"""snapshot-commit: durable writes in ckpt/ must ride the atomic commit.

Port of flink_ml_tpu/analysis/rules/snapshotcommit.py. The checkpoint
subsystem's correctness rests on one invariant: a reader never observes a
torn file, because every durable publish is the temp-file-then-
`os.replace` unit of `ckpt/coordinator.atomic_commit`, with the fault
tick between payload and rename (so torn writes stay fault-injectable)
and `flow.with_retries` around the whole unit (so a transient I/O error
re-runs an unobservable sequence). A raw write beside the helper forfeits
atomicity, retryability and the fault matrix's kill sites.

The rule flags, in any module under a `ckpt/` directory:

- `os.replace` and `os.rename` calls;
- `np.savez`, `np.save`, `np.savez_compressed` and `torch.save` calls;
- `json.dump` calls and write-mode builtin `open(...)` calls;

unless the call is part of the commit machinery: inside the
`atomic_commit` helper itself, inside an `atomic_commit(...)` call (the
inline `lambda tmp: np.savez(tmp, ...)` payload), or inside a function
whose name is referenced in an `atomic_commit(...)` call of the same
module (a named payload writer such as `_dump_json`).

Reads, deletes (`os.remove`: collection is not a commit) and writes
outside ckpt/ are not this rule's business. A deliberate exception takes
`# tpulint: disable=snapshot-commit -- <why atomicity is not needed>`.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name

COMMIT_HELPER = "atomic_commit"

#: numpy savers that produce durable payload files
_NP_WRITERS = ("savez", "save", "savez_compressed")


def _in_ckpt(path: str) -> bool:
    return "ckpt" in path.split("/")[:-1]


def _write_call_kind(node: ast.Call) -> str:
    """A short label when `node` is a durable-write call, else ''."""
    name = dotted_name(node.func)
    if name is None:
        return ""
    if name in ("os.replace", "os.rename"):
        return name
    root, _, rest = name.partition(".")
    if root in ("np", "numpy") and rest in _NP_WRITERS:
        return name
    if name in ("json.dump", "torch.save"):
        return name
    if name == "open":
        mode = None
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        if isinstance(mode, str) and any(c in mode for c in "wax+"):
            return f"open(..., {mode!r})"
    return ""


def _sanctioned_nodes(module: SourceModule) -> Set[int]:
    """ids of AST nodes inside the commit machinery: the helper's own
    def, every `atomic_commit(...)` call subtree, and the defs of
    functions referenced inside those calls (named payload writers)."""
    sanctioned: Set[int] = set()
    payload_names: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == COMMIT_HELPER:
                for sub in ast.walk(node):
                    sanctioned.add(id(sub))
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None and name.split(".")[-1] == COMMIT_HELPER:
                for sub in ast.walk(node):
                    sanctioned.add(id(sub))
                    if isinstance(sub, ast.Name):
                        payload_names.add(sub.id)
    if payload_names:
        for node in ast.walk(module.tree):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in payload_names
            ):
                for sub in ast.walk(node):
                    sanctioned.add(id(sub))
    return sanctioned


@register
class SnapshotCommitRule(Rule):
    id = "snapshot-commit"
    title = "durable write in ckpt/ outside the atomic commit helper"
    rationale = (
        "Every durable file publish in the checkpoint subsystem must be "
        "the coordinator's temp+os.replace atomic_commit unit: it is what "
        "keeps torn writes unobservable to readers, transient faults "
        "retryable (the whole unit re-runs), and the chaos harness able "
        "to kill mid-commit (the fault tick lives inside it). A raw "
        "multi-file write sequence beside it is an unprotected, "
        "un-chaos-tested commit path."
    )
    example = 'torch.save(state, tmp); os.replace(tmp, target)  # in ckpt/'
    scope = (PACKAGE,)

    def check_module(self, project, module: SourceModule) -> Iterable[Finding]:
        if module.tree is None or not _in_ckpt(module.path):
            return ()
        sanctioned = _sanctioned_nodes(module)
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or id(node) in sanctioned:
                continue
            kind = _write_call_kind(node)
            if not kind:
                continue
            findings.append(
                Finding(
                    path=module.path,
                    line=node.lineno,
                    rule=self.id,
                    message=(
                        f"{kind} writes a durable checkpoint file outside "
                        f"the {COMMIT_HELPER} temp+replace unit — torn "
                        "writes become observable, transient faults are "
                        "not retried as a unit, and the fault matrix has "
                        "no kill site inside this sequence; route it "
                        f"through coordinator.{COMMIT_HELPER}"
                    ),
                    data=("write", kind),
                )
            )
        return findings
