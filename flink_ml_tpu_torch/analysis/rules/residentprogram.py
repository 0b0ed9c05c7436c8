"""resident-program: host work inside a captured body.

Port of flink_ml_tpu/analysis/rules/residentprogram.py. A whole fit or a
fused segment runs as one captured CUDA graph (utils/lazyjit.py): its
Python runs once, at the capture, and every later call replays only the
card's work. Host work inside the body breaks that: a sync faults the
capture (a stream being captured cannot be waited on), and a Python
branch on a device value reads the value once and freezes the branch it
took into the graph, so every replay takes it whatever the data. The
rule flags, in a captured body,

- a host sync of `analysis/callgraph.py` (`.item()`, `.tolist()`,
  `.cpu()`, `.numpy()`, `float`/`int`/`bool` of a device value, a barrier);
- a device value as an `if`/`while`/`assert` test (a frozen branch);
- `print` of a device value.

The captured bodies come from `rules/_jitindex.py`: a `lazy_jit`
kernel's function (the decorated def, or `_impl` of `NAME =
lazy_jit(_impl, ...)`), a `keyed_jit` factory's returned defs, the body
given to `capture(pool, body)`, and every `transform_kernel` method (the
transform-kernel protocol that `pipeline.FusedSegment` captures). A
body's tensor parameters are on the card; its static arguments (and a
transform kernel's `ctx`) are not. A helper the body passes a device
value to is judged by its summary (the finding names the chain); every
function reachable from a body is also checked for syncs of tensors it
makes on the card itself (following resolved calls only: a body's
attribute calls are mostly tensor methods, which name-based lifting would
send to unrelated methods of the package).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from .. import callgraph
from ..engine import PACKAGE, Finding, Rule, register
from . import _jitindex

#: a transform kernel's parameters that hold host state, not device values
HOST_PARAMS = ("ctx",)

_KIND_TEXT = {
    "pull": "syncs the host inside the capture (a capture cannot wait on its stream)",
    "cast": "syncs the host inside the capture (a capture cannot wait on its stream)",
    "barrier": "waits on the card inside the capture (a capture cannot wait on its stream)",
    "branch": "branches in Python on a device value: the capture freezes the branch it took",
    "print": "prints a device value: a sync, and host work that only the capture runs",
}


def captured_bodies(project, graph) -> List[Tuple[callgraph.FunctionDecl, Tuple[str, ...]]]:
    """(decl, static argument names) of every captured body."""
    out = []
    for module in project.modules:
        if module.tree is None:
            continue
        info = _jitindex.jit_index(project)[module.path]
        declared = {id(d.node): d for d in graph.decls_in(module.path).values()}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and item.name == _jitindex.TRANSFORM_KERNEL):
                        decl = declared.get(id(item))
                        if decl is not None:
                            out.append((decl, HOST_PARAMS))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in info.bodies:
                decl = declared.get(id(node)) or graph.decl(module, node, node.name, False)
                out.append((decl, info.bodies[node.name]))
    return out


@register
class ResidentProgramRule(Rule):
    id = "resident-program"
    title = "host work inside a captured (whole-fit or fused) program body"
    rationale = (
        "A captured body's Python runs once, at the capture; replays run "
        "only the card's work. A sync (.item(), .tolist(), .cpu(), float() "
        "of a device value, a synchronize) faults the capture, and a Python "
        "branch on a device value is read once and frozen into the graph, so "
        "every replay takes that branch whatever the data. Keep captured "
        "bodies free of host work: register a guard (KernelContext.guard) or "
        "compute with torch.where, or suppress WITH the reason it is safe."
    )
    example = "if loss.item() < tol: break  # inside a lazy_jit body"
    scope = (PACKAGE,)
    exclude = (f"{PACKAGE}/analysis",)

    def check_project(self, project) -> Iterable[Finding]:
        graph = callgraph.get(project)
        findings: Dict[Tuple[str, int, str], Finding] = {}
        bodies = captured_bodies(project, graph)
        for decl, statics in bodies:
            if not self.applies_to(decl.path):
                continue
            device = {callgraph.DEVICE} | {
                i for i, name in enumerate(callgraph.own_params(decl))
                if name not in statics}
            for event in graph.analyze(decl).events:
                if event.sources & device:
                    self._add(findings, decl.path, event, decl.qualname)
        reached = graph.reachable([decl for decl, _ in bodies], cha_paths=())
        for (path, qualname), chain in reached.items():
            if not chain or not self.applies_to(path):
                continue  # the bodies themselves were judged above
            decl = graph.decls_in(path).get(qualname)
            if decl is None:
                continue
            for event in graph.analyze(decl).events:
                if callgraph.DEVICE in event.sources:
                    self._add(findings, path, event, f"{qualname}, reached from {chain}")
        return [findings[k] for k in sorted(findings)]

    def _add(self, findings, path: str, event, owner: str) -> None:
        key = (path, event.line, event.detail)
        if key in findings:
            return
        where = (f" through {' -> '.join(event.funcs)} at {event.sink_path}:{event.sink_line}"
                 if event.funcs else "")
        findings[key] = Finding(
            path=path, line=event.line, rule=self.id,
            message=(f"{event.detail} in captured body {owner}(){where} "
                     f"{_KIND_TEXT[event.kind]}; move it out of the captured body or "
                     "suppress with the reason it is safe"),
            data=(event.kind, event.detail, owner))
