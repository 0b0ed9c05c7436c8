"""serve-path-trace: no capture made on the serving dispatch path.

Port of flink_ml_tpu/analysis/rules/servepath.py. The program bank
(compilebank.py) lets a warmed serving process capture nothing on its
request path: `MicroBatchServer.warmup` captures every banked segment
ahead of traffic, so a fresh process's first serve makes no capture
(`jit.traces` 0: ROADMAP C.4, C.23). That holds only while every graph the
dispatch path can reach goes through a bank-consulting funnel
(`utils/lazyjit.py`, `compilebank.py`). The rule walks the call graph from
the serving roots (`MicroBatchServer` and `serve_stream`) and flags, in any
reachable function outside those funnels,

- **a raw `torch.cuda.graph` / `torch.cuda.CUDAGraph`**: a capture the
  bank cannot see, made on the first request that reaches it;
- **a `lazy_jit`/`keyed_jit` wrapper built inside a reachable function**:
  a module-level wrapper is built at import and warm-loaded from the
  bank, but one built on the dispatch path captures on its first call,
  mid-request.

Reachability over-approximates the serving surface: resolved calls
(module-level functions, one-hop imports, `self.` methods) plus
class-hierarchy lifting, where `x.m(...)` reaches every method named `m` of
the serving-surface modules below. A capture on the path cannot hide
behind an unresolvable receiver.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from .. import callgraph
from ..engine import PACKAGE, Finding, Rule, register
from . import _jitindex
from .retrace import raw_capture

#: the dispatch-path entry points (path, qualname prefix)
ROOTS = ((f"{PACKAGE}/serving.py", "MicroBatchServer."),
         (f"{PACKAGE}/serving.py", "serve_stream"))

#: modules whose classes take part in attribute-call lifting: the serving
#: dispatch surface
CHA_MODULES = tuple(f"{PACKAGE}/{p}" for p in (
    "serving.py", "pipeline.py", "table.py", "api.py", "lifecycle.py", "data/modelstore.py",
    "parallel/prefetch.py", "utils/packing.py"))

#: the bank-consulting funnels: captures INSIDE these are the contract's
#: implementation, not breaches of it
SANCTIONED = (f"{PACKAGE}/utils/lazyjit.py", f"{PACKAGE}/compilebank.py")


@register
class ServePathTraceRule(Rule):
    id = "serve-path-trace"
    title = "capture site reachable from the serving dispatch path"
    rationale = (
        "A warmed serving process must capture nothing on its request path "
        "(the bank's zero-capture contract, ROADMAP C.4/C.23): every graph "
        "reachable from MicroBatchServer's dispatch path must go through "
        "the bank-consulting funnels (utils/lazyjit.py, compilebank.py). A "
        "raw torch.cuda.graph or a wrapper built on the path is a capture "
        "the bank cannot warm: the first request that reaches it captures "
        "mid-flight."
    )
    example = "graph = torch.cuda.CUDAGraph()  # reachable from MicroBatchServer._dispatch"
    scope = (PACKAGE,)
    exclude = SANCTIONED + (f"{PACKAGE}/analysis",)

    def check_project(self, project) -> Iterable[Finding]:
        graph = callgraph.get(project)
        jitindex = _jitindex.jit_index(project)
        roots = [decl for path, prefix in ROOTS
                 for qualname, decl in graph.decls_in(path).items()
                 if qualname == prefix or qualname.startswith(prefix)]
        findings: List[Finding] = []
        for (path, qualname), chain in sorted(graph.reachable(roots, CHA_MODULES).items()):
            decl = graph.decls_in(path).get(qualname)
            module = project.module_at(path)
            if decl is None or module is None or not self.applies_to(path):
                continue
            findings.extend(self._capture_sites(module, jitindex[path], decl, chain))
        return findings

    def _capture_sites(self, module, info, decl, chain: str) -> List[Finding]:
        findings: List[Finding] = []
        via = f" (reached via {chain})" if chain else ""
        for node in ast.walk(decl.node):
            if raw_capture(node, info):
                findings.append(Finding(
                    path=module.path, line=node.lineno, rule=self.id,
                    message=(f"raw {callgraph.dotted_name(node)} in {decl.qualname} is reachable "
                             "from the serving dispatch path but not bank-resolvable: route it "
                             f"through the lazyjit/compilebank funnels or suppress with a "
                             f"reason{via}"),
                    data=("raw-capture", decl.qualname)))
            elif isinstance(node, ast.Call) and info.is_jit_callable(node.func):
                name = callgraph.dotted_name(node.func)
                findings.append(Finding(
                    path=module.path, line=node.lineno, rule=self.id,
                    message=(f"{name} wrapper constructed inside {decl.qualname} on the serving "
                             "dispatch path: its first call captures mid-request; hoist the "
                             f"wrapper to module scope so the bank can warm it{via}"),
                    data=("on-path-wrapper", decl.qualname)))
        return findings
