"""host-sync-leak: a device-to-host sync outside the packing funnel.

Port of flink_ml_tpu/analysis/rules/hostsync.py. A stray sync on a fit,
transform or serve path stalls the host until the card drains, and no
counter says which line did it. The sanctioned funnel is
`utils/packing.packed_device_get` / `packed_bytes_get` (`:26`, `:53`):
one packed pinned copy, counted as `iteration.host_sync.*`. The rule
flags, in every function reachable from an entry (a `fit` or `transform`
method, or the serving roots of serving.py), the syncs of
`analysis/callgraph.py` made around it:

- `.item()`, `.tolist()`, `.cpu()` and `.numpy()` of a device tensor;
- `float(x)`, `int(x)` and `bool(x)` of a device tensor, and a device
  tensor as an `if`/`while`/`assert` test (Python asks for its truth);
- `torch.cuda.synchronize()` and `Event.synchronize()`: barriers, which
  is why each must carry the reason it is deliberate;
- **a device value passed to a helper that syncs it**: the call graph
  lifts the helper's sync to the call site, with the chain and the sink's
  file:line in the finding.

Reachability follows resolved calls and, for an attribute call, every
method of that name in the package (an over-approximation). Taint is
under-approximated: an unknown call launders it, and a value whose device
cannot be told raises nothing. The suppressions are the port's census of
its deliberate host syncs.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from .. import callgraph
from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule
from . import _jitindex

#: methods that are entries of a fit or a transform
ENTRY_METHODS = ("fit", "transform")
#: the serving roots (qualname prefixes in serving.py)
SERVE_ROOTS = ("MicroBatchServer.", "serve_stream")

_KIND_TEXT = {"pull": "a device->host copy", "cast": "a hidden blocking sync",
              "branch": "a hidden bool(), a blocking sync"}


def entry_decls(graph) -> List[callgraph.FunctionDecl]:
    """Every fit/transform method of the package and the serving roots."""
    out = []
    for path, decls in graph.by_module.items():
        for qualname, decl in decls.items():
            if decl.is_method and qualname.rsplit(".", 1)[-1] in ENTRY_METHODS:
                out.append(decl)
            elif path == f"{PACKAGE}/serving.py" and qualname.startswith(SERVE_ROOTS):
                out.append(decl)
    return out


def _sink_text(event) -> str:
    if event.kind == "pull":
        return f".{event.detail}()"
    if event.kind == "branch":
        return f"the {event.detail} test"
    return f"{event.detail}()"


@register
class HostSyncLeakRule(Rule):
    id = "host-sync-leak"
    title = "implicit or unaccounted device->host synchronization"
    rationale = (
        "A stray device->host sync on a fit, transform or serve path stalls "
        "the host until the card drains, and no counter says which line did "
        "it. Every sync must ride packed_device_get / packed_bytes_get "
        "(packed, counted as iteration.host_sync.*) or carry a suppression "
        "stating why it is deliberate; the suppressions are the port's "
        "host-sync census. A sync laundered through helper functions is "
        "flagged at the call site with the chain."
    )
    example = "loss = dev_loss.item()  # implicit D2H pull"
    scope = (PACKAGE,)
    # the funnel itself performs the one sanctioned transfer
    exclude = (f"{PACKAGE}/utils/packing.py", f"{PACKAGE}/analysis")

    def check_project(self, project) -> Iterable[Finding]:
        graph = callgraph.get(project)
        reachable = graph.reachable(entry_decls(graph))
        for module in project.modules:
            if self.applies_to(module.path) and module.tree is not None:
                yield from self.check_reachable(project, module, graph, reachable)

    def check_reachable(self, project, module: SourceModule, graph, reachable):
        info = _jitindex.jit_index(project)[module.path]
        findings: List[Finding] = []
        suppressed_here = module.suppressions_for(self.id)
        for decl in graph.decls_in(module.path).values():
            if decl.key not in reachable:
                continue
            events = list(graph.analyze(decl).events)
            # nested functions of a reachable one, each its own scope
            for node in ast.walk(decl.node):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not decl.node:
                    params = {a.arg: i for i, a in enumerate(
                        list(node.args.posonlyargs) + list(node.args.args))}
                    walker = callgraph.TaintWalker(graph=graph, module=module, info=info,
                                                   params=params)
                    walker.run_block(node.body)
                    walker.build_summary()
                    events.extend(walker.events)
            for event in events:
                if event.kind == "print":
                    continue
                if callgraph.DEVICE in event.sources:
                    if event.funcs and event.documented:
                        continue  # the helper documents the sync; callers inherit none
                    findings.append(self._finding(module, event))
                elif (not event.funcs and event.kind in callgraph.SYNC_KINDS
                      and event.line in suppressed_here):
                    # a parameter's sync under a suppression: callers inherit
                    # none; the census finding keeps the annotation in use
                    findings.append(Finding(
                        path=module.path, line=event.line, rule=self.id,
                        message=(f"{_sink_text(event)} on a function parameter is a blocking "
                                 "sync when callers pass device values; deliberate here "
                                 "(suppressed), callers inherit no finding"),
                        data=(f"{event.kind}-param", event.detail)))
        seen = set()
        unique = []
        for f in findings:
            key = (f.line, f.message)
            if key not in seen:
                seen.add(key)
                unique.append(f)
        return unique

    def _finding(self, module: SourceModule, event) -> Finding:
        if event.funcs:
            chain = " -> ".join(event.funcs)
            message = (f"device value passed to {event.funcs[0]}() is synced to the host by "
                       f"{_sink_text(event)} at {event.sink_path}:{event.sink_line} (call chain: "
                       f"{chain}), a device->host sync laundered through helpers; route the "
                       "readback through packed_device_get or keep the helper on the card")
            data = (f"{event.kind}-chain", event.detail) + tuple(event.funcs)
        elif event.kind == "barrier":
            message = (f"{event.detail}() is a blocking device barrier outside the packing "
                       "funnel; route the readback through packed_device_get, or suppress "
                       "with the reason this barrier is deliberate")
            data = (event.detail,)
        else:
            message = (f"{_sink_text(event)} on a device value is {_KIND_TEXT[event.kind]}; "
                       "read it back through packed_device_get with the call's packed "
                       "result instead")
            data = (event.kind, event.detail)
        return Finding(path=module.path, line=event.line, rule=self.id, message=message,
                       data=data)
