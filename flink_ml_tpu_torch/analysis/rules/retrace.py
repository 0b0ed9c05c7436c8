"""retrace-hazard: graph captures that bypass or bust the program cache.

Port of flink_ml_tpu/analysis/rules/retrace.py. A capture costs a first
call several times its eager run (an eager warm-up and the capture), so a
graph made again and again, or made where its cache cannot see it, is a
wall-clock cliff. The rule flags three shapes:

- **a raw `torch.cuda.graph` / `torch.cuda.CUDAGraph`** (or
  `make_graphed_callables`) outside `utils/lazyjit.py`: it bypasses
  `GraphCache` (one pool a cache, `make_room`'s eviction by the bytes a
  graph keeps), `capture_lock`, the launch-count correction and the
  `jit.*` counters; go through `lazy_jit`/`keyed_jit` or `capture`;
- **a wrapped closure over local state**: `lazy_jit`/`keyed_jit` applied,
  inside a function, to a lambda or nested def that reads enclosing
  locals; a new wrapper each outer call, so its graphs are never reused
  (pass the state as operands: the whole fits take their hyperparameters
  as one tensor, `sgd_hyper`);
- **a non-hashable static argument**: an f-string or a dict display fed to
  `static_argnames`, or a list, dict, set or f-string passed for a
  kernel's static argument; a static value is part of the signature, so
  each call makes a new key (or fails to hash) and never hits.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name
from . import _jitindex

#: torch.cuda's raw capture entry points
RAW_CAPTURE = ("graph", "CUDAGraph", "make_graphed_callables")
_UNHASHABLE = (ast.JoinedStr, ast.Dict, ast.DictComp, ast.List, ast.ListComp, ast.Set,
               ast.SetComp)


def raw_capture(node: ast.AST, info) -> bool:
    """Is `node` a reference to torch.cuda's raw capture?"""
    name = dotted_name(node) if isinstance(node, ast.Attribute) else None
    if name is None:
        return False
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-1] in RAW_CAPTURE and parts[-2] == "cuda"
            and parts[0] in info.torch_aliases)


def _assigned_names(node: ast.AST) -> Set[str]:
    """Names bound anywhere inside `node` (params, assignments, defs)."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            out.add(sub.id)
        elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(sub.name)
        elif isinstance(sub, ast.arg):
            out.add(sub.arg)
    return out


def _loaded_names(node: ast.AST) -> Set[str]:
    return {sub.id for sub in ast.walk(node)
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)}


@register
class RetraceHazardRule(Rule):
    id = "retrace-hazard"
    title = "graph capture that busts the program cache or its accounting"
    rationale = (
        "A wrapper made per call captures per call (an eager warm-up and a "
        "capture each time), and a raw torch.cuda.graph/CUDAGraph bypasses "
        "GraphCache, make_room, capture_lock and the jit.* counters that "
        "keep captures bounded and counted. Route graphs through "
        "utils/lazyjit.py; pass hyperparameters as tensor operands instead "
        "of closure constants; keep static arguments hashable and stable."
    )
    example = "graph = torch.cuda.CUDAGraph()  # use lazy_jit(step): cached + counted"
    scope = (PACKAGE,)
    # the funnel: its capture is the one sanctioned raw capture
    exclude = (f"{PACKAGE}/utils/lazyjit.py", f"{PACKAGE}/analysis")

    def check_module(self, project, module: SourceModule) -> Iterable[Finding]:
        if module.tree is None:
            return ()
        info = _jitindex.jit_index(project)[module.path]
        findings: List[Finding] = []

        # --- raw torch.cuda captures ---------------------------------------
        for node in ast.walk(module.tree):
            if raw_capture(node, info):
                findings.append(Finding(
                    path=module.path, line=node.lineno, rule=self.id,
                    message=(f"raw {dotted_name(node)} bypasses utils/lazyjit.py: GraphCache, "
                             "make_room, capture_lock and the jit.* counters miss this graph; "
                             "use lazy_jit/keyed_jit or lazyjit.capture"),
                    data=("raw-capture",)))

        # --- non-hashable static arguments ----------------------------------
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            statics = ()
            name = dotted_name(node.func)
            if name is not None and name in info.kernels:
                statics = info.kernels[name]
            for kw in node.keywords:
                if kw.arg in ("static_argnums", "static_argnames"):
                    subs = [s for s in ast.walk(kw.value)
                            if isinstance(s, (ast.JoinedStr, ast.Dict, ast.DictComp))]
                elif kw.arg in statics and isinstance(kw.value, _UNHASHABLE):
                    subs = [kw.value]
                else:
                    continue
                for sub in subs:
                    findings.append(Finding(
                        path=module.path, line=sub.lineno, rule=self.id,
                        message=(f"{kw.arg} fed a "
                                 f"{'f-string' if isinstance(sub, ast.JoinedStr) else 'display'}"
                                 ": per-call static keys never hit the program cache"),
                        data=("static-key",)))

        # --- wrapped closures over enclosing locals -------------------------
        # each call is judged against its INNERMOST enclosing function
        for node, func in _calls_with_enclosing_function(module.tree):
            if not node.args:
                continue
            is_jit = info.is_jit_callable(node.func) or (
                dotted_name(node.func) in ("partial", "functools.partial")
                and info.is_jit_callable(node.args[0]))
            if not is_jit:
                continue
            wrapped = node.args[0]
            local_defs = {n.name: n for n in ast.walk(func)
                          if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                          and n is not func}
            if isinstance(wrapped, ast.Lambda):
                target = wrapped
            elif isinstance(wrapped, ast.Name) and wrapped.id in local_defs:
                target = local_defs[wrapped.id]
            else:
                continue
            captured = (_loaded_names(target) - _assigned_names(target)) & _assigned_names(func)
            if captured:
                findings.append(Finding(
                    path=module.path, line=node.lineno, rule=self.id,
                    message=("wrapped closure captures enclosing locals "
                             f"({', '.join(sorted(captured)[:4])}): a new wrapper captures "
                             "per outer call; hoist the kernel to module scope and pass "
                             "captured state as tensor operands"),
                    data=("closure",)))
        return findings


def _calls_with_enclosing_function(tree: ast.AST):
    """(Call, innermost enclosing FunctionDef) pairs, each call once."""
    out = []

    def visit(node: ast.AST, func) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node
        if isinstance(node, ast.Call) and func is not None:
            out.append((node, func))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return out
