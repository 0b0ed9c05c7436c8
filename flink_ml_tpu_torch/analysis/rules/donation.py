"""donation-after-use: a buffer an asynchronous copy still owns.

Port of flink_ml_tpu/analysis/rules/donation.py, for the port's
counterpart hazard. The port donates nothing (ROADMAP C.23: a captured
graph reads its inputs in place), but a `non_blocking=True` copy between
the host and a card hands a buffer to the card's copy engine the same
way donation hands one to XLA: until the copy's event, stream or device
is synchronized, the Python name points at bytes that are not yet (or
no longer) what the program thinks. The argument of the JAX docstring
holds word for word: on the CPU these copies run synchronously, as
donation there is a no-op, so every CPU test passes and only the card
corrupts. The rule flags:

- a **read of the host destination** of a `non_blocking` device-to-host
  copy (`dst.copy_(device_tensor, non_blocking=True)` into a pinned host
  tensor: `.numpy()`, `.item()`, `.tolist()`, `.tobytes()`, indexing,
  `np.asarray`/`np.array`/`bytes`) before a `.synchronize()` (an
  event's, a stream's or `torch.cuda.synchronize()`);
- a **refill of the pinned source** of a `non_blocking` host-to-device
  copy (`.copy_` into it, an in-place method, an item store, or handing
  it to a call that fills it) before such a sync.

The walk is linear within each function (loop bodies twice: the second
iteration sees the first's copies still in flight), as the JAX rule's.
It is interprocedural one hop through the call graph
(`analysis/callgraph.py`): a function that returns a host buffer with its
copy still in flight makes its caller's name in flight, and a method that
leaves `self.<attr>` in flight at its end makes that attribute in flight
at the entry of the class's other methods (a readback started in
`__init__` and read in `wait()`, serving.py's `_Readback`).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .. import callgraph
from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name
from ._astwalk import header_nodes

#: tensor methods that read a host buffer's bytes
READ_METHODS = ("numpy", "item", "tolist", "tobytes")
#: functions that read a host buffer's bytes
READ_CALLS = ("asarray", "array", "bytes", "frombuffer")


def _ordered(body: List[ast.stmt]) -> List[ast.stmt]:
    """`analysis.rules._astwalk.statements_in_order`, with a loop's body
    walked twice (its back edge: the next iteration runs after this one's
    copies were issued)."""
    out: List[ast.stmt] = []

    def visit(stmts, depth):
        for stmt in stmts:
            out.append(stmt)
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            repeat = 2 if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)) and depth < 2 \
                else 1
            for _ in range(repeat):
                visit(getattr(stmt, "body", None) or [], depth + 1)
            for block in ("orelse", "finalbody"):
                visit(getattr(stmt, block, None) or [], depth)
            for handler in getattr(stmt, "handlers", None) or []:
                visit(handler.body, depth)
    visit(body, 0)
    return out


def _pins(node: ast.AST) -> bool:
    """Does the expression make a pinned host tensor?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if any(kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant)
                   and kw.value.value is True for kw in sub.keywords):
                return True
            if isinstance(sub.func, ast.Attribute) and sub.func.attr == "pin_memory":
                return True
    return False


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _root(node: ast.AST) -> Optional[str]:
    """The dotted name a buffer expression denotes (`pinned[:n]` -> pinned)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return dotted_name(node)


def _calls(stmt: ast.stmt) -> List[ast.Call]:
    return [sub for header in header_nodes(stmt) for sub in ast.walk(header)
            if isinstance(sub, ast.Call)]


def _stored(stmt: ast.stmt) -> Set[str]:
    out: Set[str] = set()
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    for target in targets:
        for sub in ast.walk(target):
            if isinstance(sub, (ast.Name, ast.Attribute)) and isinstance(sub.ctx, ast.Store):
                name = dotted_name(sub)
                if name is not None:
                    out.add(name)
    return out


class _Walk:
    """One linear walk of a function: pinned names, buffers in flight, and
    the findings."""

    def __init__(self, rule, module, summaries, inflight=None, pinned=None):
        self.rule = rule
        self.module = module
        self.summaries = summaries
        self.pinned: Set[str] = set(pinned or ())
        # name -> (what owns it, the copy's line): a host destination in flight
        self.inflight: Dict[str, Tuple[str, int]] = dict(inflight or {})
        # name -> line: a pinned source of a host-to-device copy in flight
        self.sources: Dict[str, int] = {}
        self.stored: Dict[str, Tuple[str, int]] = {}  # self.<attr> left in flight
        self.returned: Optional[Tuple[str, int]] = None
        self.findings: List[Finding] = []

    def run(self, func_body, graph, current_class) -> None:
        for stmt in _ordered(func_body):
            self.reads(stmt)
            self.refills(stmt)
            synced = False
            for call in _calls(stmt):
                if isinstance(call.func, ast.Attribute) and call.func.attr == "synchronize":
                    synced = True
            if synced:
                self.inflight.clear()
                self.sources.clear()
                self.stored.clear()
            for name in _stored(stmt):
                self.inflight.pop(name, None)
                self.sources.pop(name, None)
                self.pinned.discard(name)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and stmt.value is not None:
                self.bind(stmt, graph, current_class)
            for call in _calls(stmt):
                self.copy(call)
            if isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Name) \
                    and stmt.value.id in self.inflight:
                self.returned = self.inflight[stmt.value.id]

    def bind(self, stmt, graph, current_class) -> None:
        value = stmt.value
        targets = [dotted_name(t) for t in (stmt.targets if isinstance(stmt, ast.Assign)
                                            else [stmt.target])]
        targets = [t for t in targets if t is not None]
        pinned = _pins(value) or (_root(value) in self.pinned)
        inflight = None
        if isinstance(value, ast.Call):
            resolved = graph.resolve(self.module, value.func, current_class)
            if resolved is not None:
                summary = self.summaries.get(resolved[0].key)
                if summary is not None:
                    pinned = pinned or summary[0]
                    if summary[1] is not None:
                        inflight = (f"{resolved[0].qualname} ({summary[1][0]})", value.lineno)
        for t in targets:
            if pinned:
                self.pinned.add(t)
            if inflight is not None:
                self.inflight[t] = inflight

    def copy(self, call: ast.Call) -> None:
        if not (isinstance(call.func, ast.Attribute) and call.func.attr == "copy_"
                and call.args and _non_blocking(call)):
            return
        dst = _root(call.func.value)
        src = _root(call.args[0])
        if dst is not None and dst in self.pinned:
            self.inflight[dst] = ("a non_blocking device-to-host copy", call.lineno)
            if dst.startswith("self."):
                self.stored[dst] = self.inflight[dst]
        elif src is not None and src in self.pinned:
            self.sources[src] = call.lineno

    def reads(self, stmt) -> None:
        for header in header_nodes(stmt):
            for sub in ast.walk(header):
                name = None
                if isinstance(sub, ast.Call):
                    if isinstance(sub.func, ast.Attribute) and sub.func.attr in READ_METHODS:
                        name = dotted_name(sub.func.value)
                    elif (dotted_name(sub.func) or "").split(".")[-1] in READ_CALLS and sub.args:
                        name = _root(sub.args[0])
                elif isinstance(sub, ast.Subscript) and isinstance(sub.ctx, ast.Load):
                    name = dotted_name(sub.value)
                if name is not None and name in self.inflight:
                    owner, line = self.inflight.pop(name)
                    self.report(sub.lineno, name, (
                        f"'{name}' is read while {owner} on line {line} may still be "
                        "writing it: synchronize the copy's event or stream first"))

    def refills(self, stmt) -> None:
        if not self.sources:
            return
        written: List[Tuple[str, int]] = []
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                if isinstance(target, ast.Subscript):
                    written.append((_root(target), stmt.lineno))
        for call in _calls(stmt):
            func = call.func
            if isinstance(func, ast.Attribute) and (func.attr == "copy_" or (
                    func.attr.endswith("_") and not func.attr.startswith("_"))):
                if not (func.attr == "copy_" and _non_blocking(call)):
                    written.append((_root(func.value), call.lineno))
            elif not (isinstance(func, ast.Attribute) and func.attr == "copy_"):
                for arg in call.args:
                    written.append((_root(arg), call.lineno))
        for name, line in written:
            if name is not None and name in self.sources:
                copied_at = self.sources.pop(name)
                self.report(line, name, (
                    f"'{name}' is refilled while the non_blocking host-to-device copy on "
                    f"line {copied_at} may still be reading it: wait for the copy's event "
                    "before the refill"))

    def report(self, line: int, name: str, message: str) -> None:
        self.findings.append(Finding(path=self.module.path, line=line, rule=self.rule.id,
                                     message=message, data=(name, "non_blocking")))


def _functions(tree: ast.AST):
    """(def, enclosing class name or None) for every def of a module."""
    out = []

    def visit(body, cls):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit(node.body, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((node, cls))
                visit(node.body, None)
            else:
                for block in ("body", "orelse", "finalbody"):
                    visit(getattr(node, block, None) or [], cls)
    visit(tree.body, None)
    return out


def _summaries(project, graph) -> Dict:
    """(path, qualname) -> (returns a pinned buffer, the in-flight buffer it
    returns or None), and (path, Class) -> {self.<attr>: owner} left in
    flight by a method: the one-hop summaries."""
    out: Dict = {}
    # pass 1: which functions return a pinned host buffer (their own pins)
    for module in project.modules:
        if module.tree is None:
            continue
        for qualname, decl in graph.decls_in(module.path).items():
            walk = _Walk(DonationAfterUseRule, module, {})
            walk.run(decl.node.body, graph, qualname.split(".")[0] if decl.is_method else None)
            out[decl.key] = (any(isinstance(n, ast.Return) and n.value is not None
                                 and (_pins(n.value) or _root(n.value) in walk.pinned)
                                 for n in ast.walk(decl.node)), None)
    # pass 2: with those, which return a buffer with its copy in flight, and
    # which leave `self.<attr>` in flight
    for module in project.modules:
        if module.tree is None:
            continue
        for qualname, decl in graph.decls_in(module.path).items():
            walk = _Walk(DonationAfterUseRule, module, dict(out))
            walk.run(decl.node.body, graph, qualname.split(".")[0] if decl.is_method else None)
            out[decl.key] = (out[decl.key][0], walk.returned)
            if decl.is_method and walk.stored:
                cls_key = (module.path, qualname.split(".")[0])
                for attr, (owner, line) in walk.stored.items():
                    out.setdefault(cls_key, {})[attr] = (
                        f"{owner} in {qualname}", line, qualname)
    return out


@register
class DonationAfterUseRule(Rule):
    id = "donation-after-use"
    title = "buffer read or refilled while an async copy owns it"
    rationale = (
        "A non_blocking copy between the host and a card hands the buffer to "
        "the copy engine until its event, stream or device is synchronized: "
        "reading the host destination, or refilling the pinned source, before "
        "then reads stale bytes or corrupts the copy. The CPU runs these copies "
        "synchronously, so the bug is invisible to CPU tests and real on the "
        "card (the port's counterpart of reading a donated buffer)."
    )
    example = ("host.copy_(dev, non_blocking=True)\n"
               "x = host.numpy()  # the copy may not have landed")
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        graph = callgraph.get(project)
        summaries = project.index("donation-summaries", lambda p: _summaries(p, graph))
        for module in project.modules:
            if module.tree is None or not self.applies_to(module.path):
                continue
            for node, cls in _functions(module.tree):
                entry = {}
                stored = summaries.get((module.path, cls), {}) if cls else {}
                for attr, (owner, line, method) in stored.items():
                    if method != f"{cls}.{node.name}":
                        entry[attr] = (owner, line)
                walk = _Walk(self, module, summaries, inflight=entry)
                walk.run(node.body, graph, cls)
                yield from walk.findings
