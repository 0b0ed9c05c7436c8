"""What a receiver is: the class or library type an expression denotes.

The flow and lock rules ask what a call's receiver is before they judge
the call: a `threading.Event`'s `wait()` blocks a thread, a
`prefetch.Staged`'s `wait()` only orders a stream, and a
`torch.cuda.Event` belongs to host-sync-leak. A name says little (the
JAX package's rule reads every bare `.wait()` as a thread wait), so
`Typer.kind_of` infers the receiver's type from what the source states:

- a constructor: `threading.Event()`, `queue.Queue(4)`, `torch.cuda.Event()`,
  a class of the project (local or imported, `flow.BoundedChannel(...)`);
- a function or method the call graph resolves, by its return annotation
  or else by what it returns (`stage_to_device(...)` -> `Staged`), and an
  instance's `__call__` (`self._stager(tree)`);
- a parameter's annotation (`readback: _Readback`, `window:
  flow.BoundedChannel`), a local or module-level assignment, an
  `isinstance(x, C)` test guarding the call, and `self.attr` assigned in
  any method of the class (or one of its project bases).

Anything else is unknown (None): each rule says what an unknown receiver
means for it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from .. import callgraph
from ..engine import PACKAGE
from ..source import SourceModule, dotted_name, resolve_relative_import

#: threading's blocking primitives (their wait/join block a thread)
THREADING = ("Event", "Condition", "Lock", "RLock", "Semaphore", "BoundedSemaphore",
             "Barrier", "Thread", "Timer")
#: the queue module's queues
QUEUES = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")
#: the project's channel class (flow.py)
CHANNEL_CLASS = "BoundedChannel"

_MAX_DEPTH = 8


@dataclass(frozen=True)
class Kind:
    """A value's type: `origin` "threading", "queue", "torch" (any torch
    object), "lib" (another library's or a builtin's) or "class" (a class
    of the project, declared at `path`)."""

    origin: str
    name: str
    path: str = ""

    @property
    def queue_like(self) -> bool:
        return self.origin == "queue" or (self.origin == "class" and self.name == CHANNEL_CLASS)


Ref = Union[Kind, "callgraph.FunctionDecl", None]


class Typer:
    """Receiver types over one project; memoized, depth-bounded."""

    def __init__(self, project):
        self.project = project
        self.graph = callgraph.get(project)
        self._aliases: Dict[str, Dict[str, str]] = {}
        self._parents: Dict[str, Dict[int, ast.AST]] = {}
        self._classes: Dict[str, Dict[str, ast.ClassDef]] = {}
        self._attrs: Dict[Tuple[str, str], Dict[str, List]] = {}
        self._globals: Dict[str, Dict[str, List]] = {}
        self._busy: set = set()

    # -- per-module tables ---------------------------------------------------
    def aliases(self, module: SourceModule) -> Dict[str, str]:
        """Local name -> the absolute dotted thing it imports."""
        table = self._aliases.get(module.path)
        if table is None:
            table = {}
            for node in ast.walk(module.tree) if module.tree is not None else ():
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname:
                            table[a.asname] = a.name
                        else:
                            root = a.name.split(".")[0]
                            table[root] = root
                elif isinstance(node, ast.ImportFrom):
                    target = resolve_relative_import(module.module_name, node, module.is_package)
                    if target is not None:
                        for a in node.names:
                            table[a.asname or a.name] = f"{target}.{a.name}"
            self._aliases[module.path] = table
        return table

    def parents(self, module: SourceModule) -> Dict[int, ast.AST]:
        table = self._parents.get(module.path)
        if table is None:
            table = {}
            for node in ast.walk(module.tree) if module.tree is not None else ():
                for child in ast.iter_child_nodes(node):
                    table[id(child)] = node
            self._parents[module.path] = table
        return table

    def classes(self, path: str) -> Dict[str, ast.ClassDef]:
        table = self._classes.get(path)
        if table is None:
            module = self.project.module_at(path)
            table = {n.name: n for n in (module.tree.body if module and module.tree else ())
                     if isinstance(n, ast.ClassDef)}
            self._classes[path] = table
        return table

    def globals(self, module: SourceModule) -> Dict[str, List]:
        """Module-level name -> the values (or annotations: the flag) it is
        given."""
        table = self._globals.get(module.path)
        if table is None:
            table = {}
            for stmt in module.tree.body if module.tree is not None else ():
                for name, value, is_ann in _bindings(stmt, ast.Name):
                    table.setdefault(name, []).append((value, is_ann))
            self._globals[module.path] = table
        return table

    def scope(self, module: SourceModule, node: ast.AST) -> Tuple[Optional[ast.AST], Optional[str]]:
        """The innermost def around `node` and the class around that def."""
        parents = self.parents(module)
        func, cls = None, None
        cur = parents.get(id(node))
        while cur is not None:
            if func is None and isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                func = cur
            elif isinstance(cur, ast.ClassDef):
                cls = cur.name
                break
            cur = parents.get(id(cur))
        return func, cls

    # -- static references ---------------------------------------------------
    def resolve_ref(self, module: SourceModule, expr: ast.AST) -> Ref:
        """What a dotted reference names: a class or library callable (as
        the Kind of what calling it makes), a project function, or None."""
        name = dotted_name(expr)
        if name is None or name.split(".")[0] in ("self", "cls"):
            return None
        root, _, rest = name.partition(".")
        if root in self.aliases(module):
            full = self.aliases(module)[root] + (f".{rest}" if rest else "")
        else:
            local = self.classes(module.path).get(root)
            if local is not None and not rest:
                return Kind("class", root, module.path)
            decl = self.graph.decls_in(module.path).get(root)
            if decl is not None and not rest:
                return decl
            if root in ("dict", "list", "set", "tuple", "str", "bytes", "object", "int",
                        "float", "bool") and not rest:
                return Kind("lib", root)
            return None
        return self._resolve_dotted(full)

    def _resolve_dotted(self, full: str) -> Ref:
        parts = full.split(".")
        top = parts[0]
        if top == "threading" and len(parts) == 2:
            return Kind("threading", parts[1])
        if top == "queue" and len(parts) == 2:
            return Kind("queue", parts[1])
        if top == "torch":
            return Kind("torch", full)
        for cut in range(len(parts) - 1, 0, -1):
            path = self.graph.module_paths.get(".".join(parts[:cut]))
            if path is None:
                continue
            rest = parts[cut:]
            if len(rest) != 1:
                return None
            if rest[0] in self.classes(path):
                return Kind("class", rest[0], path)
            decl = self.graph.decls_in(path).get(rest[0])
            if decl is not None and not decl.is_method:
                return decl
            return None
        if top == PACKAGE:
            return None  # a project name the tables do not hold
        return Kind("lib", full)

    def _module_global(self, full: str) -> Optional[Tuple[SourceModule, List]]:
        """The values a project module assigns to `full`'s last part."""
        mod, _, obj = full.rpartition(".")
        path = self.graph.module_paths.get(mod)
        module = self.project.module_at(path) if path else None
        if module is None or module.tree is None:
            return None
        return module, self.globals(module).get(obj, [])

    # -- classes -------------------------------------------------------------
    def bases(self, kind: Kind) -> List[Kind]:
        node = self.classes(kind.path).get(kind.name) if kind.origin == "class" else None
        module = self.project.module_at(kind.path) if node is not None else None
        out = []
        for base in node.bases if node is not None else ():
            ref = self.resolve_ref(module, base)
            if isinstance(ref, Kind):
                out.append(ref)
        return out

    def mro(self, kind: Kind) -> List[Kind]:
        out, todo = [], [kind]
        while todo and len(out) < 16:
            k = todo.pop(0)
            if k not in out:
                out.append(k)
                todo.extend(self.bases(k))
        return out

    def method(self, kind: Kind, name: str):
        """`kind`'s method `name`, from the class or its project bases."""
        for k in self.mro(kind):
            if k.origin == "class":
                decl = self.graph.decls_in(k.path).get(f"{k.name}.{name}")
                if decl is not None:
                    return decl
        return None

    def attr_values(self, kind: Kind, attr: str) -> List[Tuple]:
        """(module, value, is an annotation, the def it is assigned in) of
        `self.attr` or a class attribute, in `kind` or its bases."""
        out = []
        for k in self.mro(kind):
            if k.origin != "class":
                continue
            table = self._attrs.get((k.path, k.name))
            if table is None:
                table = {}
                for item in self.classes(k.path)[k.name].body:
                    for name, value, is_ann in _bindings(item, ast.Name):
                        table.setdefault(name, []).append((value, is_ann, None))
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        for sub in ast.walk(item):
                            for name, value, is_ann in _bindings(sub, ast.Attribute):
                                table.setdefault(name, []).append((value, is_ann, item))
                self._attrs[(k.path, k.name)] = table
            module = self.project.module_at(k.path)
            out.extend((module, v, is_ann, fn) for v, is_ann, fn in table.get(attr, ()))
        return out

    # -- the inference -------------------------------------------------------
    def annotation_kind(self, module: SourceModule, ann: Optional[ast.AST]) -> Optional[Kind]:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):  # Optional[X]
            return self.annotation_kind(module, ann.slice)
        if isinstance(ann, ast.BinOp):  # X | None
            return self.annotation_kind(module, ann.left) or self.annotation_kind(module, ann.right)
        ref = self.resolve_ref(module, ann)
        return ref if isinstance(ref, Kind) else None

    def returns_kind(self, decl, depth: int = 0) -> Optional[Kind]:
        module = self.project.module_at(decl.path)
        if module is None:
            return None
        kind = self.annotation_kind(module, decl.node.returns)
        if kind is not None:
            return kind
        for node in _own_nodes(decl.node):
            if isinstance(node, ast.Return) and node.value is not None:
                kind = self.kind_of(module, node.value, decl.node, depth + 1)
                if kind is not None:
                    return kind
        return None

    def kind_of(self, module: SourceModule, expr: ast.AST, func: Optional[ast.AST] = None,
                depth: int = 0) -> Optional[Kind]:
        """The type of the value `expr` denotes inside `func` (found from the
        tree when None), or None when the source does not say."""
        if depth > _MAX_DEPTH or module is None:
            return None
        key = (module.path, id(expr))
        if key in self._busy:
            return None
        self._busy.add(key)
        try:
            return self._kind_of(module, expr, func, depth)
        finally:
            self._busy.discard(key)

    def _kind_of(self, module, expr, func, depth) -> Optional[Kind]:
        if func is None:
            func, _ = self.scope(module, expr)
        cls = self._class_of(module, func)
        if isinstance(expr, ast.IfExp):
            return (self.kind_of(module, expr.body, func, depth + 1)
                    or self.kind_of(module, expr.orelse, func, depth + 1))
        if isinstance(expr, ast.Call):
            return self._call_kind(module, expr, func, cls, depth)
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls") and cls is not None:
                return Kind("class", cls, module.path)
            guarded = self._isinstance_guard(module, expr)
            if guarded is not None:
                return guarded
            return self._name_kind(module, expr.id, func, depth)
        if isinstance(expr, ast.Attribute):
            if self.resolve_ref(module, expr) is not None:
                return None  # a class or a function, not an instance
            name = dotted_name(expr)
            if name is not None and name.split(".")[0] in self.aliases(module):
                root, _, rest = name.partition(".")  # a module's global
                found = self._module_global(f"{self.aliases(module)[root]}.{rest}")
                return self._first_kind(found[0], found[1], None, depth) if found else None
            owner = self.kind_of(module, expr.value, func, depth + 1)
            if owner is None or owner.origin != "class":
                return owner if owner is not None and owner.origin == "torch" else None
            for m, value, is_ann, fn in self.attr_values(owner, expr.attr):
                kind = self._value_kind(m, value, is_ann, fn, depth)
                if kind is not None:
                    return kind
            return None
        return None

    def _class_of(self, module, func) -> Optional[str]:
        """The class whose `self` a def (or a def nested in a method) sees."""
        return self.scope(module, func)[1] if func is not None else None

    def _call_kind(self, module, call, func, cls, depth) -> Optional[Kind]:
        ref = self.resolve_ref(module, call.func)
        if isinstance(ref, Kind):
            return ref  # a constructor
        if isinstance(call.func, ast.Attribute):
            owner = self.kind_of(module, call.func.value, func, depth + 1)
            if owner is not None and owner.origin == "torch":
                return owner
        decl = self.callee(module, call, func, depth)
        return self.returns_kind(decl, depth) if decl is not None else None

    def callee(self, module: SourceModule, call: ast.Call, func: Optional[ast.AST] = None,
               depth: int = 0):
        """The project def a call runs: what the call graph resolves, a
        project function by import, a class's `__init__`, a method of a
        typed receiver (`ch.put(...)` where `ch = BoundedChannel(...)`,
        `self.cache.get(...)`), or an instance's `__call__`
        (`self._stager(tree)`); None when the source does not say."""
        if func is None:
            func, _ = self.scope(module, call)
        resolved = self.graph.resolve(module, call.func, self._class_of(module, func))
        if resolved is not None:
            return resolved[0]
        ref = self.resolve_ref(module, call.func)
        if isinstance(ref, Kind):
            return self.method(ref, "__init__") if ref.origin == "class" else None
        if ref is not None:
            return ref
        if isinstance(call.func, ast.Attribute):
            owner = self.kind_of(module, call.func.value, func, depth + 1)
            if owner is not None and owner.origin == "class":
                decl = self.method(owner, call.func.attr)
                if decl is not None:
                    return decl
        inst = self.kind_of(module, call.func, func, depth + 1)
        if inst is not None and inst.origin == "class":
            return self.method(inst, "__call__")
        return None

    def _isinstance_guard(self, module, name: ast.Name) -> Optional[Kind]:
        """C when `name` is read under a test `isinstance(name, C)`."""
        parents = self.parents(module)
        child, cur = name, parents.get(id(name))
        while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(cur, (ast.IfExp, ast.If)) and child is not cur.test:
                in_body = (child is cur.body) if isinstance(cur, ast.IfExp) else child in cur.body
                test = cur.test
                if (in_body and isinstance(test, ast.Call) and dotted_name(test.func) == "isinstance"
                        and len(test.args) == 2 and isinstance(test.args[0], ast.Name)
                        and test.args[0].id == name.id):
                    ref = self.resolve_ref(module, test.args[1])
                    if isinstance(ref, Kind):
                        return ref
            child, cur = cur, parents.get(id(cur))
        return None

    def _name_kind(self, module, name: str, func, depth) -> Optional[Kind]:
        scope = func
        while scope is not None:
            if not isinstance(scope, ast.Lambda):
                args = scope.args
                for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
                    if a.arg == name:
                        return self.annotation_kind(module, a.annotation)
            values = [(v, a) for node in _own_nodes(scope) for n, v, a in _bindings(node, ast.Name)
                      if n == name]
            if values:
                return self._first_kind(module, values, scope, depth)
            scope, _ = self.scope(module, scope)
        values = self.globals(module).get(name)
        if values:
            return self._first_kind(module, values, None, depth)
        full = self.aliases(module).get(name)
        if full is not None:
            found = self._module_global(full)
            if found is not None:
                return self._first_kind(found[0], found[1], None, depth)
        return None

    def _first_kind(self, module, values, func, depth) -> Optional[Kind]:
        for value, is_ann in values:
            kind = self._value_kind(module, value, is_ann, func, depth)
            if kind is not None:
                return kind
        return None

    def _value_kind(self, module, value, is_ann, func, depth) -> Optional[Kind]:
        if is_ann:
            return self.annotation_kind(module, value)
        return self.kind_of(module, value, func, depth + 1)


def _bindings(node: ast.AST, target_type):
    """(name, value, is an annotation) of what `node` binds: names
    (`target_type` ast.Name) or `self.` attributes (ast.Attribute)."""
    pairs = []
    if isinstance(node, ast.Assign):
        pairs = [(t, node.value, False) for t in node.targets]
    elif isinstance(node, ast.AnnAssign):
        pairs = [(node.target, node.value if node.value is not None else node.annotation,
                  node.value is None)]
    out = []
    for target, value, is_ann in pairs:
        if target_type is ast.Name and isinstance(target, ast.Name):
            out.append((target.id, value, is_ann))
        elif (target_type is ast.Attribute and isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name) and target.value.id == "self"):
            out.append((target.attr, value, is_ann))
    return out


def _own_nodes(func: ast.AST):
    """The nodes of `func`'s body, nested defs and classes left out."""
    todo = list(func.body) if isinstance(func.body, list) else [func.body]
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                                      ast.Lambda)):
                todo.append(child)


def get(project) -> Typer:
    """The project's memoized typer (shared across rules)."""
    return project.index("receivers", Typer)
