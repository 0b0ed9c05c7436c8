"""lock-order: static lock-acquisition-order analysis (deadlock cycles).

Port of flink_ml_tpu/analysis/rules/lockorder.py. The flow pump and
spawn workers, the serving dispatch loop, the model store's prefetch, the
supervisor's worker and the captures all take locks from several
threads; a lock inversion between two of them is silent on every run
that misses the exact interleaving. The rule holds the ordering
statically:

- every `threading.Lock`/`RLock`/`Condition` the package makes is a lock
  *node*: a module-level `_lock = Lock()` by name, `self._cv =
  Condition()` by `Class.attr` (all instances of a class share the node:
  one class-level order keeps multi-instance locking safe). In the port a
  node is also reached from another module (`capture_lock`, bound by name
  in `pipeline` and imported inside `lifecycle`), from a subclass
  (`pipeline._GraphCache` holds `GraphCache.lock`) and through a typed
  receiver (`self.graphs.lock`, `self.cache.lock`);
- every function is walked linearly tracking the *held set*: `with lock:`
  blocks, explicit `acquire()`/`release()` pairs, and, through the call
  graph and the receiver types (`_receivers.Typer`), the locks taken
  inside calls made while holding. A `with torch.cuda.graph(...)` block or
  a stream context is not a lock;
- each "holding A, acquire B" is an edge A -> B; a **cycle** is a finding
  (the ABBA deadlock), as is re-acquiring a non-reentrant `Lock` while
  holding it (RLock and Condition are reentrant and exempt).

The runtime half is `analysis/sanitizer.py`: with
`FLINK_ML_TPU_SANITIZE=1` (or `sanitizer.enable()`) it records the
acquisitions the program really makes across threads and fails on a
cycle at exit.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .. import callgraph
from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name
from . import _receivers

_LOCK_FACTORIES = ("Lock", "RLock", "Condition")
_REENTRANT = ("RLock", "Condition")


@dataclass(frozen=True)
class LockNode:
    node_id: str  # e.g. "flink_ml_tpu_torch.flow.BoundedChannel._cv"
    kind: str  # Lock | RLock | Condition
    path: str
    line: int


@dataclass
class _EdgeSite:
    path: str
    line: int
    via: str  # "" for a direct nested with, else the callee qualname


@dataclass
class _ModuleLocks:
    threading_aliases: Set[str] = field(default_factory=set)  # `import threading as t`
    factory_aliases: Dict[str, str] = field(default_factory=dict)  # `from threading import Lock as L`
    module_locks: Dict[str, LockNode] = field(default_factory=dict)
    class_locks: Dict[str, Dict[str, LockNode]] = field(default_factory=dict)
    # module-level names bound to another lock (`capture_lock = lazyjit.capture_lock`)
    module_aliases: Dict[str, ast.AST] = field(default_factory=dict)


def _lock_factory_kind(call: ast.AST, locks: _ModuleLocks) -> Optional[str]:
    """'Lock'/'RLock'/'Condition' when ``call`` constructs one."""
    if not isinstance(call, ast.Call):
        return None
    name = dotted_name(call.func)
    if name is None:
        return None
    root, _, rest = name.partition(".")
    if root in locks.threading_aliases and rest in _LOCK_FACTORIES:
        return rest
    if not rest and name in locks.factory_aliases:
        return locks.factory_aliases[name]
    return None


def _collect_module_locks(module: SourceModule) -> _ModuleLocks:
    locks = _ModuleLocks()
    if module.tree is None:
        return locks
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "threading":
                    locks.threading_aliases.add(a.asname or "threading")
        elif isinstance(node, ast.ImportFrom) and node.module == "threading":
            for a in node.names:
                if a.name in _LOCK_FACTORIES:
                    locks.factory_aliases[a.asname or a.name] = a.name

    def declare(name: str, cls: Optional[str], call: ast.Call, kind: str) -> None:
        # Condition(existing_lock) shares the wrapped lock's node — and
        # its (non-)reentrancy
        if kind == "Condition" and call.args:
            wrapped = _resolve_static_lock(call.args[0], locks, cls)
            if wrapped is not None:
                target = locks.class_locks.setdefault(cls, {}) if cls else locks.module_locks
                target[name] = wrapped
                return
        qual = f"{module.module_name}.{cls}.{name}" if cls else f"{module.module_name}.{name}"
        node_obj = LockNode(node_id=qual, kind=kind, path=module.path, line=call.lineno)
        if cls:
            locks.class_locks.setdefault(cls, {})[name] = node_obj
        else:
            locks.module_locks[name] = node_obj

    # module-level and class-level assignments; self.attr = ... in methods
    for top in module.tree.body:
        if isinstance(top, ast.Assign) and len(top.targets) == 1:
            target = top.targets[0]
            kind = _lock_factory_kind(top.value, locks)
            if kind and isinstance(target, ast.Name):
                declare(target.id, None, top.value, kind)
            elif isinstance(target, ast.Name) and isinstance(top.value, (ast.Name, ast.Attribute)):
                locks.module_aliases[target.id] = top.value
        elif isinstance(top, ast.ClassDef):
            for item in ast.walk(top):
                if not isinstance(item, ast.Assign) or len(item.targets) != 1:
                    continue
                kind = _lock_factory_kind(item.value, locks)
                if not kind:
                    continue
                target = item.targets[0]
                if isinstance(target, ast.Name):  # class attribute
                    declare(target.id, top.name, item.value, kind)
                elif (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    declare(target.attr, top.name, item.value, kind)
    return locks


def _resolve_static_lock(
    expr: ast.AST, locks: _ModuleLocks, current_class: Optional[str]
) -> Optional[LockNode]:
    """A lock expression (`_lock`, `self._cv`) to its node, else None."""
    if isinstance(expr, ast.Name):
        return locks.module_locks.get(expr.id)
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id in ("self", "cls")
        and current_class
    ):
        return locks.class_locks.get(current_class, {}).get(expr.attr)
    return None


class _FunctionLockWalker:
    """Linear walk of one function: records lock-order edges and the set
    of locks the function may acquire (for transitive call edges)."""

    def __init__(self, analysis: "_ProjectLockAnalysis", decl, module, locks):
        self.analysis = analysis
        self.decl = decl
        self.module = module
        self.locks = locks
        self.current_class = decl.qualname.split(".")[0] if decl.is_method else None
        self.acquired: Set[LockNode] = set()
        self.local_aliases: Dict[str, LockNode] = {}

    # -- resolution ----------------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[LockNode]:
        if isinstance(expr, ast.Name) and expr.id in self.local_aliases:
            return self.local_aliases[expr.id]
        return self.analysis.lock_of(self.module, expr, self.decl.node, self.current_class)

    def _callee_acquires(self, call: ast.Call) -> Tuple[Set[LockNode], str]:
        """Locks a call may acquire (transitively), with a label: a callee
        the graph resolves, a method of a typed receiver (`ch.put(...)`
        where `ch = BoundedChannel(...)`, `self.cache.get(...)`), an
        instance's `__call__`, or a project class's `__init__`."""
        decl = self.analysis.typer.callee(self.module, call, self.decl.node)
        if decl is None:
            return set(), ""
        return self.analysis.acquires(decl), decl.qualname

    # -- the walk ------------------------------------------------------------
    def run(self) -> Set[LockNode]:
        self._block(self.decl.node.body, [])
        return self.acquired

    def _note_acquire(self, node: LockNode, held: List[LockNode], line: int, via: str) -> None:
        self.acquired.add(node)
        for holder in held:
            self.analysis.add_edge(
                holder, node, _EdgeSite(path=self.module.path, line=line, via=via)
            )

    def _scan_calls(self, stmt: ast.stmt, held: List[LockNode]) -> None:
        from . import _astwalk

        for header in _astwalk.header_nodes(stmt):
            for node in ast.walk(header):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr in (
                    "wait",
                    "notify",
                    "notify_all",
                    "locked",
                ):
                    continue  # condition-variable ops on an already-held lock
                if isinstance(func, ast.Attribute) and func.attr in ("acquire", "release"):
                    continue  # handled linearly by _block
                targets, via = self._callee_acquires(node)
                for target in sorted(targets, key=lambda n: n.node_id):
                    self._note_acquire(target, held, node.lineno, via)

    def _block(self, body: Sequence[ast.stmt], held: List[LockNode]) -> None:
        held = list(held)
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # separate scope
            # explicit acquire()/release() pairs, tracked linearly
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                call = stmt.value
                if isinstance(call.func, ast.Attribute) and call.func.attr in (
                    "acquire",
                    "release",
                ):
                    node = self._lock_of(call.func.value)
                    if node is not None:
                        if call.func.attr == "acquire":
                            self._note_acquire(node, held, call.lineno, "")
                            held.append(node)
                        elif node in held:
                            held.remove(node)
                        continue
            self._scan_calls(stmt, held)
            # lock aliases (receiver types come from the typer)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                if isinstance(target, ast.Name):
                    alias = self._lock_of(stmt.value)
                    if alias is not None:
                        self.local_aliases[target.id] = alias
                    else:
                        self.local_aliases.pop(target.id, None)
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                entered: List[LockNode] = []
                for item in stmt.items:
                    node = self._lock_of(item.context_expr)
                    if node is not None:
                        self._note_acquire(node, held, stmt.lineno, "")
                        entered.append(node)
                self._block(stmt.body, held + entered)
                continue
            for block in (
                getattr(stmt, "body", None),
                getattr(stmt, "orelse", None),
                getattr(stmt, "finalbody", None),
            ):
                if block and isinstance(block, list):
                    self._block(block, held)
            for handler in getattr(stmt, "handlers", []) or []:
                self._block(handler.body, held)


class _ProjectLockAnalysis:
    def __init__(self, project, scope_paths: Sequence[str]):
        self.project = project
        self.graph = callgraph.get(project)
        self.typer = _receivers.get(project)
        self.module_locks: Dict[str, _ModuleLocks] = {}
        self._resolving: Set[Tuple[str, int]] = set()
        self.edges: Dict[LockNode, Dict[LockNode, List[_EdgeSite]]] = {}
        self._acquires: Dict[Tuple[str, str], Set[LockNode]] = {}
        self._in_progress: Set[Tuple[str, str]] = set()
        for module in project.modules:
            self.module_locks[module.path] = _collect_module_locks(module)
        # drive the edge collection from every function in scope
        for module in project.modules:
            if not any(
                module.path == p or module.path.startswith(p.rstrip("/") + "/")
                for p in scope_paths
            ):
                continue
            for decl in self.graph.decls_in(module.path).values():
                self.acquires(decl)

    # -- resolution across modules -------------------------------------------
    def _class_lock(self, kind, attr: str) -> Optional[LockNode]:
        for k in self.typer.mro(kind):
            if k.origin == "class":
                node = self.module_locks.get(k.path, _ModuleLocks()).class_locks.get(
                    k.name, {}).get(attr)
                if node is not None:
                    return node
        return None

    def _module_lock(self, module: SourceModule, name: str) -> Optional[LockNode]:
        locks = self.module_locks.get(module.path, _ModuleLocks())
        if name in locks.module_locks:
            return locks.module_locks[name]
        if name in locks.module_aliases:
            return self.lock_of(module, locks.module_aliases[name], None, None)
        return None

    def _dotted_lock(self, full: str) -> Optional[LockNode]:
        """A lock named by an absolute dotted path (`pkg.mod.name`)."""
        mod, _, obj = full.rpartition(".")
        path = self.graph.module_paths.get(mod)
        module = self.project.module_at(path) if path else None
        return self._module_lock(module, obj) if module is not None else None

    def lock_of(self, module: SourceModule, expr: ast.AST, func: Optional[ast.AST],
                current_class: Optional[str]) -> Optional[LockNode]:
        """The lock node `expr` denotes: a module lock (here, imported, or
        bound to another module's: `capture_lock`), `self.attr` of the
        class or a project base, or `obj.attr` of a typed receiver
        (`self.graphs.lock`). A `torch.cuda.graph(...)` or a stream context
        is no lock."""
        key = (module.path, id(expr))
        if key in self._resolving:
            return None
        self._resolving.add(key)
        try:
            locks = self.module_locks.get(module.path, _ModuleLocks())
            node = _resolve_static_lock(expr, locks, current_class)
            if node is not None:
                return node
            aliases = self.typer.aliases(module)
            if isinstance(expr, ast.Name):
                if expr.id in locks.module_aliases:
                    return self._module_lock(module, expr.id)
                full = aliases.get(expr.id)
                return self._dotted_lock(full) if full is not None else None
            if not isinstance(expr, ast.Attribute):
                return None
            name = dotted_name(expr)
            if name is not None and name.split(".")[0] in aliases:
                root, _, rest = name.partition(".")
                return self._dotted_lock(f"{aliases[root]}.{rest}")
            owner = self.typer.kind_of(module, expr.value, func)
            if owner is None or owner.origin != "class":
                return None
            return self._class_lock(owner, expr.attr)
        finally:
            self._resolving.discard(key)

    def add_edge(self, holder: LockNode, target: LockNode, site: _EdgeSite) -> None:
        self.edges.setdefault(holder, {}).setdefault(target, []).append(site)

    def acquires(self, decl) -> Set[LockNode]:
        """Locks ``decl`` may acquire, transitively; memoized and
        cycle-guarded (recursion contributes the empty set)."""
        key = decl.key
        if key in self._acquires:
            return self._acquires[key]
        if key in self._in_progress:
            return set()
        self._in_progress.add(key)
        try:
            module = self.project.module_at(decl.path)
            locks = self.module_locks.get(decl.path, _ModuleLocks())
            walker = _FunctionLockWalker(self, decl, module, locks)
            acquired = walker.run()
        finally:
            self._in_progress.discard(key)
        self._acquires[key] = acquired
        return acquired

    # -- cycle detection -----------------------------------------------------
    def cycles(self) -> List[List[LockNode]]:
        """Elementary cycles worth reporting: one representative per
        strongly-connected component of size > 1, plus non-reentrant
        self-loops."""
        out: List[List[LockNode]] = []
        nodes = sorted(self.edges, key=lambda n: n.node_id)
        for node in nodes:
            sites = self.edges.get(node, {}).get(node)
            if sites and node.kind not in _REENTRANT:
                out.append([node])
        # DFS-based cycle search over the (small) lock graph
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(start: LockNode, current: LockNode, path: List[LockNode]) -> None:
            for nxt in sorted(self.edges.get(current, {}), key=lambda n: n.node_id):
                if nxt == start and len(path) > 1:
                    # canonical rotation for dedup
                    ids = [n.node_id for n in path]
                    pivot = ids.index(min(ids))
                    key = tuple(ids[pivot:] + ids[:pivot])
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(list(path))
                elif nxt not in path and nxt.node_id > start.node_id:
                    # only walk "later" nodes: each cycle found once, from
                    # its smallest member
                    dfs(start, nxt, path + [nxt])

        for node in nodes:
            dfs(node, node, [node])
        return out


@register
class LockOrderRule(Rule):
    id = "lock-order"
    title = "lock-acquisition-order cycles (static deadlock detection)"
    rationale = (
        "Two threads taking the same pair of locks in opposite orders "
        "deadlock on the first adverse interleaving — which no CPU test "
        "schedule may ever produce, and production will. The rule builds "
        "the static lock-acquisition graph over every threading.Lock/"
        "RLock/Condition in the package (with-blocks, acquire/release "
        "pairs, and locks taken inside calls made while holding, resolved "
        "through the project call graph); a cycle, or a re-acquire of a "
        "non-reentrant Lock, is a finding. Acquire locks in one global "
        "order, or split the critical section so no call is made while "
        "holding. The runtime twin is the FLINK_ML_TPU_SANITIZE=1 "
        "recorder (flink_ml_tpu_torch/analysis/sanitizer.py)."
    )
    example = (
        "with self._a:\n"
        "    with self._b: ...   # thread 1: a -> b\n"
        "with self._b:\n"
        "    with self._a: ...   # thread 2: b -> a  -> cycle finding"
    )
    scope = (PACKAGE,)

    def check_project(self, project) -> Iterable[Finding]:
        analysis = _ProjectLockAnalysis(project, self.scope)
        findings: List[Finding] = []
        for cycle in analysis.cycles():
            if len(cycle) == 1:
                node = cycle[0]
                site = sorted(
                    analysis.edges[node][node], key=lambda s: (s.path, s.line)
                )[0]
                via = f" (via {site.via})" if site.via else ""
                findings.append(
                    Finding(
                        path=site.path,
                        line=site.line,
                        rule=self.id,
                        message=(
                            f"non-reentrant lock {node.node_id} ({node.kind}) "
                            f"re-acquired while already held{via} — "
                            "self-deadlock; use an RLock or restructure the "
                            "critical section"
                        ),
                        data=("self-deadlock", node.node_id),
                    )
                )
                continue
            # describe every edge of the cycle, anchor at the first site
            legs = []
            anchor: Optional[_EdgeSite] = None
            for i, node in enumerate(cycle):
                nxt = cycle[(i + 1) % len(cycle)]
                site = sorted(
                    analysis.edges[node][nxt], key=lambda s: (s.path, s.line)
                )[0]
                via = f" via {site.via}" if site.via else ""
                legs.append(
                    f"{node.node_id} -> {nxt.node_id} at {site.path}:{site.line}{via}"
                )
                if anchor is None or (site.path, site.line) < (anchor.path, anchor.line):
                    anchor = site
            order = " -> ".join(n.node_id for n in cycle + [cycle[0]])
            findings.append(
                Finding(
                    path=anchor.path,
                    line=anchor.line,
                    rule=self.id,
                    message=(
                        f"lock-order cycle {order}: "
                        + "; ".join(legs)
                        + " — two threads interleaving these acquisitions "
                        "deadlock; impose one global acquisition order"
                    ),
                    data=("cycle",) + tuple(n.node_id for n in cycle),
                )
            )
        return sorted(findings, key=lambda f: (f.path, f.line, f.message))
