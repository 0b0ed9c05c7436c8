"""The project-wide call graph and its interprocedural taint summaries.

Port of flink_ml_tpu/analysis/callgraph.py, for torch. Known calls are
resolved and summarized; unknown calls launder taint, so the walk
under-approximates and every finding it makes is worth reading:

- **Call resolution** (`CallGraph.resolve`): module-level functions by
  local name, one-hop `from`-imports (`from ..ops import stats` ->
  `stats.fn`), and `self.`/`cls.` method calls within the defining class.
  Anything else stays unknown.
- **Summaries** (`CallGraph.summary`): one bounded-depth, memoized,
  cycle-safe `Summary` a function, saying what it does with its
  parameters: `returns_device` (its result is on the card whatever its
  arguments), `returns_params` (the parameters whose taint flows to its
  result) and `param_syncs` (the parameters that reach a host sync inside
  it, each with the sink's file:line and the call chain down to it), and
  `param_closes` (the parameters, channels, it closes or cancels, itself
  or through a resolved callee: the channel-protocol rule's escape
  analysis).
- **The taint walker** (`TaintWalker`): one linear pass a function over
  *source sets*: a value's sources are `DEVICE` and parameter indices.
  One walk gives both the local events (device-sourced sinks) and the
  summary (parameter-sourced sinks, the return's flow). A call cycle sees
  the empty summary; lifted chains stop at `MAX_CHAIN` hops.

Where taint comes from, in the port: a torch tensor made on a device (a
torch constructor or `.to`/`.cuda` given a device that is not the literal
CPU; made on `X.device`, it has X's sources), the result of a device
funnel (a `lazy_jit`/`keyed_jit` kernel, a sparse kernel's wrapper,
`device_constants`, `stage_to_device`, `page_in`), and any torch call or
tensor method on a tainted value. numpy and the packing funnel
(`utils/packing.packed_device_get`, `packed_bytes_get`) give host values.
A value whose device cannot be told has no sources and raises nothing.

The host syncs (event kinds):

- `pull`: `.item()`, `.tolist()`, `.cpu()` and `.numpy()` of a tainted value;
- `cast`: `float`/`int`/`bool` of a tainted value;
- `branch`: a tainted value as an `if`, `while`, `assert` or conditional
  expression's test (Python asks for its truth: a hidden `bool`);
- `barrier`: `torch.cuda.synchronize()` and any `.synchronize()` (an
  event's or a stream's), always;
- `print`: a tainted value printed (a sync, and host work inside a
  captured body).

A host-sync-leak suppression on a sink line marks the sync `documented`:
callers inherit it in the summary, but host-sync-leak lifts no finding
from it (resident-program still does: a captured body may not sync at
all).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .source import SourceModule, dotted_name

#: source token for "a tensor on the card" (parameter sources are int indices)
DEVICE = "device"

#: the rule whose suppression on a sink line documents the sync (see above)
HOST_SYNC_RULE = "host-sync-leak"

#: lifted call chains stop growing past this many hops (bounded depth)
MAX_CHAIN = 8

#: attribute reads and methods that give host metadata, not device payloads
META_ATTRS = {"shape", "ndim", "dtype", "size", "nbytes", "itemsize", "device", "is_cuda",
              "layout", "numel", "dim", "stride", "element_size", "data_ptr", "is_contiguous",
              "storage_offset", "requires_grad", "get_device", "is_floating_point", "is_sparse",
              "untyped_storage", "__len__"}

#: call targets that give HOST values (clear taint)
HOST_SINKS = {"packed_device_get", "packed_bytes_get", "float", "int", "bool", "len", "str",
              "repr", "isinstance"}

#: tensor methods that copy a device value to the host (a `pull`)
PULL_METHODS = ("item", "tolist", "cpu", "numpy")

#: torch calls that give host objects whatever their arguments
TORCH_HOST_CALLS = ("from_numpy", "device", "Generator", "get_default_dtype", "is_tensor",
                    "Size")

#: the device funnels: their results are on the card
DEVICE_FUNNELS = ("device_constants", "stage_to_device", "page_in")

#: event kinds whose parameter sources fold into the summaries
SYNC_KINDS = ("pull", "cast", "branch", "print")


# ---------------------------------------------------------------------------
# declarations and summaries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FunctionDecl:
    """One statically declared function: a module-level `def` or a method
    (qualname `Class.method`)."""

    path: str  # repo-relative module path
    qualname: str
    params: Tuple[str, ...]  # positional parameter names, in order
    is_method: bool
    node: ast.AST = field(compare=False, hash=False, repr=False)

    @property
    def key(self) -> Tuple[str, str]:
        return (self.path, self.qualname)


@dataclass(frozen=True)
class SyncSite:
    """One host sync a parameter reaches, with the call chain from the
    summarized function down to it (`funcs` qualnames, outermost first;
    empty: the sink is in the summarized function itself)."""

    kind: str  # one of SYNC_KINDS
    detail: str  # item / float / if / ...
    sink_path: str
    sink_line: int
    funcs: Tuple[str, ...] = ()
    documented: bool = False  # a host-sync-leak suppression covers the sink


@dataclass(frozen=True)
class Summary:
    """What a function does with its parameters: the unit the
    interprocedural rules consult instead of laundering at the call."""

    returns_device: bool = False
    returns_params: FrozenSet[int] = frozenset()
    param_syncs: Tuple[Tuple[int, Tuple[SyncSite, ...]], ...] = ()
    param_closes: FrozenSet[int] = frozenset()


EMPTY_SUMMARY = Summary()


@dataclass
class SyncEvent:
    """One host sync seen while walking a function, with the source set of
    the value it syncs. `DEVICE` sources become findings; parameter
    sources become summary entries."""

    line: int
    kind: str
    detail: str
    sources: FrozenSet
    sink_path: str
    sink_line: int
    funcs: Tuple[str, ...] = ()  # lifted call chain (empty = direct sink)
    documented: bool = False


@dataclass
class FunctionAnalysis:
    decl: Optional[FunctionDecl]
    events: List[SyncEvent]
    summary: Summary


# ---------------------------------------------------------------------------
# the call graph
# ---------------------------------------------------------------------------

class CallGraph:
    """Declarations, resolution and memoized per-function analyses over
    one `engine.Project`."""

    def __init__(self, project):
        from .rules import _jitindex  # deferred: rules/ imports this module

        self.project = project
        self.jitindex = _jitindex.jit_index(project)
        # path -> {qualname: decl}
        self.by_module: Dict[str, Dict[str, FunctionDecl]] = {}
        # dotted module name -> path
        self.module_paths: Dict[str, str] = {}
        self._analyses: Dict[Tuple[str, str], FunctionAnalysis] = {}
        self._in_progress: Set[Tuple[str, str]] = set()
        for module in project.modules:
            self._declare(module)

    # -- declarations --------------------------------------------------------
    def _declare(self, module: SourceModule) -> None:
        table: Dict[str, FunctionDecl] = {}
        if module.tree is not None:
            for node in module.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    table[node.name] = self.decl(module, node, node.name, False)
                elif isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            table[f"{node.name}.{item.name}"] = self.decl(
                                module, item, f"{node.name}.{item.name}", True)
        self.by_module[module.path] = table
        if module.module_name:
            self.module_paths[module.module_name] = module.path

    @staticmethod
    def decl(module, node, qualname, is_method) -> FunctionDecl:
        """The declaration of the def `node` of `module` (a nested def's
        too, which the module tables leave out)."""
        params = tuple(a.arg for a in list(node.args.posonlyargs) + list(node.args.args))
        return FunctionDecl(path=module.path, qualname=qualname, params=params,
                            is_method=is_method, node=node)

    def decls_in(self, path: str) -> Dict[str, FunctionDecl]:
        return self.by_module.get(path, {})

    # -- resolution ----------------------------------------------------------
    def resolve(self, module: SourceModule, func: ast.AST,
                current_class: Optional[str] = None) -> Optional[Tuple[FunctionDecl, bool]]:
        """Resolve a call target to its declaration. Returns `(decl,
        skip_self)` (`skip_self`: the call's positional arguments start at
        the decl's second parameter, a bound-method call) or None for
        anything not statically resolvable."""
        info = self.jitindex.get(module.path)
        table = self.by_module.get(module.path, {})
        if isinstance(func, ast.Name):
            decl = table.get(func.id)
            if decl is not None and not decl.is_method:
                return decl, False
            if info is not None and func.id in info.imports:
                target_module, original = info.imports[func.id]
                target_path = self.module_paths.get(target_module)
                if target_path is not None:
                    decl = self.by_module.get(target_path, {}).get(original)
                    if decl is not None and not decl.is_method:
                        return decl, False
            return None
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            root = func.value.id
            if root in ("self", "cls") and current_class:
                decl = table.get(f"{current_class}.{func.attr}")
                if decl is not None:
                    return decl, True
                return None
            # module-alias attribute: `from ..ops import stats; stats.fn(...)`
            if info is not None and root in info.imports:
                target_module, original = info.imports[root]
                target_path = self.module_paths.get(f"{target_module}.{original}")
                if target_path is not None:
                    decl = self.by_module.get(target_path, {}).get(func.attr)
                    if decl is not None and not decl.is_method:
                        return decl, False
        return None

    def reachable(self, roots: Iterable[FunctionDecl],
                  cha_paths: Optional[Sequence[str]] = None) -> Dict[Tuple[str, str], str]:
        """Breadth-first over the call graph from `roots`: decl key -> the
        chain that found it (root first). Besides resolved calls, an
        attribute call `x.m(...)` reaches every method named `m` declared
        in `cha_paths` (every module when None): class-hierarchy lifting,
        an over-approximation, so a call behind an unresolvable receiver
        is not missed."""
        cha: Dict[str, List[FunctionDecl]] = {}
        for path in (self.by_module if cha_paths is None else cha_paths):
            for qualname, decl in self.by_module.get(path, {}).items():
                if decl.is_method:
                    cha.setdefault(qualname.rsplit(".", 1)[-1], []).append(decl)
        seen: Dict[Tuple[str, str], str] = {}
        queue: List[FunctionDecl] = []
        for decl in roots:
            if decl.key not in seen:
                seen[decl.key] = ""
                queue.append(decl)
        while queue:
            decl = queue.pop(0)
            module = self.project.module_at(decl.path)
            if module is None:
                continue
            chain = seen[decl.key]
            child_chain = f"{chain} -> {decl.qualname}" if chain else decl.qualname
            current_class = decl.qualname.split(".")[0] if decl.is_method else None
            callees: List[FunctionDecl] = []
            for node in ast.walk(decl.node):
                if not isinstance(node, ast.Call):
                    continue
                resolved = self.resolve(module, node.func, current_class)
                if resolved is not None:
                    callees.append(resolved[0])
                elif isinstance(node.func, ast.Attribute):
                    callees.extend(cha.get(node.func.attr, ()))
            for callee in callees:
                if callee.key not in seen:
                    seen[callee.key] = child_chain
                    queue.append(callee)
        return seen

    # -- analysis ------------------------------------------------------------
    def analyze(self, decl: FunctionDecl) -> FunctionAnalysis:
        """Walk `decl` once, giving its local sync events AND its summary.
        Memoized; a call cycle sees the empty summary. With a prepared
        `cache.SummaryCache` on the project, an unchanged module's analyses
        are read from it instead of walked."""
        cached = self._analyses.get(decl.key)
        if cached is not None:
            return cached
        summary_cache = getattr(self.project, "summary_cache", None)
        if summary_cache is not None:
            entry = summary_cache.lookup(decl.path, decl.qualname)
            if entry is not None:
                events, summary = entry
                analysis = FunctionAnalysis(decl, events, summary)
                self._analyses[decl.key] = analysis
                return analysis
        if decl.key in self._in_progress:
            return FunctionAnalysis(decl, [], EMPTY_SUMMARY)
        self._in_progress.add(decl.key)
        try:
            module = self.project.module_at(decl.path)
            params = list(decl.params)
            current_class = None
            if decl.is_method:
                current_class = decl.qualname.split(".")[0]
                if params and params[0] in ("self", "cls"):
                    params = params[1:]
            walker = TaintWalker(graph=self, module=module, info=self.jitindex.get(decl.path),
                                 params={name: i for i, name in enumerate(params)},
                                 current_class=current_class)
            walker.run_block(decl.node.body)
            analysis = FunctionAnalysis(decl=decl, events=walker.events,
                                        summary=walker.build_summary())
        finally:
            self._in_progress.discard(decl.key)
        self._analyses[decl.key] = analysis
        return analysis

    def summary(self, decl: FunctionDecl) -> Summary:
        return self.analyze(decl).summary


def device_like(node: ast.AST) -> bool:
    """Does `.to(node)` move to a device (rather than cast a dtype)?"""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    if isinstance(node, ast.Name):
        return node.id == "dev" or node.id.endswith("device")
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return name.split(".")[-1] == "device"
    return False


def get(project) -> CallGraph:
    """The project's memoized call graph (shared across rules)."""
    return project.index("callgraph", CallGraph)


def own_params(decl: FunctionDecl) -> Tuple[str, ...]:
    """A declaration's parameters as the walker indexes them (no self/cls)."""
    params = decl.params
    if decl.is_method and params and params[0] in ("self", "cls"):
        return params[1:]
    return params


# ---------------------------------------------------------------------------
# the source-set taint walker
# ---------------------------------------------------------------------------

class TaintWalker:
    """Linear taint pass over one function body (or the module level),
    tracking *source sets* a name: `DEVICE` and/or parameter indices.
    With `graph=None` every call is unknown and launders."""

    def __init__(self, graph: Optional[CallGraph], module: SourceModule, info,
                 params: Optional[Dict[str, int]] = None,
                 current_class: Optional[str] = None):
        self.graph = graph
        self.module = module
        self.info = info
        self.current_class = current_class
        self.env: Dict[str, FrozenSet] = {
            name: frozenset({index}) for name, index in (params or {}).items()}
        self.events: List[SyncEvent] = []
        self.returns: Set = set()
        self._param_syncs: Dict[int, List[SyncSite]] = {}
        self._param_closes: Set[int] = set()

    # -- summary assembly ----------------------------------------------------
    def build_summary(self) -> Summary:
        documented_lines = set(self.module.suppressions_for(HOST_SYNC_RULE))
        for event in self.events:
            if not event.funcs:
                event.documented = event.sink_line in documented_lines
            for source in event.sources:
                if source == DEVICE or event.kind not in SYNC_KINDS:
                    continue
                self._param_syncs.setdefault(source, []).append(SyncSite(
                    kind=event.kind, detail=event.detail, sink_path=event.sink_path,
                    sink_line=event.sink_line, funcs=event.funcs,
                    documented=event.documented))
        return Summary(
            returns_device=DEVICE in self.returns,
            returns_params=frozenset(s for s in self.returns if s != DEVICE),
            param_syncs=tuple((i, tuple(sites)) for i, sites in sorted(self._param_syncs.items())),
            param_closes=frozenset(self._param_closes))

    # -- source evaluation ---------------------------------------------------
    def sources(self, node: ast.AST) -> FrozenSet:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, frozenset())
        if isinstance(node, ast.Call):
            return self.call_sources(node)
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                return frozenset()
            return self.sources(node.value)
        if isinstance(node, ast.Subscript):
            return self.sources(node.value)
        if isinstance(node, ast.BinOp):
            return self.sources(node.left) | self.sources(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.sources(node.operand)
        if isinstance(node, ast.BoolOp):
            return self._union(node.values)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return frozenset()
            return self._union([node.left] + list(node.comparators))
        if isinstance(node, ast.IfExp):
            return self.sources(node.body) | self.sources(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return self._union(node.elts)
        if isinstance(node, ast.Dict):
            return self._union(node.values)
        if isinstance(node, ast.Starred):
            return self.sources(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.sources(node.value)
        return frozenset()

    def _union(self, nodes) -> FrozenSet:
        out: FrozenSet = frozenset()
        for node in nodes:
            if node is not None:
                out |= self.sources(node)
        return out

    def device_sources(self, node: ast.AST) -> FrozenSet:
        """The sources of a tensor made on the device `node` denotes: none
        for the literal CPU, the owner's for `X.device`, else `DEVICE`."""
        if isinstance(node, ast.Constant):
            if node.value is None or str(node.value).startswith("cpu"):
                return frozenset()
            return frozenset({DEVICE})
        if isinstance(node, ast.Call) and dotted_name(node.func) in ("torch.device", "device") \
                and node.args and isinstance(node.args[0], ast.Constant):
            return self.device_sources(node.args[0])
        if isinstance(node, ast.Attribute) and node.attr == "device":
            return self.sources(node.value)
        return frozenset({DEVICE})

    def _arg_sources(self, call: ast.Call, index: int, decl, skip_self) -> FrozenSet:
        """Sources of the value bound to the callee's parameter `index`
        (indices count AFTER self for method calls)."""
        args = call.args
        if index < len(args):
            arg = args[index]
            if isinstance(arg, ast.Starred):
                return frozenset()
            return self.sources(arg)
        params = list(decl.params)
        if skip_self and params and params[0] in ("self", "cls"):
            params = params[1:]
        if index < len(params):
            name = params[index]
            for kw in call.keywords:
                if kw.arg == name:
                    return self.sources(kw.value)
        return frozenset()

    def call_sources(self, call: ast.Call) -> FrozenSet:
        func = call.func
        name = dotted_name(func)
        info = self.info
        if name is not None:
            base = name.split(".")[-1]
            root = name.split(".")[0]
            if base in HOST_SINKS or root in info.np_aliases:
                return frozenset()  # host values; numpy gives host arrays
            if info.is_device_kernel(func) or base in DEVICE_FUNNELS:
                return frozenset({DEVICE})
            if info.torch_call(func):
                if base in TORCH_HOST_CALLS or name.split(".")[1:2] == ["cuda"]:
                    return frozenset()
                for kw in call.keywords:
                    if kw.arg == "device":
                        return self.device_sources(kw.value)
                return self._union(list(call.args) + [kw.value for kw in call.keywords])
        # a keyed factory's double call: kernel_for(key)(X), or lazy_jit(f)(X)
        if isinstance(func, ast.Call):
            inner = dotted_name(func.func)
            if inner is not None and (inner in info.factories or info.is_jit_callable(func.func)):
                return frozenset({DEVICE})
        # known callee: taint flows per the summary instead of laundering
        resolved = self._resolve(call)
        if resolved is not None:
            decl, skip_self = resolved
            summary = self.graph.summary(decl)
            out: Set = set()
            if summary.returns_device:
                out.add(DEVICE)
            for index in summary.returns_params:
                out |= self._arg_sources(call, index, decl, skip_self)
            return frozenset(out)
        if isinstance(func, ast.Attribute):
            if func.attr == "cuda":
                return frozenset({DEVICE})
            if func.attr == "to":
                target = next((kw.value for kw in call.keywords if kw.arg == "device"),
                              call.args[0] if call.args else None)
                if target is not None and device_like(target):
                    return self.device_sources(target)
            # x.method() where x carries sources: a tensor method stays on
            # x's device; a parameter's method result keeps its sources
            if func.attr not in META_ATTRS and func.attr not in PULL_METHODS:
                return self.sources(func.value)
        return frozenset()

    def _resolve(self, call: ast.Call):
        if self.graph is None:
            return None
        # wrapped kernels and factories are device producers, not
        # summarizable host code (their bodies run inside a graph)
        name = dotted_name(call.func)
        if name is not None and (name in self.info.kernels or name in self.info.factories):
            return None
        return self.graph.resolve(self.module, call.func, self.current_class)

    # -- statement handling --------------------------------------------------
    def assign(self, target: ast.AST, value_sources: FrozenSet) -> None:
        if isinstance(target, ast.Name):
            if value_sources:
                self.env[target.id] = value_sources
            else:
                self.env.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.assign(elt.value if isinstance(elt, ast.Starred) else elt, value_sources)

    def run_block(self, body) -> None:
        for stmt in body:
            self.run_statement(stmt)

    def run_statement(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # separate scope, analyzed on its own
        self.scan_expressions(stmt)
        if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
            self.check_test(stmt.test, "assert" if isinstance(stmt, ast.Assert)
                            else type(stmt).__name__.lower())
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.returns |= self.sources(stmt.value)
        elif isinstance(stmt, ast.Assign):
            value_sources = self.sources(stmt.value)
            for target in stmt.targets:
                if (isinstance(target, ast.Tuple) and isinstance(stmt.value, ast.Tuple)
                        and len(target.elts) == len(stmt.value.elts)
                        and not any(isinstance(e, ast.Starred) for e in target.elts)):
                    # `a, b = x, y`: each name takes its own value's sources
                    for elt, value in zip(target.elts, stmt.value.elts):
                        self.assign(elt, self.sources(value))
                else:
                    self.assign(target, value_sources)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self.assign(stmt.target, self.sources(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name):
                merged = self.sources(stmt.value) | self.sources(stmt.target)
                if merged:
                    self.env[stmt.target.id] = merged
        elif isinstance(stmt, ast.For):
            self.assign(stmt.target, self.sources(stmt.iter))
            self.run_block(stmt.body)
            self.run_block(stmt.orelse)
            return
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, self.sources(item.context_expr))
            self.run_block(stmt.body)
            return
        for block in (getattr(stmt, "body", None), getattr(stmt, "orelse", None),
                      getattr(stmt, "finalbody", None)):
            if block and isinstance(block, list):
                self.run_block(block)
        for handler in getattr(stmt, "handlers", []) or []:
            self.run_block(handler.body)

    # -- sink detection ------------------------------------------------------
    def scan_expressions(self, stmt: ast.stmt) -> None:
        from .rules import _astwalk

        for header in _astwalk.header_nodes(stmt):
            for node in ast.walk(header):
                if isinstance(node, ast.Call):
                    self.check_call(node)
                elif isinstance(node, ast.IfExp):
                    self.check_test(node.test, "if-expression")

    def check_test(self, test: ast.AST, detail: str) -> None:
        """A value whose truth Python asks for: a hidden bool()."""
        sources = self.sources(test)
        if sources:
            self._emit(test.lineno, "branch", detail, sources)

    def _emit(self, line: int, kind: str, detail: str, sources: FrozenSet,
              sink_path: Optional[str] = None, sink_line: Optional[int] = None,
              funcs: Tuple[str, ...] = (), documented: bool = False) -> None:
        self.events.append(SyncEvent(
            line=line, kind=kind, detail=detail, sources=sources,
            sink_path=sink_path if sink_path is not None else self.module.path,
            sink_line=sink_line if sink_line is not None else line, funcs=funcs,
            documented=documented))

    def check_call(self, call: ast.Call) -> None:
        func = call.func
        name = dotted_name(func)

        # a channel closed or cancelled through a parameter
        if isinstance(func, ast.Attribute) and func.attr in ("close", "cancel"):
            self._param_closes.update(s for s in self.sources(func.value) if s != DEVICE)

        # a barrier: torch.cuda.synchronize(), an event's or a stream's
        # synchronize(); always a local finding, never lifted
        if isinstance(func, ast.Attribute) and func.attr == "synchronize":
            self._emit(call.lineno, "barrier", name or "synchronize", frozenset({DEVICE}))
            return

        # a tensor method that copies to the host
        if isinstance(func, ast.Attribute) and func.attr in PULL_METHODS and not call.args:
            arg_sources = self.sources(func.value)
            if arg_sources:
                self._emit(call.lineno, "pull", func.attr, arg_sources)

        if name in ("float", "int", "bool") and call.args:
            arg_sources = self.sources(call.args[0])
            if arg_sources:
                self._emit(call.lineno, "cast", name, arg_sources)
        elif name == "print":
            arg_sources = self._union(call.args)
            if arg_sources:
                self._emit(call.lineno, "print", "print", arg_sources)

        # interprocedural lifting: consult the callee's summary
        resolved = self._resolve(call)
        if resolved is None:
            return
        decl, skip_self = resolved
        summary = self.graph.summary(decl)
        for index, sites in summary.param_syncs:
            arg_sources = self._arg_sources(call, index, decl, skip_self)
            if not arg_sources:
                continue
            for site in sites:
                if len(site.funcs) >= MAX_CHAIN:
                    continue  # bounded depth: stop lifting runaway chains
                self._emit(call.lineno, site.kind, site.detail, arg_sources,
                           sink_path=site.sink_path, sink_line=site.sink_line,
                           funcs=(decl.qualname,) + site.funcs, documented=site.documented)
        for index in summary.param_closes:
            arg_sources = self._arg_sources(call, index, decl, skip_self)
            self._param_closes.update(s for s in arg_sources if s != DEVICE)
