"""channel-protocol: the flow.BoundedChannel lifecycle contract, statically.

Port of flink_ml_tpu/analysis/rules/channelprotocol.py, on the port's
`flow` API (`BoundedChannel`, `pump`, `spawn`, `close`, `cancel`: the
same names). A worker that can fail must close its channel with the
error (so the consumer re-raises instead of blocking on a silently dead
producer), every channel must end closed, cancelled or drained, and the
serving push API pairs `submit()` with a `results()` consumer loop.
Three checks:

- **spawn workers close on all paths**: for every `flow.spawn(fn, ...)`,
  the worker `fn` (a module function, a `self._run` method, or, in the
  port, a def nested in the spawning function, which the JAX rule leaves
  unchecked) must reach a channel `close()`/`cancel()`, itself or through
  a call the graph resolves, and cover its error path: a top-level `try`
  whose `finally` or handler reaches a close (`serving._run` is the
  model). `flow.pump` needs no check at its call sites: its worker IS the
  close-with-error implementation.
- **channels are drained, closed or cancelled**: a local
  `flow.BoundedChannel(...)` must, within its function, be iterated,
  closed or cancelled, handed to `flow.pump`, or passed to a call whose
  summary (`callgraph.Summary.param_closes`) closes that parameter. A
  channel that escapes (returned, yielded, stored on `self`, passed to an
  unresolvable call) gets the benefit of the doubt.
- **submit() pairs with results()**: a module that calls `.submit(...)`
  but never touches `.results` leaves retired requests parked in the
  results channel until the dispatch worker blocks.

A deliberate exception carries `# tpulint: disable=channel-protocol --
<why>`.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .. import callgraph
from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name
from . import _receivers
from ._astwalk import statements_in_order

_CLOSERS = ("close", "close_with_error", "cancel")
FLOW_MODULE = f"{PACKAGE}.flow"


def _flow_call(module: SourceModule, info, call: ast.Call, names: Tuple[str, ...]) -> Optional[str]:
    """'spawn'/'pump'/'BoundedChannel' when `call` targets that symbol of
    the port's flow.py, as `from .. import flow; flow.spawn(...)` or
    `from ..flow import spawn`."""
    name = dotted_name(call.func)
    if name is None:
        return None
    root, _, rest = name.partition(".")
    if info is not None and root in info.imports:
        target_module, original = info.imports[root]
        # module alias: flow.spawn
        if not rest.count(".") and rest in names:
            dotted = f"{target_module}.{original}"
            if dotted == FLOW_MODULE or dotted.endswith(".flow"):
                return rest
        # symbol import: spawn(...)
        if not rest and original in names:
            if target_module == FLOW_MODULE or target_module.endswith(".flow"):
                return original
    return None


def _contains_close(node: ast.AST) -> bool:
    """A `.close(...)`/`.cancel(...)` call syntactically inside ``node``
    (nested defs excluded are fine here: a worker defining a closure that
    closes still owns the close)."""
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _CLOSERS
        ):
            return True
    return False


class _WorkerCheck:
    """Does a spawn worker reach close() on all paths?"""

    def __init__(self, graph: callgraph.CallGraph, project):
        self.graph = graph
        self.project = project

    def _reaches_close(self, decl, depth: int = 0, node: Optional[ast.AST] = None,
                       current_class: Optional[str] = None) -> bool:
        """close()/cancel() reachable from `node` (default: the whole
        body), following calls the graph resolves, bounded depth.
        `current_class`: the class whose `self` a nested worker sees."""
        if depth > 4:
            return False
        roots = [node] if node is not None else list(decl.node.body)
        module = self.project.module_at(decl.path)
        if decl.is_method:
            current_class = decl.qualname.split(".")[0]
        for root in roots:
            for sub in ast.walk(root):
                if not isinstance(sub, ast.Call):
                    continue
                if (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _CLOSERS
                ):
                    return True
                resolved = self.graph.resolve(module, sub.func, current_class)
                if resolved is not None:
                    callee, _ = resolved
                    if callee.key != decl.key and self._reaches_close(
                        callee, depth + 1
                    ):
                        return True
        return False

    def _error_path_covered(self, decl, current_class: Optional[str]) -> bool:
        """The worker survives its own death: a top-level try whose
        finally or a broad handler reaches a close."""
        for stmt in decl.node.body:
            if not isinstance(stmt, ast.Try):
                continue
            for block in [stmt.finalbody] + [h.body for h in stmt.handlers]:
                for inner in block or []:
                    if self._reaches_close(decl, node=inner, current_class=current_class):
                        return True
                    # handler bodies often just call self._fail() etc.
        return False

    def check(self, decl, current_class: Optional[str] = None) -> Optional[str]:
        if not self._reaches_close(decl, current_class=current_class):
            return (
                "spawn worker never closes a channel — a consumer blocked on "
                "its output waits forever once this worker dies or returns; "
                "close()/close(error=...) the channel on every exit path "
                "(or use flow.pump, which owns that contract)"
            )
        if not self._error_path_covered(decl, current_class):
            return (
                "spawn worker closes its channel only on the happy path — "
                "wrap the body in try/except so a worker error reaches "
                "close(error=...) (or finally: cancel()); a dead worker "
                "must never silently strand its consumer"
            )
        return None


@register
class ChannelProtocolRule(Rule):
    id = "channel-protocol"
    title = "flow channel lifecycle: close-on-all-paths, drain-or-cancel, submit/results pairing"
    rationale = (
        "flow.BoundedChannel's error contract only works when every "
        "producer closes (with the error) and every consumer drains or "
        "cancels: a worker that returns without closing reintroduces the "
        "silently-dead-producer stall, an undrained channel strands its "
        "blocked producer, and submit() without a results() loop parks "
        "retired requests until the dispatch worker blocks. The rule "
        "checks all three statically, resolving workers and "
        "channel-closing helpers through the project call graph."
    )
    example = (
        "def _run(self):\n"
        "    for item in self._requests:\n"
        "        self._out.put(work(item))\n"
        "    self._out.close()   # finding: no close on the error path\n"
        "flow.spawn(self._run, name='worker')"
    )
    scope = (PACKAGE,)
    # flow.py implements the contract (pump's close-with-error worker)
    exclude = (f"{PACKAGE}/flow.py",)

    def check_module(self, project, module: SourceModule) -> Iterable[Finding]:
        if module.tree is None:
            return ()
        graph = callgraph.get(project)
        typer = _receivers.get(project)
        info = graph.jitindex.get(module.path)
        findings: List[Finding] = []
        worker_check = _WorkerCheck(graph, project)

        # -- spawn workers ---------------------------------------------------
        checked_workers: Set[Tuple[str, str]] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _flow_call(module, info, node, ("spawn",))
            if kind != "spawn" or not node.args:
                continue
            worker_expr = node.args[0]
            enclosing, current_class = typer.scope(module, node)
            resolved = graph.resolve(module, worker_expr, current_class)
            decl = resolved[0] if resolved is not None else self._nested_worker(
                graph, module, enclosing, worker_expr)
            if decl is None:
                continue  # dynamic worker: benefit of the doubt
            if decl.key in checked_workers:
                continue
            checked_workers.add(decl.key)
            message = worker_check.check(decl, current_class)
            if message:
                findings.append(
                    Finding(
                        path=module.path,
                        line=node.lineno,
                        rule=self.id,
                        message=f"{decl.qualname}: {message}",
                        data=("worker", decl.qualname),
                    )
                )

        # -- channel constructions drained/closed ----------------------------
        for decl in graph.decls_in(module.path).values():
            findings.extend(self._check_channels(graph, module, info, decl))

        # -- submit/results pairing ------------------------------------------
        submit_line = None
        has_results = False
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "submit"
            ):
                if submit_line is None:
                    submit_line = node.lineno
            if isinstance(node, ast.Attribute) and node.attr == "results":
                has_results = True
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name in (
                "submit",
                "results",
            ):
                has_results = True  # the defining module (serving.py itself)
        if submit_line is not None and not has_results:
            findings.append(
                Finding(
                    path=module.path,
                    line=submit_line,
                    rule=self.id,
                    message=(
                        "submit() without a results() consumer loop — retired "
                        "requests park in the results channel until the "
                        "dispatch worker blocks; iterate results() (or close "
                        "the server) in the same component"
                    ),
                    data=("submit-without-results",),
                )
            )
        return findings

    @staticmethod
    def _nested_worker(graph, module, enclosing, worker_expr):
        """The decl of a worker defined inside the spawning function (the
        JAX rule leaves such workers unchecked)."""
        if enclosing is None or not isinstance(worker_expr, ast.Name):
            return None
        for sub in ast.walk(enclosing):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    sub.name == worker_expr.id and sub is not enclosing:
                return graph.decl(module, sub, f"{enclosing.name}.<locals>.{sub.name}", False)
        return None

    def _check_channels(
        self, graph, module, info, decl
    ) -> Iterable[Finding]:
        current_class = decl.qualname.split(".")[0] if decl.is_method else None
        statements = statements_in_order(decl.node.body)
        # channel name -> construction line
        channels: Dict[str, int] = {}
        satisfied: Set[str] = set()
        escaped: Set[str] = set()
        for stmt in statements:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                if isinstance(target, ast.Name) and isinstance(stmt.value, ast.Call):
                    if _flow_call(module, info, stmt.value, ("BoundedChannel",)):
                        channels[target.id] = stmt.lineno
                        satisfied.discard(target.id)
                        escaped.discard(target.id)
                        continue
                # ch2 = ch aliasing or self._x = ch escapes
                if isinstance(stmt.value, ast.Name) and stmt.value.id in channels:
                    escaped.add(stmt.value.id)
            if not channels:
                continue
            for node in ast.walk(stmt):
                # close/cancel/iteration
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _CLOSERS
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in channels
                ):
                    satisfied.add(node.func.value.id)
                elif isinstance(node, ast.Call):
                    kind = _flow_call(module, info, node, ("pump",))
                    chan_args = [
                        a for a in node.args if isinstance(a, ast.Name) and a.id in channels
                    ]
                    if kind == "pump":
                        for a in chan_args:
                            satisfied.add(a.id)
                        continue
                    if not chan_args:
                        continue
                    resolved = graph.resolve(module, node.func, current_class)
                    if resolved is None:
                        for a in chan_args:  # unknown call: benefit of doubt
                            escaped.add(a.id)
                        continue
                    callee, skip_self = resolved
                    closes = graph.summary(callee).param_closes
                    for index, arg in enumerate(node.args):
                        if (
                            isinstance(arg, ast.Name)
                            and arg.id in channels
                        ):
                            if index in closes:
                                satisfied.add(arg.id)
                            else:
                                escaped.add(arg.id)
                elif isinstance(node, ast.YieldFrom) and isinstance(node.value, ast.Name):
                    if node.value.id in channels:
                        satisfied.add(node.value.id)
                elif isinstance(node, (ast.Return, ast.Yield)) and node.value is not None:
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name) and sub.id in channels:
                            escaped.add(sub.id)
                elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store):
                    pass
            if isinstance(stmt, ast.For) and isinstance(stmt.iter, ast.Name):
                if stmt.iter.id in channels:
                    satisfied.add(stmt.iter.id)
            # self.attr = ch escape
            if isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if isinstance(target, ast.Attribute) and isinstance(
                        stmt.value, ast.Name
                    ):
                        if stmt.value.id in channels:
                            escaped.add(stmt.value.id)
        for name, line in sorted(channels.items(), key=lambda kv: kv[1]):
            if name in satisfied or name in escaped:
                continue
            yield Finding(
                path=module.path,
                line=line,
                rule=self.id,
                message=(
                    f"channel {name!r} is never drained, closed, or cancelled "
                    "in this function — a producer blocked on its credits "
                    "waits forever; iterate it, close()/cancel() it, or hand "
                    "it to flow.pump"
                ),
                data=("undrained-channel", name),
            )
