"""untimed-wait: indefinite blocking calls outside the flow layer.

Port of flink_ml_tpu/analysis/rules/untimedwait.py. A `Condition.wait()`,
`Event.wait()`, `Thread.join()` or queue/channel `.get()` without a
timeout bets a thread's liveness on a peer it cannot observe: when the
peer dies or wedges, the waiter hangs forever and no counter moves.
`flow.py` is the one sanctioned home of indefinite waits (its channel
protocol pairs every wait with a close/cancel wake-up); everywhere else a
blocking call carries a timeout (looped if the wait is long) or a
suppression saying what guarantees the wake-up.

The JAX rule reads every bare `.wait()` as a thread wait. In the port a
`wait()` is often no such thing, so this rule asks what the receiver is
(`_receivers.Typer`: its constructor, its annotation, its class in the
module or through the call graph):

- a `threading` primitive's `wait()`/`join()` with no timeout, and a
  receiver of unknown type (as in JAX), is flagged;
- every other `join()` with no timeout is flagged, as in JAX (a queue's,
  a process's, a project `Thread` subclass's), but for a project class
  whose own `join` reaches no thread wait;
- a project class's `wait()` is flagged only when its own `wait` method
  reaches a thread wait: `prefetch.Staged.wait()` (a `stream.wait_event`,
  which does not block the host) is not, and neither is
  `serving._Readback.wait()`, whose `event.synchronize()` host-sync-leak
  already counts;
- a torch object's `wait()` (a CUDA event's stream wait) and any
  `synchronize()` belong to host-sync-leak and are not counted twice;
- `x.get()` with no argument is flagged when `x` is a queue or a
  `flow.BoundedChannel`; a receiver of unknown type falls back on the
  JAX rule's name test (`*queue`, `*channel`, `*window`, `*_q`).

Suppress a wait whose wake-up is structurally guaranteed with
`# tpulint: disable=untimed-wait -- <what guarantees the wake-up>`.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional

from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule
from . import _receivers

#: receiver names that read as queues when their type is unknown (JAX's test)
_QUEUEISH_NAME = re.compile(r"(queue|channel|chan|window)$|_q$|^q$", re.I)

_BLOCKING = ("wait", "join", "get")


def _timeout_given(node: ast.Call) -> bool:
    """Does this call pass any deadline? A positional argument counts (the
    first parameter of wait and join IS the timeout); `timeout=None` does
    not."""
    for kw in node.keywords:
        if kw.arg == "timeout":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
    return bool(node.args)


def _terminal_name(expr: ast.expr) -> str:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


class _Judge:
    """Is a blocking call a thread wait, by its receiver's type?"""

    def __init__(self, typer: _receivers.Typer):
        self.typer = typer
        self._method_blocks = {}

    def blocks(self, module: SourceModule, call: ast.Call, depth: int = 0) -> Optional[str]:
        """"wait", "join" or "get" when `call` blocks a thread with no
        deadline, else None."""
        func = call.func
        if not isinstance(func, ast.Attribute) or func.attr not in _BLOCKING:
            return None
        meth = func.attr
        kind = self.typer.kind_of(module, func.value)
        if meth == "get":
            if call.args or call.keywords:
                return None
            if kind is not None:
                return "get" if kind.queue_like else None
            return "get" if _QUEUEISH_NAME.search(_terminal_name(func.value)) else None
        if _timeout_given(call):
            return None
        if kind is None or kind.origin == "threading":
            return meth
        if kind.origin == "class":
            if any(k.origin == "threading" for k in self.typer.mro(kind)):
                return meth
            decl = self.typer.method(kind, meth)
            if decl is None:  # a join of unknown meaning blocks, as in JAX
                return meth if meth == "join" else None
            return meth if self._reaches_wait(decl, depth) else None
        # any other bare join (a queue's, a process's) blocks, as in JAX
        return meth if meth == "join" else None

    def _reaches_wait(self, decl, depth: int) -> bool:
        """Does a project method block a thread (a thread wait in its body,
        outside flow.py), to a bounded depth?"""
        if decl.key in self._method_blocks:
            return self._method_blocks[decl.key]
        self._method_blocks[decl.key] = False  # a cycle blocks nothing
        module = self.typer.project.module_at(decl.path)
        found = depth < 3 and module is not None and not decl.path.endswith("/flow.py") and any(
            isinstance(node, ast.Call) and self.blocks(module, node, depth + 1)
            for node in ast.walk(decl.node))
        self._method_blocks[decl.key] = found
        return found


_MESSAGES = {
    "wait": "untimed .wait() — blocks forever if the notifier dies; pass a timeout and loop",
    "join": ("untimed .join() — outlives a wedged worker forever; pass join(timeout=...) and "
             "check is_alive()"),
}


@register
class UntimedWaitRule(Rule):
    id = "untimed-wait"
    title = "indefinite blocking calls outside the flow layer"
    rationale = (
        "A wait()/join()/get() without a timeout bets a thread's liveness on a peer it cannot "
        "observe: when the peer dies or wedges, the waiter hangs forever and no counter moves. "
        "flow.py is the sanctioned home for indefinite waits (its channel protocol pairs every "
        "wait with a close/cancel wake-up); everywhere else, pass a timeout and loop, or "
        "suppress WITH the reason that guarantees the wake-up. The receiver's type decides: a "
        "Staged.wait() orders a stream and a CUDA event's wait or synchronize() is "
        "host-sync-leak's, so neither is counted here."
    )
    example = "done.wait()  # use done.wait(timeout) in a loop"
    scope = (PACKAGE,)
    exclude = (f"{PACKAGE}/flow.py",)

    def check_module(self, project, module: SourceModule) -> Iterable[Finding]:
        if module.tree is None:
            return ()
        judge = project.index("untimed-wait.judge", lambda p: _Judge(_receivers.get(p)))
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            meth = judge.blocks(module, node)
            if meth is None:
                continue
            if meth == "get":
                recv = _terminal_name(node.func.value)
                message = (f"untimed {recv}.get() on a queue/channel — blocks forever on a dead "
                           "producer; pass get(timeout=...) or prove non-blocking and suppress "
                           "with the reason")
            else:
                message = _MESSAGES[meth]
            findings.append(Finding(path=module.path, line=node.lineno, rule=self.id,
                                    message=message, data=(meth,)))
        return findings
