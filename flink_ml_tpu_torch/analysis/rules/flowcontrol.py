"""unbounded-queue: queues without a bound, threads outside the flow layer.

Port of flink_ml_tpu/analysis/rules/flowcontrol.py. A `queue.Queue()` or
`collections.deque()` made without a bound grows until the host falls
over the moment its consumer is slower than its producer, and a raw
`threading.Thread` outside the sanctioned spawn points (`flow.pump`,
`flow.spawn`, and `parallel/prefetch.py` built on them) is a worker whose
errors nothing routes back to a consumer. The rule flags:

- `collections.deque(...)` with no `maxlen`, and `queue.Queue()`,
  `LifoQueue()`, `PriorityQueue()` with no positive `maxsize`, and any
  `SimpleQueue()` (it cannot be bounded). Route a producer/consumer
  hand-off through `flow.BoundedChannel`, whose overload policy is an
  explicit decision; a deque used as plain storage takes a `maxlen` or a
  suppression saying what bounds it;
- `threading.Thread(...)` outside `flow.py` and `parallel/prefetch.py`:
  use `flow.pump` (iterable to channel, close-with-error) or `flow.spawn`.

A deliberately unbounded or logic-bounded structure carries
`# tpulint: disable=unbounded-queue -- <what bounds it>`.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List

from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule

_QUEUE_CLASSES = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Map local names to the dotted things they import: `collections`,
    `queue`, `threading` modules and their relevant members."""
    aliases: Dict[str, str] = {}
    interesting_modules = ("collections", "queue", "threading")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in interesting_modules:
                    aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.module in interesting_modules:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _call_target(node: ast.Call, aliases: Dict[str, str]) -> str:
    """The dotted import-resolved name a call constructs, or ''."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return aliases.get(fn.id, "")
    if (
        isinstance(fn, ast.Attribute)
        and isinstance(fn.value, ast.Name)
        and aliases.get(fn.value.id) in ("collections", "queue", "threading")
    ):
        return f"{aliases[fn.value.id]}.{fn.attr}"
    return ""


def _has_bounding_maxlen(node: ast.Call) -> bool:
    """deque(...) is bounded iff it passes a non-None maxlen (second
    positional or keyword)."""
    for kw in node.keywords:
        if kw.arg == "maxlen":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
    return len(node.args) >= 2


def _has_bounding_maxsize(node: ast.Call) -> bool:
    """queue.Queue(...) is bounded iff maxsize is a non-zero, non-negative
    value (0 and negative mean infinite). A non-literal expression gets
    the benefit of the doubt."""
    value = None
    if node.args:
        value = node.args[0]
    for kw in node.keywords:
        if kw.arg == "maxsize":
            value = kw.value
    if value is None:
        return False
    if isinstance(value, ast.Constant) and isinstance(value.value, (int, float)):
        return value.value > 0
    if isinstance(value, ast.UnaryOp) and isinstance(value.op, ast.USub):
        return False  # negative literal: infinite by the queue contract
    return True  # dynamic bound: assume the caller computed one


@register
class UnboundedQueueRule(Rule):
    id = "unbounded-queue"
    title = "unbounded queue constructors and raw thread spawns"
    rationale = (
        "An unbounded queue is a memory leak with a trigger condition: "
        "the first time its consumer is slower than its producer it "
        "grows until the host dies — the overload case flow.BoundedChannel "
        "makes an explicit policy decision (block / shed_oldest / sample "
        "/ reject). A raw threading.Thread outside the flow layer is a "
        "worker whose failure nothing reports: the consumer blocks on a "
        "silently-dead producer. Route hand-offs through "
        "flow.BoundedChannel and spawns through flow.pump / flow.spawn, "
        "or bound the structure (deque maxlen, Queue maxsize) — or "
        "suppress WITH the reason that bounds it."
    )
    example = "pending = deque()  # use flow.BoundedChannel(depth) / deque(maxlen=n)"
    scope = (PACKAGE,)
    # flow.py is the sanctioned home of both; parallel/prefetch.py, the
    # module the staging windows grew in, stays exempt as in JAX
    exclude = (f"{PACKAGE}/flow.py", f"{PACKAGE}/parallel/prefetch.py")

    def check_module(
        self, project, module: SourceModule
    ) -> Iterable[Finding]:
        if module.tree is None:
            return ()
        aliases = _import_aliases(module.tree)
        if not aliases:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            target = _call_target(node, aliases)
            if target == "collections.deque" and not _has_bounding_maxlen(node):
                findings.append(
                    Finding(
                        path=module.path,
                        line=node.lineno,
                        rule=self.id,
                        message=(
                            "unbounded collections.deque() — grows without "
                            "limit once the consumer falls behind; use "
                            "flow.BoundedChannel (policy-explicit) or pass "
                            "maxlen="
                        ),
                        data=("deque",),
                    )
                )
            elif target == "queue.SimpleQueue" or (
                target.startswith("queue.")
                and target.split(".", 1)[1] in _QUEUE_CLASSES
                and not _has_bounding_maxsize(node)
            ):
                findings.append(
                    Finding(
                        path=module.path,
                        line=node.lineno,
                        rule=self.id,
                        message=(
                            f"unbounded {target}() — maxsize<=0 means grow-"
                            "until-OOM under overload; use flow.BoundedChannel "
                            "or pass a positive maxsize"
                        ),
                        data=("queue",),
                    )
                )
            elif target == "threading.Thread":
                findings.append(
                    Finding(
                        path=module.path,
                        line=node.lineno,
                        rule=self.id,
                        message=(
                            "raw threading.Thread outside flow.py — a worker "
                            "whose errors nothing routes to its consumer; "
                            "spawn through flow.pump (iterable→channel, "
                            "close-with-error) or flow.spawn"
                        ),
                        data=("thread",),
                    )
                )
        return findings
