"""unledgered-residency: a long-lived device tensor made outside the ledger.

Port of flink_ml_tpu/analysis/rules/memledger.py. upload-accounting keeps
the *flows* counted; this rule holds the *stocks*: a tensor bound to a
module-level name or a `self.<attr>` slot lives as long as the process or
the object, and one made by a raw constructor on the card never enters
the memory ledger (obs/memledger.py), so `hbm.live.*`, the peak, budget
admission and the out-of-memory snapshot all under-report it. The rule
flags such a binding whose right-hand side makes a tensor on the card:

- a torch constructor given a device that is not the literal CPU
  (`torch.zeros(..., device=dev)`, `torch.as_tensor(x, device=dev)`, ...);
- `x.to(<a device>)` or `x.cuda()`.

A binding is ledgered when its right-hand side goes through
`prefetch.stage_to_device`, `api.device_constants`/`HostConstants`, the
model store's `page_in`, or `memledger.register`/`track`. Tensors local to
a function are transients the collector reclaims with the frame, and are
out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name
from . import _astwalk, _jitindex
from .accounting import _not_cpu, upload_primitive

#: torch constructors that allocate a fresh tensor (views and casts are not)
TORCH_CREATORS = frozenset({"zeros", "ones", "full", "empty", "tensor", "as_tensor", "asarray",
                            "arange", "linspace", "eye", "zeros_like", "ones_like", "full_like",
                            "empty_like", "rand", "randn", "randint", "empty_strided"})

#: calls that make the binding ledgered, anywhere in its right-hand side
FUNNEL_CALLS = frozenset({"stage_to_device", "device_constants", "HostConstants", "page_in",
                          "register", "track"})


def _creator_call(node: ast.AST, info) -> Optional[str]:
    """The creator's name when `node` makes a tensor on the card."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if info.torch_call(node.func) and name.split(".")[-1] in TORCH_CREATORS:
        device = next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        return name if device is not None and _not_cpu(device) else None
    primitive = upload_primitive(node, info)
    if primitive in ("to", "cuda"):
        return f".{primitive}"
    return None


def _rhs_exempt(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            if name and name.rsplit(".", 1)[-1] in FUNNEL_CALLS:
                return True
    return False


@register
class UnledgeredResidencyRule(Rule):
    id = "unledgered-residency"
    title = "long-lived device tensor created outside the accounted funnels"
    rationale = (
        "A tensor on the card bound to a module-level name or a self.<attr> "
        "slot is resident for the process or object lifetime, but one born "
        "from a raw constructor (torch.zeros(..., device=...), .to(device), "
        ".cuda()) never enters the memory ledger: the hbm.live.* gauges, the "
        "peak, budget admission and the out-of-memory snapshot all "
        "under-report it. Stage long-lived uploads with "
        "prefetch.stage_to_device(..., category=...) or ledger them with "
        "memledger.register/track; function-local transients are out of scope."
    )
    example = "self._centroids = torch.zeros((k, d), device=dev)  # use stage_to_device"
    scope = (PACKAGE,)
    # the analysis package only talks about these calls; obs/ implements
    # the ledger itself
    exclude = (f"{PACKAGE}/analysis", f"{PACKAGE}/obs/memledger.py")

    def check_module(self, project, module: SourceModule) -> Iterable[Finding]:
        tree = module.tree
        if tree is None:
            return
        info = _jitindex.jit_index(project)[module.path]

        def check_assign(stmt, binding: str) -> Iterable[Finding]:
            value = getattr(stmt, "value", None)
            if value is None or _rhs_exempt(value):
                return
            for sub in ast.walk(value):
                creator = _creator_call(sub, info)
                if creator is not None:
                    yield Finding(
                        path=module.path, line=stmt.lineno, rule=self.id,
                        message=(f"{binding} binds a device tensor from raw {creator}(...), a "
                                 "long-lived residency the memory ledger never sees (stage it "
                                 "with prefetch.stage_to_device(..., category=...) or "
                                 "memledger.track it)"),
                        data=(creator, binding))
                    return

        # module-level bindings (import-time residency, lives forever)
        for stmt in _astwalk.statements_in_order(tree.body):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                yield from check_assign(stmt, "module-level name")

        # self.<attr> bindings (object-lifetime residency)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if (isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    yield from check_assign(node, f"self.{target.attr}")
                    break
