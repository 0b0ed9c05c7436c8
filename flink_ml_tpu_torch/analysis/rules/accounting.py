"""upload-accounting: a raw host-to-device copy in models and ops.

Port of the upload half of flink_ml_tpu/analysis/rules/accounting.py. A
byte that reaches the card without being counted makes every figure that
sums uploads wrong. The port's accounted stager is parallel/prefetch.py:
`stage_to_device` and `DeviceStager` (`:192`, `:103`) copy through pinned
buffers and count `h2d.count`/`h2d.bytes`, and `account_h2d` (`:199`)
counts a copy made elsewhere. The rule flags, in `models/` and `ops/`,
the torch calls that copy host data to the card around it:

- `x.to(<a device>)` (a device argument or `device=`, not the literal
  CPU) and `x.cuda()`;
- `torch.as_tensor`, `torch.tensor` and `torch.asarray` given a device;
- a host-to-device `copy_`: `buf.copy_(src)` whose source is made by
  numpy or `torch.from_numpy`.

A function that calls `account_h2d` accounts its own copies, and is not
flagged. `x.to(dtype)` is a cast, and a tensor made on the card without
host data (`torch.zeros(..., device=...)`) moves no bytes: neither is
flagged. The collective half (`collective-accounting`) waits for
multi-GPU (ROADMAP A.10).
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from ..callgraph import device_like
from ..engine import PACKAGE, Finding, Rule, register
from ..source import SourceModule, dotted_name
from . import _jitindex

#: torch constructors that copy their data argument to the given device
TENSOR_FROM_DATA = ("as_tensor", "tensor", "asarray")


def _not_cpu(node: ast.AST) -> bool:
    """Is the device expression `node` other than the literal CPU or None?"""
    if isinstance(node, ast.Constant):
        return node.value is not None and not str(node.value).startswith("cpu")
    if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
        if (dotted_name(node.func) or "").split(".")[-1] == "device":
            return _not_cpu(node.args[0])
    return True


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    return next((kw.value for kw in call.keywords if kw.arg == "device"), None)


def _host_made(node: ast.AST, info) -> bool:
    """Is `node` made on the host by numpy or torch.from_numpy?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func) or ""
            if name.split(".")[0] in info.np_aliases or name.split(".")[-1] == "from_numpy":
                return True
    return False


def upload_primitive(call: ast.Call, info) -> Optional[str]:
    """The kind of raw host-to-device copy `call` makes, or None."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr == "cuda":
            return "cuda"
        if func.attr == "to":
            target = _device_kw(call)
            if target is None and call.args and device_like(call.args[0]):
                target = call.args[0]
            if target is not None and _not_cpu(target):
                return "to"
        if func.attr == "copy_" and call.args and _host_made(call.args[0], info):
            return "copy_"
    if info.torch_call(func) and dotted_name(func).split(".")[-1] in TENSOR_FROM_DATA:
        target = _device_kw(call)
        if target is not None and _not_cpu(target):
            return dotted_name(func)
    return None


def _accounts(function: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and (dotted_name(n.func) or "").split(".")[-1]
               == "account_h2d" for n in ast.walk(function))


@register
class UploadAccountingRule(Rule):
    id = "upload-accounting"
    title = "raw host->device transfer bypasses the accounted stager"
    rationale = (
        "Every host->device upload a model or op makes must ride the "
        "accounted stager in parallel/prefetch.py (`stage_to_device` / "
        "`DeviceStager`), or be counted with `account_h2d`: that is what "
        "keeps `h2d.bytes`/`h2d.count` exhaustive. A raw `.to(device)`, "
        "`.cuda()`, `torch.as_tensor(..., device=...)` or host-to-device "
        "`copy_` copies the bytes and leaves them out of the count."
    )
    example = "X_dev = torch.as_tensor(X, device=device)  # use prefetch.stage_to_device"
    scope = (f"{PACKAGE}/models", f"{PACKAGE}/ops")

    def check_module(self, project, module: SourceModule) -> Iterable[Finding]:
        if module.tree is None:
            return
        info = _jitindex.jit_index(project)[module.path]
        accounted = set()
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _accounts(node):
                accounted.update(id(n) for n in ast.walk(node))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or id(node) in accounted:
                continue
            primitive = upload_primitive(node, info)
            if primitive is None:
                continue
            shown = primitive if "." in primitive else f".{primitive}"
            yield Finding(
                path=module.path, line=node.lineno, rule=self.id,
                message=(f"{shown}(...) copies host data to the card around the accounted "
                         "stager (use parallel.prefetch.stage_to_device, or count the copy "
                         "with account_h2d)"),
                data=(primitive,))
