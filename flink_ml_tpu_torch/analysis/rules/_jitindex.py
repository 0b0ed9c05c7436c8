"""Cross-module index of the program funnel, module aliases and imports.

Port of flink_ml_tpu/analysis/rules/_jitindex.py, rewritten for the
port's funnel (utils/lazyjit.py). Several rules need the same syntactic
facts about a module:

- which local names are bound to numpy, to torch or to a torch
  namespace (`import torch.nn.functional as F`), and to the lazyjit
  module itself (`from ..utils import lazyjit`);
- which names denote the funnel's entry points: `lazy_jit` (`:596`),
  `keyed_jit` (`:620`) and `capture` (`:264`), bare or as
  `lazyjit.<name>`;
- which local names are wrapped kernels: `NAME = lazy_jit(_impl, ...)`,
  `NAME = lazy_jit(...)(_impl)` and `@lazy_jit`/`@lazy_jit(...)` defs,
  with the static argument names each declares, and which are keyed
  factories (`NAME = keyed_jit(make)`);
- the **captured bodies**: the functions a graph runs. A wrapped
  kernel's function (`_impl`, or the decorated def), a keyed factory's
  returned nested defs, the body given to `capture(pool, body)`, and
  every `transform_kernel` method (the transform-kernel protocol, which
  `pipeline.FusedSegment` captures a segment of stages from);
- the sparse kernels' wrappers (ops/sparsekernels.py), whose results
  are on the card;
- which imported names resolve to kernels of sibling modules.

The index is built once a project (`Project.index`), so the rules agree.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from ..source import SourceModule, dotted_name, resolve_relative_import

LAZYJIT_MODULE = "flink_ml_tpu_torch.utils.lazyjit"
SPARSEKERNELS_MODULE = "flink_ml_tpu_torch.ops.sparsekernels"
#: the sparse kernels' wrappers: their results are on the card
DEVICE_KERNELS = ("sparse_row_dots", "sparse_grad", "fleet_row_dots", "fleet_grad")
#: the method of the transform-kernel protocol, whose segments FusedSegment captures
TRANSFORM_KERNEL = "transform_kernel"


@dataclass
class ModuleJitInfo:
    path: str
    module_name: str
    np_aliases: Set[str] = field(default_factory=set)
    torch_aliases: Set[str] = field(default_factory=set)  # torch and its namespaces
    lazyjit_modules: Set[str] = field(default_factory=set)  # bound to utils/lazyjit.py
    lazy_jit_names: Set[str] = field(default_factory=set)  # bound to lazy_jit
    keyed_jit_names: Set[str] = field(default_factory=set)  # bound to keyed_jit
    capture_names: Set[str] = field(default_factory=set)  # bound to capture
    # kernel name -> its static argument names
    kernels: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    factories: Set[str] = field(default_factory=set)  # keyed_jit factories
    # captured body (a def's name here) -> its static argument names
    bodies: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # the sparse kernels' wrappers by local name, and the module's aliases
    device_kernels: Set[str] = field(default_factory=set)
    sparsekernels_modules: Set[str] = field(default_factory=set)
    # imported name -> (module dotted path, original name) for later linking
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)

    def _funnel(self, node: ast.AST, bare: Set[str], attr: str) -> bool:
        name = dotted_name(node)
        if name is None:
            return False
        if name in bare:
            return True
        root, _, rest = name.partition(".")
        return root in self.lazyjit_modules and rest == attr

    def is_lazy_jit(self, node: ast.AST) -> bool:
        return self._funnel(node, self.lazy_jit_names, "lazy_jit")

    def is_keyed_jit(self, node: ast.AST) -> bool:
        return self._funnel(node, self.keyed_jit_names, "keyed_jit")

    def is_capture(self, node: ast.AST) -> bool:
        return self._funnel(node, self.capture_names, "capture")

    def is_jit_callable(self, node: ast.AST) -> bool:
        """Does this expression denote a funnel wrapper (lazy_jit or
        keyed_jit)?"""
        return self.is_lazy_jit(node) or self.is_keyed_jit(node)

    def is_device_kernel(self, node: ast.AST) -> bool:
        """Is `node` a sparse kernel's wrapper or a wrapped kernel?"""
        name = dotted_name(node)
        if name is None:
            return False
        if name in self.device_kernels or name in self.kernels:
            return True
        root, _, rest = name.partition(".")
        return root in self.sparsekernels_modules and rest in DEVICE_KERNELS

    def torch_call(self, func: ast.AST) -> bool:
        """Is `func` a call target in torch or one of its namespaces?"""
        name = dotted_name(func)
        return name is not None and "." in name and name.split(".")[0] in self.torch_aliases


def _static_argnames(call: ast.Call) -> Tuple[str, ...]:
    for kw in call.keywords:
        if kw.arg == "static_argnames" and isinstance(kw.value, (ast.Tuple, ast.List)):
            return tuple(e.value for e in kw.value.elts
                         if isinstance(e, ast.Constant) and isinstance(e.value, str))
    return ()


def _returned_defs(make: ast.AST) -> Set[str]:
    """The nested defs a factory returns by name."""
    nested = {n.name for n in ast.walk(make)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not make}
    return {n.value.id for n in ast.walk(make)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Name)
            and n.value.id in nested}


def _wrapped_kernel(info: ModuleJitInfo, node: ast.AST) -> Optional[Tuple[ast.AST, Tuple]]:
    """(the wrapped function's expression, static argnames) when `node` is
    `lazy_jit(fn, ...)` or `lazy_jit(...)(fn)`; else None."""
    if not isinstance(node, ast.Call):
        return None
    if info.is_lazy_jit(node.func) and node.args:
        return node.args[0], _static_argnames(node)
    if isinstance(node.func, ast.Call) and info.is_lazy_jit(node.func.func) and node.args:
        return node.args[0], _static_argnames(node.func)
    return None


def build_module_info(module: SourceModule) -> ModuleJitInfo:
    info = ModuleJitInfo(path=module.path, module_name=module.module_name)
    if module.tree is None:
        return info

    # pass 1: imports / aliases
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                if alias.name == "numpy":
                    info.np_aliases.add(bound)
                elif alias.name == "torch" or alias.name.startswith("torch."):
                    info.torch_aliases.add(bound)
                elif alias.name == LAZYJIT_MODULE and alias.asname:
                    info.lazyjit_modules.add(bound)
        elif isinstance(node, ast.ImportFrom):
            target = resolve_relative_import(module.module_name, node, module.is_package)
            if target is None:
                continue
            for alias in node.names:
                bound = alias.asname or alias.name
                full = f"{target}.{alias.name}"
                if target == "torch" or target.startswith("torch."):
                    info.torch_aliases.add(bound)  # a torch namespace or symbol
                elif full == LAZYJIT_MODULE or full.endswith("utils.lazyjit"):
                    info.lazyjit_modules.add(bound)
                elif full == SPARSEKERNELS_MODULE or full.endswith("ops.sparsekernels"):
                    info.sparsekernels_modules.add(bound)
                elif target == LAZYJIT_MODULE or target.endswith("utils.lazyjit"):
                    if alias.name == "lazy_jit":
                        info.lazy_jit_names.add(bound)
                    elif alias.name == "keyed_jit":
                        info.keyed_jit_names.add(bound)
                    elif alias.name == "capture":
                        info.capture_names.add(bound)
                elif target == SPARSEKERNELS_MODULE or target.endswith("ops.sparsekernels"):
                    if alias.name in DEVICE_KERNELS:
                        info.device_kernels.add(bound)
                info.imports[bound] = (target, alias.name)

    # pass 2: module-level kernel bindings and decorated defs
    defs = {n.name: n for n in module.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for node in module.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            wrapped = _wrapped_kernel(info, node.value)
            if wrapped is not None:
                fn, statics = wrapped
                info.kernels[target.id] = statics
                if isinstance(fn, ast.Name):
                    info.bodies[fn.id] = statics
            elif isinstance(node.value, ast.Call) and info.is_keyed_jit(node.value.func):
                info.factories.add(target.id)
                make = node.value.args[0] if node.value.args else None
                if isinstance(make, ast.Name) and make.id in defs:
                    for inner in _returned_defs(defs[make.id]):
                        info.bodies[inner] = _static_argnames(node.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                statics = None
                if info.is_lazy_jit(dec):
                    statics = ()
                elif isinstance(dec, ast.Call) and info.is_lazy_jit(dec.func):
                    statics = _static_argnames(dec)
                if statics is not None:
                    info.kernels[node.name] = statics
                    info.bodies[node.name] = statics
                    break
    # capture(pool, body) anywhere: the body, a def of this module or a lambda
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) and info.is_capture(node.func):
            body = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "body"), None)
            if isinstance(body, ast.Name):
                info.bodies.setdefault(body.id, ())
    return info


def build_index(project) -> Dict[str, ModuleJitInfo]:
    """path -> ModuleJitInfo with imported kernels linked across modules."""
    by_path: Dict[str, ModuleJitInfo] = {}
    by_module: Dict[str, ModuleJitInfo] = {}
    for module in project.modules:
        info = build_module_info(module)
        by_path[module.path] = info
        if module.module_name:
            by_module[module.module_name] = info
    # link imported kernels/factories (one hop is enough for this tree)
    for info in by_path.values():
        for bound, (target_module, original) in info.imports.items():
            target = by_module.get(target_module)
            if target is None:
                continue
            if original in target.kernels and bound not in info.kernels:
                info.kernels[bound] = target.kernels[original]
            if original in target.factories:
                info.factories.add(bound)
    return by_path


def jit_index(project) -> Dict[str, ModuleJitInfo]:
    return project.index("jitindex", build_index)
