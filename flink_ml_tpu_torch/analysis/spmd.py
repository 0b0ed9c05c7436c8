"""Abstract rank-variance interpreter: the SPMD layer under the port's
mesh rules.

Port of flink_ml_tpu/analysis/spmd.py. The JAX package runs one program
over every device: `shard_map` bodies with `in_specs` and `out_specs`,
where a wrong axis, a collective under a shard-varying branch or an
`out_specs` that lies about a reduction is silent corruption or a
multi-host deadlock, not a test failure. The port runs SPMD as
torch.distributed does (parallel/mesh.py): every rank runs the same Python
loop on its own rows, and the same hazards live in those per-rank loops.
This module gives the rules the facts they are made of, read in the
port's own idiom:

- a `shard_map` site is a **ranked body**: a def with a `mesh` parameter
  (by name, or annotated `Mesh`) that reaches a collective of
  parallel/collectives.py or a raw `torch.distributed` one, directly or
  through a call (`FunctionTable.ranked`);
- `in_specs` are the arguments at the body's call sites, interpreted in
  the caller;
- `lax.axis_index` / `axis_size` are `mesh.axis_index(axis)`,
  `collectives.axis_index`, `mesh.coords()`, `mesh.rank` and
  `dist.get_rank()` (`rank` varies over every axis);
- `P(...)` specs are `RankSharding(mesh, spec)` and the constructors
  `data_sharding`, `model_sharding`, `data_model_sharding`,
  `fleet_sharding`, `replicated_sharding`, `sharding_for_tag`: `.take`
  and `.bounds` give a value that varies over the spec's axes;
- `lax.while_loop` / `cond` / `scan` are Python `for` / `while` / `if`
  (the ranked loops are eager, ROADMAP C.28): a loop body runs once
  quietly, joined with its entry state, then once recording;
- the collective index is the wrappers of collectives.py (every
  module-level def with an `axis_name` parameter), classified by name,
  else by the `torch.distributed` call their body reaches; raw `dist.*`
  collectives are indexed too;
- `out_specs` are the **claim**: a ranked body called from outside any
  ranked body (the estimator's entry) returns what every rank keeps, so
  its result is claimed uniform over every axis but those a
  `fleet_sharding` / `model_sharding` placement declared on it; and a
  leaf tagged `replicated` at `save_job_snapshot` / `save_rank_cut` with a
  mesh;
- `SANCTIONED_FOLD_PATHS` are collectives.py (`_reduce_bucket_ring`'s
  fold) and overlap.py;
- donation has no counterpart (C.23); rules/donation.py holds the port's
  hazard, a buffer an async copy still owns.

Where a value comes from, in the port:

- **varies** over the spec's axes: `RankSharding(...).take/.bounds`, the
  constructors above, `shard_batch`, `shard_bounds`, `stage_to_device(...,
  sharding=)`, `stage_section(..., mesh=)` under literal tags; and
  through the arguments of any call (`devicecache.data_axis_rows(...,
  mesh.axis_index(DATA_AXIS), ...)` varies because its index does);
- **uniform**: constants, `replicate`, `replicated_sharding`, a
  collective's result, the parameters of an entry (every rank calls the
  estimator with the same whole inputs: the port's SPMD convention);
- **unknown**: what could not be resolved, the parameters of a callback
  (a nested def or lambda handed over as a value: its result is the
  value) and of a ranked body no def of the package calls; it suppresses
  findings (the engine under-approximates, so every finding is worth
  reading).

A mesh value knows whether it is `mesh.flatten(...)`'s: on a flattened
mesh `data` is every rank, so `axis_index(DATA_AXIS)` varies, and a reduce
over `data` reduces, over every axis of the mesh it came from. A value
uniform along `model` reduced over the flattened world is then a
double-reduce over `model`: the shape of ROADMAP C.36.

Everything is one memoized `SpmdInterpretation` a project
(`project.index("spmd", ...)`) of typed `SpmdEvent`s and the `RankedBody`
records (every call-site binding of every ranked body, with the
collectives reached under it). The rules `mesh-axis`,
`collective-divergence`, `spec-consistency` and `precision-determinism`
are thin filters over the events; the event kinds keep the JAX names, so
both packages' findings carry the same `data[0]`.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .engine import PACKAGE
from .source import SourceModule, dotted_name, resolve_relative_import

MESH_PATH = f"{PACKAGE}/parallel/mesh.py"
COLLECTIVES_PATH = f"{PACKAGE}/parallel/collectives.py"
OVERLAP_PATH = f"{PACKAGE}/parallel/overlap.py"

#: modules whose hand-written folds over collective results are the
#: sanctioned replica-order folds (anywhere else a manual fold reassociates)
SANCTIONED_FOLD_PATHS = (COLLECTIVES_PATH, OVERLAP_PATH)

#: raw torch.distributed calls -> kind
DIST_COLLECTIVES = {
    "all_reduce": "reduce", "reduce": "reduce", "reduce_scatter": "reduce",
    "reduce_scatter_tensor": "reduce", "reduce_scatter_single": "reduce",
    "all_gather": "gather", "all_gather_into_tensor": "gather",
    "all_gather_single": "gather", "all_to_all": "gather", "all_to_all_single": "gather",
    "gather": "gather",
    "isend": "permute", "irecv": "permute", "send": "permute", "recv": "permute",
    "batch_isend_irecv": "permute",
    "broadcast": "broadcast", "broadcast_object_list": "broadcast",
    "all_gather_object": "object", "gather_object": "object",
    "scatter_object_list": "object", "barrier": "barrier",
}

#: a wrapper whose body reaches several kinds is named for the strongest
_KIND_PRIORITY = ("reduce", "gather", "permute", "broadcast", "object", "barrier", "index",
                  "size")

#: the wrapper NAME is the API contract: classified by it first
WRAPPER_NAME_KINDS = (
    ("all_reduce", "reduce"),
    ("reduce_scatter", "reduce"),
    ("sparse_all_reduce", "reduce"),
    ("all_gather", "gather"),
    ("ppermute", "permute"),
    ("axis_index", "index"),
    ("axis_size", "size"),
)

#: the kinds every rank of the axis must issue (a rank that skips one hangs the rest)
BLOCKING_KINDS = ("reduce", "gather", "permute", "broadcast", "object", "barrier")

#: the reduces that ADD their operands (a fleet's members are never added)
ADDING_OPS = ("all_reduce_sum", "all_reduce_mean", "all_reduce_sum_chunked",
              "sparse_all_reduce_sum", "reduce_scatter", "all_reduce", "reduce",
              "reduce_scatter_tensor", "reduce_scatter_single")

#: dtypes whose use as a reduce operand narrows a float32 one
NARROW_DTYPES = {"bfloat16", "float16", "half", "int8", "uint8", "float8_e4m3fn",
                 "float8_e5m2"}
#: the narrowing tensor methods, by the dtype they give
NARROW_METHODS = {"half": "float16", "bfloat16": "bfloat16"}

#: the atomics kernels (ops/sparsekernels.py): their sums' bits differ per run
ATOMIC_KERNELS = ("sparse_grad", "fleet_grad")

#: tensor methods that give host metadata, the same on every rank
META_METHODS = {"numel", "dim", "size", "element_size", "stride", "is_contiguous",
                "data_ptr", "is_pinned", "get_device", "is_floating_point", "nelement",
                "ndimension", "storage_offset"}
META_ATTRS = {"shape", "ndim", "dtype", "nbytes", "itemsize", "device", "is_cuda",
              "layout", "requires_grad", "is_sparse"}
#: methods that give their receiver's value unchanged (a Staged's or a
#: Pending's value, a copy)
PASSTHROUGH_METHODS = {"wait", "result", "contiguous", "clone", "detach"}
#: in-place container methods: the receiver takes on the argument's variance
MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault", "appendleft"}
#: builtins that read a value's type or length: the same on every rank (the
#: padded-batch convention gives every rank the same shapes)
TYPE_BUILTINS = {"isinstance", "issubclass", "type", "len", "hasattr", "callable"}
#: methods whose result is a view of their receiver (`x.view`, `x.reshape`)
#: or of their first argument (`layout.views(buf)`)
VIEW_METHODS = {"view", "reshape", "view_as", "flatten", "ravel", "T", "transpose"}
VIEW_OF_ARGUMENT = {"views"}
#: torch constructors of a constant fill, the same on every rank
FILL_CALLS = {"zeros", "zeros_like", "new_zeros", "full", "full_like", "new_full", "ones",
              "ones_like", "new_ones"}

#: bounded interpretation depth of inlined calls (the port's ranked loops
#: sit deeper under their entries than a shard_map body does)
MAX_DEPTH = 8


# ---------------------------------------------------------------------------
# events and records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpmdEvent:
    """One fact the rules turn into findings.

    Kinds (the JAX package's, then the port's own):
      `unknown-axis`           an axis literal no mesh constant declares
      `axis-bypass`            an axis literal that duplicates a constant
      `unsharded-collective`   a gather/permute over an axis the operand does
                               not vary on
      `divergent-collective`   a collective under a rank-varying branch
      `double-reduce`          a reduce over an axis the operand is uniform on
      `unreduced-output`       a claimed-uniform result still varies
      `spec-arity`             never raised: no spec list rides beside a
                               ranked body (ROADMAP C.37)
      `downcast-before-reduce` a narrowed dtype feeds a reduce
      `order-fold`             a permute-accumulate loop outside the sanctioned
                               folds
      `cross-member-reduce`    an adding reduce over `data` of a
                               fleet-sharded value (adds members together)
      `atomic-scatter`         a gathered (uniform) value scattered through an
                               atomics kernel: each rank gets other bits (C.30)
      `collective`             any collective interpreted under a ranked body
                               (`extra`: kind, axis, operand state), read by
                               the interpretation gate
    """

    path: str
    line: int
    kind: str
    detail: str = ""
    extra: Tuple = ()


@dataclass
class Binding:
    """One interpretation of a ranked body: where it was called from, what
    its parameters were, and the collectives reached under it."""

    site: Tuple[str, int]  # (caller path, call line); ("", 0) for a root
    params: Dict[str, "AbsVal"]
    collectives: int = 0
    resolved: int = 0  # collectives whose operand was resolved and varies over their axis


@dataclass
class RankedBody:
    path: str
    qualname: str
    bindings: List[Binding] = field(default_factory=list)

    @property
    def collectives(self) -> int:
        return max((b.collectives for b in self.bindings), default=0)

    @property
    def resolved(self) -> bool:
        """Some binding reached a collective whose operand was resolved."""
        return any(b.collectives and b.resolved for b in self.bindings)


# ---------------------------------------------------------------------------
# axis registry
# ---------------------------------------------------------------------------

@dataclass
class AxisRegistry:
    #: (module_name, NAME) -> axis string
    constants: Dict[Tuple[str, str], str] = field(default_factory=dict)
    #: axis string -> constant NAME (for bypass messages)
    by_value: Dict[str, str] = field(default_factory=dict)
    known_axes: Set[str] = field(default_factory=set)

    def constant_value(self, module_name: str, name: str) -> Optional[str]:
        return self.constants.get((module_name, name))


def _build_axis_registry(project) -> AxisRegistry:
    reg = AxisRegistry()
    for source_mod in (project.module_at(MESH_PATH), project.module_at(COLLECTIVES_PATH)):
        if source_mod is None or source_mod.tree is None:
            continue
        for node in source_mod.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.endswith("_AXIS")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                name, value = node.targets[0].id, node.value.value
                reg.constants[(source_mod.module_name, name)] = value
                reg.by_value.setdefault(value, name)
                reg.known_axes.add(value)
    # re-exports: `from .mesh import DATA_AXIS` binds it in the importer
    for module in project.modules:
        if module.tree is None:
            continue
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            target = resolve_relative_import(module.module_name, node, module.is_package)
            if target is None:
                continue
            for alias in node.names:
                value = reg.constants.get((target, alias.name))
                if value is not None:
                    reg.constants[(module.module_name, alias.asname or alias.name)] = value
    return reg


def axis_registry(project) -> AxisRegistry:
    return project.index("spmd-axes", _build_axis_registry)


# ---------------------------------------------------------------------------
# collective index
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CollectiveWrapper:
    name: str
    kind: str
    axis_param: int  # positional index of axis_name
    default_axis: Optional[str]
    operand_params: Tuple[int, ...] = (0,)
    mesh_param: Optional[int] = None  # positional index of mesh


def _dist_aliases(tree: ast.AST) -> Set[str]:
    """Local names bound to torch.distributed (`import torch.distributed as
    dist`, `from torch import distributed`)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch.distributed" and alias.asname:
                    out.add(alias.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for alias in node.names:
                if alias.name == "distributed":
                    out.add(alias.asname or alias.name)
    return out


def _dist_name(node: ast.AST, aliases: Set[str]) -> Optional[str]:
    """`x` when `node` is `dist.x` or `torch.distributed.x`."""
    name = dotted_name(node)
    if name is None:
        return None
    root, _, rest = name.partition(".")
    if root in aliases and rest and "." not in rest:
        return rest
    if name.startswith("torch.distributed.") and name.count(".") == 2:
        return name.rsplit(".", 1)[1]
    return None


def _reached_dist_kinds(module: SourceModule, fn: ast.AST, defs, aliases, seen) -> Set[str]:
    """The kinds of torch.distributed collective `fn` reaches, through the
    module's own defs (a wrapper calls `_all_reduce`, which calls
    `dist.all_reduce`); an attribute reference counts (`getattr(dist, ...)
    or dist.all_gather_into_tensor`)."""
    found: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            base = _dist_name(node, aliases)
            if base in DIST_COLLECTIVES:
                found.add(DIST_COLLECTIVES[base])
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            callee = defs.get(node.func.id)
            if callee is not None and callee.name not in seen:
                seen.add(callee.name)
                found |= _reached_dist_kinds(module, callee, defs, aliases, seen)
    return found


def _wrapper_kind(module: SourceModule, node: ast.FunctionDef, defs, aliases) -> Optional[str]:
    for prefix, kind in WRAPPER_NAME_KINDS:
        if node.name.lstrip("_").startswith(prefix):
            return kind
    found = _reached_dist_kinds(module, node, defs, aliases, {node.name})
    return next((kind for kind in _KIND_PRIORITY if kind in found), None)


def _build_collective_index(project) -> Dict[str, CollectiveWrapper]:
    out: Dict[str, CollectiveWrapper] = {}
    module = project.module_at(COLLECTIVES_PATH)
    if module is None or module.tree is None:
        return out
    reg = axis_registry(project)
    defs = {n.name: n for n in module.tree.body if isinstance(n, ast.FunctionDef)}
    aliases = _dist_aliases(module.tree)
    for node in defs.values():
        params = [a.arg for a in node.args.args]
        if "axis_name" not in params:
            continue
        kind = _wrapper_kind(module, node, defs, aliases)
        if kind is None:
            continue
        axis_param = params.index("axis_name")
        default_axis = None
        defaults = node.args.defaults
        offset = len(params) - len(defaults)
        if defaults and axis_param >= offset:
            default = defaults[axis_param - offset]
            if isinstance(default, ast.Constant) and isinstance(default.value, str):
                default_axis = default.value
            elif isinstance(default, ast.Name):
                default_axis = reg.constant_value(module.module_name, default.id)
        operands = (0, 1) if node.name.startswith("sparse_all_reduce") else (0,)
        out[node.name] = CollectiveWrapper(
            name=node.name, kind=kind, axis_param=axis_param, default_axis=default_axis,
            operand_params=operands,
            mesh_param=params.index("mesh") if "mesh" in params else None)
    return out


def collective_index(project) -> Dict[str, CollectiveWrapper]:
    return project.index("spmd-collectives", _build_collective_index)


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------

#: "no literal known"
NOCONST = ("<no-const>",)


@dataclass(frozen=True)
class AbsVal:
    """What the interpreter knows of a value on one rank.

    `axes`: the mesh axes it varies over (empty: the same on every rank);
    `unknown`: something on its way was unresolvable (no findings);
    `narrowed`: the narrow dtype a cast gave it; `permuted`: it derives
    from a ring shift. The port's own: `declared`, the axes a
    `fleet_sharding`/`model_sharding` placement declared it sharded over
    (the claim allows them); `fleet`, its `data` axis is a fleet's member
    axis; `gathered`, it came out of a gather; `filled`, a constant fill
    made on every rank (a reduce of it counts nothing twice); `sharding`,
    it IS a RankSharding over these axes; `mesh`, it is a mesh (1) or a
    flattened mesh (2); `const`, the literal it is known to be."""

    axes: FrozenSet[str] = frozenset()
    unknown: bool = False
    narrowed: Optional[str] = None
    permuted: bool = False
    declared: FrozenSet[str] = frozenset()
    fleet: bool = False
    gathered: bool = False
    filled: bool = False
    sharding: Optional[FrozenSet[str]] = None
    mesh: int = 0
    const: object = NOCONST

    def join(self, other: "AbsVal") -> "AbsVal":
        if self == other:
            return self
        if self.sharding is None or other.sharding is None:
            sharding = self.sharding if other.sharding is None else other.sharding
        else:
            sharding = self.sharding | other.sharding
        return AbsVal(
            axes=self.axes | other.axes,
            unknown=self.unknown or other.unknown,
            narrowed=self.narrowed or other.narrowed,
            permuted=self.permuted or other.permuted,
            declared=self.declared | other.declared,
            fleet=self.fleet or other.fleet,
            gathered=self.gathered or other.gathered,
            filled=self.filled and other.filled,
            sharding=sharding,
            mesh=max(self.mesh, other.mesh),
            const=self.const if self.const == other.const else NOCONST,
        )


UNIFORM = AbsVal()
UNKNOWN_VAL = AbsVal(unknown=True)
MESH_VAL = AbsVal(mesh=1)


def _const(value) -> AbsVal:
    return AbsVal(const=value)


class TupleVal:
    """A tuple-structured abstract value (carries, multi-returns)."""

    __slots__ = ("elts",)

    def __init__(self, elts: Sequence):
        self.elts = list(elts)

    def collapse(self) -> AbsVal:
        if not self.elts:
            return UNIFORM
        out = _scalar(self.elts[0])
        for e in self.elts[1:]:
            out = out.join(_scalar(e))
        return out

    def join(self, other):
        if isinstance(other, TupleVal) and len(other.elts) == len(self.elts):
            return TupleVal([_join(a, b) for a, b in zip(self.elts, other.elts)])
        return self.collapse().join(_scalar(other))

    def __eq__(self, other):
        return isinstance(other, TupleVal) and self.elts == other.elts

    def __hash__(self):
        return hash(tuple(self.elts))


class FuncRef:
    """A callable handed over as a value: a lambda or a nested def, with the
    scope it closes over. A callee of the package that calls it runs it on
    the arguments it passes; an opaque runtime (a loader, a stager) that
    calls it back passes indices and batch ids, the same on every rank."""

    __slots__ = ("node", "env", "ctx", "info", "owner")

    def __init__(self, node, env, ctx, info, owner):
        self.node, self.env, self.ctx, self.info, self.owner = node, env, ctx, info, owner

    def join(self, other):
        return self



def _join(a, b):
    if isinstance(a, FuncRef) or isinstance(b, FuncRef):
        return a if isinstance(a, FuncRef) else b
    if isinstance(a, TupleVal):
        return a.join(b)
    if isinstance(b, TupleVal):
        return b.join(a)
    return a.join(b)


def _scalar(v) -> AbsVal:
    if isinstance(v, FuncRef):
        return UNIFORM
    if isinstance(v, TupleVal):
        consts = [e.const if isinstance(e, AbsVal) else NOCONST for e in v.elts]
        out = v.collapse()
        if v.elts and all(c != NOCONST for c in consts):
            out = AbsVal(**{**out.__dict__, "const": tuple(consts)})
        return out
    return v


def _strip(v: AbsVal) -> AbsVal:
    """`v` as a plain payload: not a mesh, a sharding or a literal."""
    if v.mesh or v.sharding is not None or v.const != NOCONST:
        return AbsVal(axes=v.axes, unknown=v.unknown, narrowed=v.narrowed, permuted=v.permuted,
                      declared=v.declared, fleet=v.fleet, gathered=v.gathered, filled=v.filled)
    return v


def _indexed(base: AbsVal, index: AbsVal) -> AbsVal:
    """`base[index]`: the base's value, varying also where the index does."""
    if not index.axes and not index.unknown:
        return base
    return AbsVal(**{**base.__dict__, "axes": base.axes | index.axes,
                     "unknown": base.unknown or index.unknown, "filled": False})


def _view_base(value: ast.AST) -> Optional[str]:
    """The buffer an assigned expression is a view of: `buf[...]`,
    `buf.view(...)`/`.reshape(...)`, `layout.views(buf)`."""
    if isinstance(value, ast.Subscript) and isinstance(value.value, ast.Name):
        return value.value.id
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute):
        if value.func.attr in VIEW_METHODS and isinstance(value.func.value, ast.Name):
            return value.func.value.id
        if value.func.attr in VIEW_OF_ARGUMENT and value.args \
                and isinstance(value.args[0], ast.Name):
            return value.args[0].id
    return None


def _aliases(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    """Local names bound to a function reference (`train = a if c else b`),
    flow-insensitively: name -> the referenced expressions."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            arms = [node.value.body, node.value.orelse] if isinstance(
                node.value, ast.IfExp) else [node.value]
            if all(isinstance(a, (ast.Name, ast.Attribute)) for a in arms):
                out.setdefault(node.targets[0].id, []).extend(arms)
    return out


def _tag_axes(tag) -> Optional[FrozenSet[str]]:
    """The axes a snapshot spec tag places a leaf over (sharding_for_tag)."""
    if not isinstance(tag, str):
        return None
    return frozenset({tag}) if tag in ("data", "model") else frozenset()


# ---------------------------------------------------------------------------
# per-module resolution context
# ---------------------------------------------------------------------------

#: mesh.py functions with a meaning here (the rest give uniform results)
MESH_FUNCS = {"data_sharding", "model_sharding", "data_model_sharding", "fleet_sharding",
              "replicated_sharding", "sharding_for_tag", "RankSharding", "shard_batch",
              "shard_bounds", "replicate", "flatten", "default_mesh", "create_mesh",
              "create_mesh_2d", "form_mesh_over", "Mesh"}


class ModuleContext:
    """Resolution facts for one module: imports, torch.distributed aliases,
    the axis registry and the collective wrappers."""

    def __init__(self, project, module: SourceModule):
        from .rules import _jitindex

        self.project = project
        self.module = module
        self.info = _jitindex.jit_index(project)[module.path]
        self.axes = axis_registry(project)
        self.wrappers = collective_index(project)
        self.dist = _dist_aliases(module.tree) if module.tree is not None else set()
        self.is_collectives_module = module.path == COLLECTIVES_PATH
        self.is_mesh_module = module.path == MESH_PATH

    # -- where a call goes ----------------------------------------------------
    def target(self, func: ast.AST) -> Optional[Tuple[str, str]]:
        """(module dotted name, function name) of a call target reached by a
        bare imported name, a module alias's attribute, or a def of this
        module."""
        name = dotted_name(func)
        if name is None:
            return None
        root, _, rest = name.partition(".")
        if not rest:
            entry = self.info.imports.get(name)
            if entry is not None:
                return entry
            return (self.module.module_name, name)
        if "." in rest:
            return None
        entry = self.info.imports.get(root)
        if entry is None:
            return None
        return (f"{entry[0]}.{entry[1]}", rest)

    def mesh_func(self, func: ast.AST) -> Optional[str]:
        target = self.target(func)
        if target is None or target[1] not in MESH_FUNCS:
            return None
        return target[1] if target[0].endswith("parallel.mesh") else None

    def func_in(self, func: ast.AST, suffix: str) -> Optional[str]:
        target = self.target(func)
        if target is not None and target[0].endswith(suffix):
            return target[1]
        return None

    # -- collective call recognition ------------------------------------------
    def collective_for(self, call: ast.Call):
        """`(op, kind, axis_param, default_axis, operand_params, mesh_param)`
        when `call` is a wrapper of collectives.py (however reached) or a raw
        torch.distributed collective (axis_param -1: it names no axis)."""
        raw = _dist_name(call.func, self.dist)
        if raw in DIST_COLLECTIVES:
            operands = (1,) if DIST_COLLECTIVES[raw] == "object" else (0,)
            return (raw, DIST_COLLECTIVES[raw], -1, None, operands, None)
        name = dotted_name(call.func)
        if name is None:
            return None
        base = name.split(".")[-1]
        if base in self.wrappers and self._names_wrapper(name, base):
            w = self.wrappers[base]
            return (w.name, w.kind, w.axis_param, w.default_axis, w.operand_params,
                    w.mesh_param)
        return None

    def _names_wrapper(self, name: str, base: str) -> bool:
        if self.is_collectives_module and name == base:
            return True
        root, _, rest = name.partition(".")
        if not rest:
            entry = self.info.imports.get(name)
            return entry is not None and entry[0].endswith("parallel.collectives")
        entry = self.info.imports.get(root)
        return entry is not None and f"{entry[0]}.{entry[1]}".endswith("parallel.collectives")

    # -- axis expression resolution ---------------------------------------------
    def resolve_axis(self, node: ast.AST, local_env: Optional[Dict[str, ast.AST]] = None):
        """`("literal", value, line)` for a string literal, `("const", value)`
        for a declared axis constant, else None."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return ("literal", node.value, node.lineno)
        if isinstance(node, ast.Name):
            value = self.axes.constant_value(self.module.module_name, node.id)
            if value is not None:
                return ("const", value)
            if local_env and node.id in local_env:
                target = local_env[node.id]
                if target is not node:
                    return self.resolve_axis(target, None)
            return None
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            entry = self.info.imports.get(node.value.id)
            if entry is not None:
                value = self.axes.constants.get((f"{entry[0]}.{entry[1]}", node.attr))
                if value is None:
                    value = self.axes.constants.get((entry[0], node.attr))
                if value is not None:
                    return ("const", value)
        return None


def _is_mesh_param(arg: ast.arg) -> bool:
    if arg.arg == "mesh":
        return True
    ann = dotted_name(arg.annotation) if arg.annotation is not None else None
    if ann is None and isinstance(arg.annotation, ast.Constant):
        ann = str(arg.annotation.value)
    return bool(ann) and ann.split(".")[-1].split("[")[-1].rstrip("]") == "Mesh"


def _mesh_params(fn: ast.AST) -> List[str]:
    args = list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs)
    return [a.arg for a in args if _is_mesh_param(a)]


def _axis_arg(call: ast.Call, axis_param: int) -> Optional[ast.AST]:
    if 0 <= axis_param < len(call.args):
        return call.args[axis_param]
    return next((kw.value for kw in call.keywords if kw.arg == "axis_name"), None)


# ---------------------------------------------------------------------------
# the project's functions and its ranked bodies
# ---------------------------------------------------------------------------

@dataclass
class FuncInfo:
    path: str
    qualname: str
    node: ast.AST
    cls: Optional[str]  # the enclosing class of a method
    parent: Optional[str]  # the qualname of the enclosing def of a nested def
    mesh_params: List[str]


class FunctionTable:
    """Every def of the project (module-level, methods, nested defs), the
    ranked bodies among them, and the defs with a mesh parameter by name
    (the mesh-passing resolution of a call the call graph cannot resolve:
    `loss2d.fn(..., mesh)`, `template._batchify(mesh, ...)`)."""

    def __init__(self, project):
        from . import callgraph

        self.project = project
        self.graph = callgraph.get(project)
        self.funcs: Dict[Tuple[str, str], FuncInfo] = {}
        self.by_node: Dict[int, FuncInfo] = {}
        self.mesh_named: Dict[str, List[FuncInfo]] = {}
        self.contexts: Dict[str, ModuleContext] = {}
        self._facts: Dict[int, Tuple[Dict, Dict, Dict]] = {}
        self._callees: Dict[Tuple[str, str], List[FuncInfo]] = {}
        for module in project.modules:
            if module.tree is None:
                continue
            self._collect(module, module.tree.body, "", None, None)
        self.ranked: Set[Tuple[str, str]] = self._ranked()

    def _collect(self, module, body, prefix, cls, parent):
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._collect(module, node.body, f"{prefix}{node.name}.", node.name, parent)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                info = FuncInfo(module.path, qual, node, cls, parent, _mesh_params(node))
                self.funcs[(module.path, qual)] = info
                self.by_node[id(node)] = info
                if info.mesh_params and module.path not in (MESH_PATH, COLLECTIVES_PATH):
                    self.mesh_named.setdefault(node.name, []).append(info)
                self._collect(module, _own_statements(node), f"{qual}.", None, qual)

    def context(self, path: str) -> ModuleContext:
        if path not in self.contexts:
            self.contexts[path] = ModuleContext(self.project, self.project.module_at(path))
        return self.contexts[path]

    def facts(self, fn: ast.AST) -> Tuple[Dict, Dict, Dict]:
        """(aliases, simple assignments, nested defs) of a def, walked once."""
        key = id(fn)
        if key not in self._facts:
            assigned = {n.targets[0].id: n.value for n in ast.walk(fn)
                        if isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)}
            nested = {stmt.name: stmt for stmt in _own_statements(fn)
                      if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))}
            self._facts[key] = (_aliases(fn), assigned, nested)
        return self._facts[key]

    def callees(self, info: FuncInfo) -> List[FuncInfo]:
        key = (info.path, info.qualname)
        if key not in self._callees:
            self._callees[key] = self._find_callees(info)
        return self._callees[key]

    def _find_callees(self, info: FuncInfo) -> List[FuncInfo]:
        module = self.project.module_at(info.path)
        out: List[FuncInfo] = []
        nested = {n.name: n for n in ast.walk(info.node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not info.node}
        aliases = self.facts(info.node)[0]
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id in nested:
                out.append(self.by_node[id(nested[node.func.id])])
                continue
            targets = aliases.get(node.func.id, [node.func]) if isinstance(
                node.func, ast.Name) else [node.func]
            hits = [self.funcs.get(r[0].key) for r in (
                self.graph.resolve(module, t, info.cls) for t in targets) if r is not None]
            if any(h is not None for h in hits):
                out.extend(h for h in hits if h is not None)
                continue
            name = (dotted_name(node.func) or "").split(".")[-1]
            if name in self.mesh_named and _passes_mesh(node):
                out.extend(self.mesh_named[name])
        return out

    def _ranked(self) -> Set[Tuple[str, str]]:
        """The defs with a mesh parameter that reach a collective: a fixpoint
        of 'calls a collective, or calls a def that does' over every def."""
        reaches: Set[Tuple[str, str]] = set()
        edges: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for key, info in self.funcs.items():
            ctx = self.context(info.path)
            if any(isinstance(n, ast.Call) and ctx.collective_for(n) is not None
                   for n in ast.walk(info.node)):
                reaches.add(key)
            edges[key] = [(c.path, c.qualname) for c in self.callees(info)]
        changed = True
        while changed:
            changed = False
            for key, outs in edges.items():
                if key not in reaches and any(o in reaches for o in outs):
                    reaches.add(key)
                    changed = True
        return {key for key in reaches if self.funcs[key].mesh_params
                and key[0] not in (MESH_PATH, COLLECTIVES_PATH)}


def _own_statements(fn: ast.AST) -> List[ast.stmt]:
    """The statements of `fn`'s own scope that may hold nested defs."""
    out: List[ast.stmt] = []

    def visit(stmts):
        for stmt in stmts:
            out.append(stmt)
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for block in ("body", "orelse", "finalbody"):
                visit(getattr(stmt, block, None) or [])
            for handler in getattr(stmt, "handlers", None) or []:
                visit(handler.body)
    visit(fn.body)
    return out


def _passes_mesh(call: ast.Call) -> bool:
    """Does the call hand a mesh over (an argument named like one)?"""
    values = list(call.args) + [kw.value for kw in call.keywords]
    return any((dotted_name(v) or "").split(".")[-1].endswith("mesh") for v in values) or any(
        kw.arg == "mesh" for kw in call.keywords)


def function_table(project) -> FunctionTable:
    return project.index("spmd-functions", FunctionTable)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

class Run:
    """The shared state of one project interpretation: the event list, the
    ranked-body records, the memo of interpreted calls and the stack of
    open bindings (a collective counts toward every binding under way)."""

    def __init__(self, project):
        self.project = project
        self.table = function_table(project)
        self.events: List[SpmdEvent] = []
        self.bodies: Dict[Tuple[str, str], RankedBody] = {}
        self.memo: Dict[Tuple, Tuple] = {}
        self.open: List[Binding] = []
        self.context = self.table.context

    def body(self, info: FuncInfo) -> RankedBody:
        key = (info.path, info.qualname)
        if key not in self.bodies:
            self.bodies[key] = RankedBody(info.path, info.qualname)
        return self.bodies[key]


class BodyInterpreter:
    """Abstract walk of one function body under per-rank semantics.

    `record=False` runs a pass that emits no events (the first pass over a
    loop body, joined into the loop's entry state before the recording
    pass)."""

    def __init__(self, run: Run, ctx: ModuleContext, info: Optional[FuncInfo], fn: ast.AST,
                 env: Dict[str, object], depth: int = 0, record: bool = True,
                 divergent: Optional[Tuple[int, str]] = None,
                 seen: FrozenSet[Tuple[str, str]] = frozenset()):
        self.run_state = run
        self.ctx = ctx
        self.info = info
        self.fn = fn
        self.env = env
        self.depth = depth
        self.record = record
        self.divergent = divergent
        self.seen = seen
        self.returns: List[Tuple[object, int]] = []
        self.last_env: Optional[Dict[str, object]] = None
        self.views: Dict[str, str] = {}  # name -> the buffer it is a view of
        self.aliases, self.assigned, self.local_defs = run.table.facts(fn)

    # -- events -------------------------------------------------------------
    def emit(self, line: int, kind: str, detail: str = "", extra: Tuple = ()):
        if self.record:
            self.run_state.events.append(SpmdEvent(self.ctx.module.path, line, kind, detail,
                                                   extra))

    # -- evaluation ---------------------------------------------------------
    def eval(self, node: Optional[ast.AST]):
        if node is None:
            return UNIFORM
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.local_defs:  # a nested def handed over as a value
                return self.ref(self.local_defs[node.id])
            # a module constant or a builtin, the same on every rank; an axis
            # constant is carried as the literal it names
            axis = self.ctx.axes.constant_value(self.ctx.module.module_name, node.id)
            return _const(axis) if axis is not None else UNIFORM
        if isinstance(node, ast.Constant):
            return _const(node.value)
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, ast.Attribute):
            base = self.eval(node.value)
            if node.attr in META_ATTRS:
                return UNIFORM
            if isinstance(base, AbsVal) and base.mesh:
                # a mesh's attributes are the same on every rank but its rank
                return AbsVal(axes=frozenset(self.ctx.axes.known_axes)) \
                    if node.attr == "rank" else UNIFORM
            return _strip(_scalar(base))
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            index = _scalar(self.eval(node.slice))
            if isinstance(base, TupleVal):
                idx = node.slice
                if isinstance(idx, ast.Constant) and isinstance(idx.value, int) \
                        and -len(base.elts) <= idx.value < len(base.elts):
                    return base.elts[idx.value]
                if isinstance(idx, ast.Slice):
                    return base
                return _indexed(_strip(base.collapse()), index)
            return _indexed(_strip(_scalar(base)), index)
        if isinstance(node, ast.Slice):
            out = UNIFORM
            for part in (node.lower, node.upper, node.step):
                out = out.join(_strip(_scalar(self.eval(part))))
            return out
        if isinstance(node, ast.BinOp):
            left, right = _scalar(self.eval(node.left)), _scalar(self.eval(node.right))
            if isinstance(node.op, ast.Mult) and isinstance(node.left, (ast.Tuple, ast.List)):
                return self.eval(node.left) if right.const != NOCONST else _strip(left)
            return _strip(left).join(_strip(right))
        if isinstance(node, ast.BoolOp):
            out = None
            for v in node.values:
                val = _strip(_scalar(self.eval(v)))
                out = val if out is None else out.join(val)
            return out or UNIFORM
        if isinstance(node, ast.UnaryOp):
            val = _scalar(self.eval(node.operand))
            if isinstance(node.op, ast.Not) and val.const != NOCONST:
                return _const(not val.const)
            return _strip(val)
        if isinstance(node, ast.Compare):
            left = _scalar(self.eval(node.left))
            out = _strip(left)
            consts = [left.const]
            for comp in node.comparators:
                val = _scalar(self.eval(comp))
                consts.append(val.const)
                out = out.join(_strip(val))
            if (len(node.ops) == 1 and isinstance(node.ops[0], (ast.Is, ast.IsNot))
                    and NOCONST not in consts):
                same = consts[0] is consts[1] or consts[0] == consts[1]
                return _const(same if isinstance(node.ops[0], ast.Is) else not same)
            if (len(node.ops) == 1 and isinstance(node.ops[0], (ast.Is, ast.IsNot))
                    and None in consts):
                if left.mesh or _scalar(self.eval(node.comparators[0])).mesh:
                    # a mesh value is never None: `mesh is not None`
                    return _const(isinstance(node.ops[0], ast.IsNot))
                # whether a value is None is its structure, the same on every
                # rank, not its payload
                return UNIFORM
            return out
        if isinstance(node, ast.IfExp):
            test = _scalar(self.eval(node.test))
            if test.const != NOCONST:
                return self.eval(node.body if test.const else node.orelse)
            out = _join(self.eval(node.body), self.eval(node.orelse))
            if test.axes and not isinstance(out, FuncRef):  # ranks pick different arms
                out = _indexed(_scalar(out), _strip(test))
            return out
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return TupleVal([self.eval(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            values = [self.eval(v) for v in node.values]
            keys = [k.value if isinstance(k, ast.Constant) else NOCONST for k in node.keys]
            out = UNIFORM
            for v in values:
                out = out.join(_strip(_scalar(v)))
            consts = [_scalar(v).const for v in values]
            if NOCONST not in keys and NOCONST not in consts:
                return AbsVal(**{**out.__dict__, "const": ("<dict>",) + tuple(zip(keys, consts))})
            return out
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.NamedExpr):
            value = self.eval(node.value)
            self.assign(node.target, value)
            return value
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp, ast.DictComp)):
            return self.eval_comprehension(node)
        if isinstance(node, ast.Lambda):
            return self.ref(node)
        if isinstance(node, ast.JoinedStr):
            return UNIFORM
        return UNIFORM

    def eval_comprehension(self, node):
        saved = dict(self.env)
        out = UNIFORM
        for gen in node.generators:
            it = _strip(_scalar(self.eval(gen.iter)))
            out = out.join(it)
            self.assign(gen.target, it)
            for cond in gen.ifs:
                out = out.join(_strip(_scalar(self.eval(cond))))
        prev = self.divergent
        if out.axes and not out.unknown and self.divergent is None:
            self.divergent = (node.lineno, "comprehension iterates per-rank data")
        elts = [node.key, node.value] if isinstance(node, ast.DictComp) else [node.elt]
        for elt in elts:
            out = out.join(_strip(_scalar(self.eval(elt))))
        self.divergent = prev
        self.env = saved
        return out

    # -- calls --------------------------------------------------------------
    def eval_call(self, call: ast.Call):
        ctx = self.ctx
        collective = ctx.collective_for(call)
        if collective is not None:
            return self.apply_collective(call, collective)
        func = call.func
        name = dotted_name(func)
        base = name.split(".")[-1] if name else None

        # torch.distributed's rank and ranks
        raw = _dist_name(func, ctx.dist)
        if raw == "get_rank":
            return AbsVal(axes=frozenset(ctx.axes.known_axes))
        if raw is not None:
            return UNIFORM

        if base in ("save_job_snapshot", "save_rank_cut"):
            self.check_cut(call, base)
        special = self.eval_special(call, base)
        if special is not None:
            return special
        if isinstance(func, ast.Name) and func.id in TYPE_BUILTINS and func.id not in self.env:
            for a in call.args:
                self.eval(a)
            return UNIFORM

        args = [self.eval(a) for a in call.args]
        kwargs = {kw.arg: self.eval(kw.value) for kw in call.keywords}

        # the atomics kernels: a gathered value scattered through one (C.30)
        if base in ATOMIC_KERNELS:
            for v in list(args) + list(kwargs.values()):
                v = _scalar(v)
                if v.gathered and not v.unknown and not v.axes:
                    self.emit(call.lineno, "atomic-scatter", base)
                    break

        if isinstance(func, ast.Name) and isinstance(self.env.get(func.id), FuncRef):
            return self.call_ref(self.env[func.id], call, args, kwargs)
        resolved = self.resolve_call(call)
        if resolved is not None:
            outs = []
            for info, skip_self in resolved:
                outs.append(self.call_function(info, call, args, kwargs, skip_self))
            out = outs[0]
            for other in outs[1:]:
                out = _join(out, other)
            return out

        # an opaque call: variance joins through (the receiver of a method too,
        # the result of a callback it is handed)
        joined = UNIFORM
        for v in list(args) + list(kwargs.values()):
            joined = joined.join(_strip(_scalar(self.callback_value(v) if isinstance(
                v, FuncRef) else v)))
        if isinstance(func, ast.Attribute):
            if func.attr in META_METHODS:
                return UNIFORM
            receiver = self.eval(func.value)
            if isinstance(receiver, AbsVal) and receiver.mesh:
                return self.mesh_method(func.attr, call, receiver) or UNIFORM
            if func.attr in PASSTHROUGH_METHODS and not call.args:
                return receiver
            if func.attr in MUTATORS and isinstance(func.value, ast.Name):
                self.env[func.value.id] = _strip(_scalar(receiver)).join(joined)
                return UNIFORM
            narrow = self.narrowing(call)
            rv = _strip(_scalar(receiver))
            if rv.sharding is not None:
                return rv
            out = rv.join(joined)
            if narrow is not None:
                return AbsVal(**{**out.__dict__, "narrowed": narrow})
            if func.attr in FILL_CALLS:
                return AbsVal(filled=True)
            return out
        if isinstance(func, ast.Name):
            value = self.eval(func)
            joined = joined.join(_strip(_scalar(self.callback_value(value) if isinstance(
                value, FuncRef) else value)))
        elif isinstance(func, ast.Call):
            joined = joined.join(_strip(_scalar(self.eval(func))))
        if base in FILL_CALLS and ctx.info.torch_call(func):
            return AbsVal(filled=True)
        return joined

    def narrowing(self, call: ast.Call) -> Optional[str]:
        attr = call.func.attr
        if attr in NARROW_METHODS and not call.args:
            return NARROW_METHODS[attr]
        if attr in ("to", "type", "astype"):
            target = call.args[0] if call.args else next(
                (kw.value for kw in call.keywords if kw.arg == "dtype"), None)
            name = dotted_name(target) if target is not None else None
            if name is not None and name.split(".")[-1] in NARROW_DTYPES:
                return "float16" if name.split(".")[-1] == "half" else name.split(".")[-1]
        return None

    def mesh_method(self, attr: str, call: ast.Call, mesh: AbsVal) -> Optional[AbsVal]:
        if attr == "axis_index" and call.args:
            axes = self.axes_of(call.args[0])
            if axes is None:
                return UNKNOWN_VAL
            out = UNIFORM
            for axis in sorted(axes):
                out = out.join(self.index_value(axis, mesh))
            return out
        if attr == "coords":
            return AbsVal(axes=frozenset(self.ctx.axes.known_axes))
        return None

    def index_value(self, axis: str, mesh: AbsVal) -> AbsVal:
        if mesh.mesh == 2:  # a flattened mesh: its data axis is every rank
            return AbsVal(axes=frozenset(self.ctx.axes.known_axes)) \
                if axis == self._data_axis() else UNIFORM
        return AbsVal(axes=frozenset({axis}))

    def axis_of(self, node: ast.AST) -> Optional[str]:
        """The axis an expression names: a literal, a constant, or a local
        name bound to one."""
        resolved = self.ctx.resolve_axis(node)
        if resolved is not None:
            return resolved[1]
        value = _scalar(self.eval(node)).const
        return value if isinstance(value, str) else None

    def axes_of(self, node: ast.AST) -> Optional[FrozenSet[str]]:
        """The axes an expression may name: `axis_of`'s, or both arms of a
        conditional (`MODEL_AXIS if tag == "model" else DATA_AXIS`), also
        through a local name bound to one."""
        axis = self.axis_of(node)
        if axis is not None:
            return frozenset({axis})
        if isinstance(node, ast.Name) and node.id in self.assigned:
            node = self.assigned[node.id]
        if isinstance(node, ast.IfExp):
            a, b = self.axis_of(node.body), self.axis_of(node.orelse)
            if a is not None and b is not None:
                return frozenset({a, b})
        return None

    def _data_axis(self) -> str:
        return next((v for (_, n), v in self.ctx.axes.constants.items() if n == "DATA_AXIS"),
                    "data")

    def eval_special(self, call: ast.Call, base: Optional[str]):
        """The port's layout sources: the mesh.py constructors and helpers,
        `.take`/`.bounds` of a sharding, `stage_to_device(sharding=)`,
        `stage_section(mesh=)`."""
        ctx = self.ctx
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in ("take", "bounds"):
            sharding = _scalar(self.eval(func.value))
            if sharding.sharding is not None:
                data = UNIFORM
                for a in call.args:
                    data = data.join(_strip(_scalar(self.eval(a))))
                return AbsVal(axes=sharding.sharding | data.axes, fleet=sharding.fleet,
                              declared=sharding.declared | data.declared,
                              narrowed=data.narrowed)
        mesh_fn = ctx.mesh_func(func) or (base if ctx.is_mesh_module and base in MESH_FUNCS
                                          and isinstance(func, ast.Name) else None)
        if mesh_fn is not None:
            return self.mesh_source(mesh_fn, call)
        if ctx.func_in(func, "parallel.prefetch") == "stage_to_device":
            spec = next((kw.value for kw in call.keywords if kw.arg == "sharding"), None)
            if spec is not None:
                for a in call.args:
                    self.eval(a)
                placed = self.eval(spec)
                if isinstance(placed, TupleVal):
                    return TupleVal([self._placed(_scalar(p)) for p in placed.elts])
                return self._placed(_scalar(placed))
        if ctx.func_in(func, "ckpt.snapshot") == "stage_section" or (
                base == "stage_section" and ctx.module.path.endswith("ckpt/snapshot.py")):
            mesh = next((kw.value for kw in call.keywords if kw.arg == "mesh"), None)
            for a in call.args:
                self.eval(a)
            if mesh is None or _scalar(self.eval(mesh)).const is None:
                return UNIFORM  # no mesh: every rank restores the whole section
            specs = next((kw.value for kw in call.keywords if kw.arg == "specs"), None)
            tags = _scalar(self.eval(specs)).const if specs is not None else NOCONST
            if isinstance(tags, tuple) and tags != NOCONST:
                return TupleVal([AbsVal(axes=_tag_axes(t) or frozenset()) for t in tags])
            if isinstance(tags, str):
                return AbsVal(axes=_tag_axes(tags) or frozenset())
            return UNKNOWN_VAL
        return None

    def _placed(self, sharding: AbsVal) -> AbsVal:
        if sharding.sharding is None:
            return UNKNOWN_VAL
        return AbsVal(axes=sharding.sharding, fleet=sharding.fleet, declared=sharding.declared)

    def mesh_source(self, fn: str, call: ast.Call):
        args = [_scalar(self.eval(a)) for a in call.args]
        kwargs = {kw.arg: _scalar(self.eval(kw.value)) for kw in call.keywords}
        mesh = next((v for v in args if v.mesh), kwargs.get("mesh", MESH_VAL))
        data = self._data_axis()
        model = next((v for (_, n), v in self.ctx.axes.constants.items() if n == "MODEL_AXIS"),
                     "model")
        flat = mesh.mesh == 2
        every = frozenset(self.ctx.axes.known_axes)
        data_axes = every if flat else frozenset({data})
        if fn in ("default_mesh", "create_mesh", "create_mesh_2d", "form_mesh_over", "Mesh"):
            return MESH_VAL
        if fn == "flatten":
            return AbsVal(mesh=2)
        if fn == "data_sharding":
            return AbsVal(sharding=data_axes)
        if fn == "model_sharding":
            return AbsVal(sharding=frozenset() if flat else frozenset({model}),
                          declared=frozenset({model}))
        if fn == "data_model_sharding":
            return AbsVal(sharding=data_axes | (frozenset() if flat else {model}))
        if fn == "fleet_sharding":
            return AbsVal(sharding=data_axes, fleet=True, declared=data_axes)
        if fn == "replicated_sharding":
            return AbsVal(sharding=frozenset())
        if fn == "sharding_for_tag":
            tag = args[0].const if args else NOCONST
            axes = _tag_axes(tag)
            if axes is None:
                return AbsVal(sharding=frozenset(), unknown=True)
            return AbsVal(sharding=every if (flat and axes) else axes)
        if fn == "RankSharding":
            spec = call.args[1] if len(call.args) > 1 else next(
                (kw.value for kw in call.keywords if kw.arg == "spec"), None)
            axes = self.spec_axes(spec)
            return AbsVal(sharding=axes) if axes is not None else AbsVal(
                sharding=frozenset(), unknown=True)
        if fn == "shard_batch":
            return TupleVal([AbsVal(axes=data_axes), UNIFORM])
        if fn == "shard_bounds":
            return TupleVal([AbsVal(axes=data_axes), AbsVal(axes=data_axes)])
        return UNIFORM  # replicate, and the rest: the same on every rank

    def spec_axes(self, spec: Optional[ast.AST]) -> Optional[FrozenSet[str]]:
        """The axes of a literal spec tuple `(DATA_AXIS, None)`; None when
        some entry is not resolvable."""
        if not isinstance(spec, (ast.Tuple, ast.List)):
            return None
        axes: Set[str] = set()
        for elt in spec.elts:
            if isinstance(elt, ast.Constant) and elt.value is None:
                continue
            resolved = self.ctx.resolve_axis(elt)
            if resolved is None:
                return None
            axes.add(resolved[1])
        return frozenset(axes)

    # -- resolution and inlining ----------------------------------------------
    def resolve_call(self, call: ast.Call) -> Optional[List[Tuple[FuncInfo, bool]]]:
        """The defs a call reaches: a nested def of this scope, a def the
        call graph resolves (with `self.` methods), else, for a call that
        hands over a mesh, every def of that name with a mesh parameter."""
        table = self.run_state.table
        func = call.func
        if isinstance(func, ast.Name) and func.id in self.local_defs \
                and func.id not in self.env:
            info = table.by_node.get(id(self.local_defs[func.id]))
            return [(info, False)] if info is not None else None
        if self.ctx.is_mesh_module or self.ctx.is_collectives_module:
            return None
        cls = self.info.cls if self.info is not None else None
        targets = self.aliases.get(func.id, [func]) if isinstance(func, ast.Name) else [func]
        hits = []
        for target in targets:
            resolved = table.graph.resolve(self.ctx.module, target, cls)
            if resolved is not None:
                info = table.funcs.get(resolved[0].key)
                if info is not None and info.path not in (MESH_PATH, COLLECTIVES_PATH):
                    hits.append((info, resolved[1]))
        if hits:
            return hits
        name = (dotted_name(func) or "").split(".")[-1]
        if name in table.mesh_named and _passes_mesh(call):
            return [(info, info.cls is not None) for info in table.mesh_named[name]]
        return None

    def bind(self, info: FuncInfo, args, kwargs, skip_self):
        """The callee's parameter environment: positionals, keywords, the
        defaults of the rest (a mesh parameter is a mesh)."""
        fn = info.node
        params = list(fn.args.posonlyargs) + list(fn.args.args)
        if (skip_self or info.cls is not None) and params and params[0].arg in ("self", "cls"):
            params = params[1:]
        defaults = list(fn.args.defaults)
        default_of = {p.arg: d for p, d in zip(params[len(params) - len(defaults):], defaults)}
        for p, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
            if d is not None:
                default_of[p.arg] = d
        env: Dict[str, object] = {}
        for i, p in enumerate(params):
            if i < len(args):
                env[p.arg] = args[i]
            elif p.arg in kwargs:
                env[p.arg] = kwargs[p.arg]
            elif p.arg in default_of:
                env[p.arg] = self.default_value(default_of[p.arg])
            else:
                env[p.arg] = UNKNOWN_VAL
        for p in fn.args.kwonlyargs:
            env[p.arg] = kwargs.get(p.arg, self.default_value(default_of.get(p.arg)))
        for p in params + list(fn.args.kwonlyargs):
            if _is_mesh_param(p):
                v = _scalar(env[p.arg])
                env[p.arg] = v if v.mesh or v.const is None else v.join(MESH_VAL)
        return env

    @staticmethod
    def default_value(node: Optional[ast.AST]):
        if isinstance(node, ast.Constant):
            return _const(node.value)
        return UNIFORM

    def call_function(self, info: FuncInfo, call: ast.Call, args, kwargs, skip_self,
                      closure=None):
        key = (info.path, info.qualname)
        if self.depth >= MAX_DEPTH or key in self.seen:
            joined = UNIFORM
            for v in list(args) + list(kwargs.values()):
                joined = joined.join(_strip(_scalar(v)))
            return joined
        env = self.bind(info, args, kwargs, skip_self)
        if closure is None:
            closure = self.env if info.parent is not None \
                and info.path == self.ctx.module.path else {}
        value, returns = self.interpret(info, {**closure, **env}, call.lineno, not closure)
        if closure is self.env and self.last_env is not None:
            # a nested def cannot rebind its parent's names, but it can fill
            # their containers (`segs.append(...)`)
            own = {n.id for n in ast.walk(info.node) if isinstance(n, ast.Name)
                   and isinstance(n.ctx, ast.Store)} | set(env)
            for name, before in closure.items():
                after = self.last_env.get(name, before)
                if name not in own and after is not before:
                    self.env[name] = _join(before, after)
        run = self.run_state
        if key in run.table.ranked and not run.open and self.record:
            self.check_claim(info, returns, call.lineno)
        return value

    def interpret(self, info: FuncInfo, env, line: int, fresh_closure: bool):
        run = self.run_state
        ctx = run.context(info.path)
        key = (info.path, info.qualname)
        ranked = key in run.table.ranked
        memo_key = (key, tuple(sorted((k, _freeze(v)) for k, v in env.items())),
                    self.divergent, self.record) if fresh_closure else None
        self.last_env = None
        if memo_key is not None and memo_key in run.memo:
            value, returns, counts = run.memo[memo_key]
            if ranked and self.record:
                run.body(info).bindings.append(Binding(
                    (self.ctx.module.path, line), self._params(info, env), *counts))
            if self.record:
                for binding in run.open:
                    binding.collectives += counts[0]
                    binding.resolved += counts[1]
            return value, returns
        binding = None
        if ranked and self.record:
            binding = Binding((self.ctx.module.path, line), self._params(info, env))
            run.body(info).bindings.append(binding)
            run.open.append(binding)
        before = [(b.collectives, b.resolved) for b in run.open]
        sub = BodyInterpreter(run, ctx, info, info.node, env, self.depth + 1, self.record,
                              self.divergent, self.seen | {key})
        try:
            sub.run(info.node.body)
        finally:
            if binding is not None:
                run.open.pop()
        value = sub.return_value()
        self.last_env = sub.env
        counts = (binding.collectives, binding.resolved) if binding is not None else (
            (run.open[-1].collectives - before[-1][0], run.open[-1].resolved - before[-1][1])
            if run.open else (0, 0))
        if memo_key is not None:
            run.memo[memo_key] = (value, sub.returns, counts)
        return value, sub.returns

    @staticmethod
    def _params(info: FuncInfo, env) -> Dict[str, AbsVal]:
        fn = info.node
        names = [a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)
                 + list(fn.args.kwonlyargs)]
        return {n: _scalar(env[n]) for n in names if n in env}

    def ref(self, fn: ast.AST) -> FuncRef:
        return FuncRef(fn, dict(self.env), self.ctx, self.info, self.fn)

    def call_ref(self, ref: FuncRef, call: Optional[ast.Call], args, kwargs):
        """Run a callable value on `args`: a lambda's expression or a nested
        def's body, in the scope it closes over."""
        fn = ref.node
        if self.depth >= MAX_DEPTH:
            return UNKNOWN_VAL
        if isinstance(fn, ast.Lambda):
            params = list(fn.args.posonlyargs) + list(fn.args.args)
            env = {**ref.env, **{p.arg: args[i] if i < len(args) else kwargs.get(
                p.arg, UNKNOWN_VAL) for i, p in enumerate(params)}}
            sub = BodyInterpreter(self.run_state, ref.ctx, ref.info, ref.owner, env,
                                  self.depth + 1, self.record, self.divergent, self.seen)
            return sub.eval(fn.body)
        info = self.run_state.table.by_node.get(id(fn))
        if info is None:
            return UNKNOWN_VAL
        line = call if call is not None else fn
        return self.call_function(info, line, args, kwargs, False, closure=ref.env)

    def callback_value(self, ref: FuncRef):
        """The value of a callable an opaque runtime calls back (a loader's
        fetch, a stager's fill): its result, its arguments (indices, batch
        ids, buffers) the same on every rank."""
        fn = ref.node
        params = list(fn.args.posonlyargs) + list(fn.args.args)
        args = [MESH_VAL if _is_mesh_param(p) else UNIFORM for p in params]
        return self.call_ref(ref, None, args, {})

    def return_value(self):
        if not self.returns:
            return UNIFORM
        out = self.returns[0][0]
        for v, _ in self.returns[1:]:
            out = _join(out, v)
        return out

    # -- the claim ------------------------------------------------------------
    def check_claim(self, info: FuncInfo, returns, call_line: int):
        """A ranked body called from outside any ranked body returns what
        every rank keeps: uniform, but over the axes a fleet_sharding /
        model_sharding placement declared on the value."""
        for value, ret_line in returns:
            elts = value.elts if isinstance(value, TupleVal) else [value]
            leftover: Set[str] = set()
            for elt in elts:
                v = _scalar(elt)
                if v.unknown or v.mesh or v.sharding is not None:
                    continue
                leftover |= v.axes - v.declared
            if leftover:
                self.run_state.events.append(SpmdEvent(
                    info.path, ret_line, "unreduced-output", info.node.name,
                    (tuple(sorted(leftover)), call_line)))

    def check_cut(self, call: ast.Call, name: str):
        """A rank cut's leaf tagged `replicated` must be the same on every
        rank: rank 0's part is what a restore reads."""
        kwargs = {kw.arg: kw.value for kw in call.keywords}
        mesh = kwargs.get("mesh")
        if mesh is None or _scalar(self.eval(mesh)).const is None:
            return
        sections = call.args[2] if len(call.args) > 2 else kwargs.get("sections")
        if not isinstance(sections, ast.Dict):
            return
        specs = _scalar(self.eval(kwargs["specs"])).const if "specs" in kwargs else None
        for key, value in zip(sections.keys, sections.values):
            if not isinstance(key, ast.Constant):
                continue
            tag = specs
            if isinstance(specs, tuple) and specs[:1] == ("<dict>",):
                tag = dict(specs[1:]).get(key.value, "replicated")
            if tag == NOCONST:
                continue
            leaves = self.eval(value)
            leaves = leaves.elts if isinstance(leaves, TupleVal) else [leaves]
            tags = tag if isinstance(tag, tuple) else (tag or "replicated",) * len(leaves)
            leftover: Set[str] = set()
            for leaf, t in zip(leaves, tags):
                v = _scalar(leaf)
                if t == "replicated" and not v.unknown:
                    leftover |= v.axes
            if leftover:
                self.emit(call.lineno, "unreduced-output", name,
                          (tuple(sorted(leftover)), call.lineno))

    # -- collectives --------------------------------------------------------
    def apply_collective(self, call: ast.Call, collective):
        op, kind, axis_param, default_axis, operand_params, mesh_param = collective
        operands = [_strip(_scalar(self.eval(call.args[pos]))) for pos in operand_params
                    if pos < len(call.args)]
        operand = operands[0] if operands else UNIFORM
        for other in operands[1:]:
            operand = operand.join(other)
        mesh_node = call.args[mesh_param] if mesh_param is not None and mesh_param < len(
            call.args) else next((kw.value for kw in call.keywords if kw.arg == "mesh"), None)
        mesh = _scalar(self.eval(mesh_node)) if mesh_node is not None else MESH_VAL
        for i, a in enumerate(call.args):
            if i not in operand_params and i != axis_param and i != mesh_param:
                self.eval(a)
        for kw in call.keywords:
            if kw.arg not in ("axis_name", "mesh"):
                self.eval(kw.value)
        axis = None
        if axis_param >= 0:
            node = _axis_arg(call, axis_param)
            if node is None:
                axis = default_axis
            else:
                axis = self.axis_of(node)
        axes = None
        if axis is not None:
            axes = frozenset(self.ctx.axes.known_axes) if (
                mesh.mesh == 2 and axis == self._data_axis()) else frozenset({axis})

        if self.divergent is not None and kind in BLOCKING_KINDS:
            branch_line, reason = self.divergent
            self.emit(call.lineno, "divergent-collective", op,
                      extra=(branch_line, reason, axis or "?"))
        if kind in BLOCKING_KINDS:
            varies = bool(operand.axes & axes) if axes is not None else bool(operand.axes)
            state = "unknown" if operand.unknown else ("varies" if varies else "uniform")
            self.emit(call.lineno, "collective", op, extra=(kind, axis or "?", state))
            if self.record:
                for binding in self.run_state.open:
                    binding.collectives += 1
                    binding.resolved += state == "varies"

        if kind == "size":
            return UNIFORM
        if kind == "index":
            return self.index_value(axis, mesh) if axis else UNKNOWN_VAL
        if kind in ("broadcast", "object"):
            # in place: the list or tensor handed over is now the root's
            target = call.args[0] if call.args else None
            if isinstance(target, ast.Name):
                self.env[target.id] = AbsVal(gathered=kind == "object")
            return UNIFORM
        if axes is None or operand.unknown:
            if kind in ("reduce", "gather"):
                return AbsVal(unknown=operand.unknown, gathered=kind == "gather")
            return operand
        if kind == "reduce":
            missing = sorted(axes - operand.axes)
            if missing and not operand.filled:
                self.emit(call.lineno, "double-reduce", op, extra=(missing[0],))
            if operand.narrowed:
                self.emit(call.lineno, "downcast-before-reduce", op, extra=(operand.narrowed,))
            if operand.fleet and op in ADDING_OPS and self._data_axis() in (axes & operand.axes):
                self.emit(call.lineno, "cross-member-reduce", op, extra=(axis,))
            return AbsVal(axes=operand.axes - axes, declared=operand.declared - axes)
        if kind == "gather":
            if not axes & operand.axes:
                self.emit(call.lineno, "unsharded-collective", op, extra=(axis,))
            return AbsVal(axes=operand.axes - axes, narrowed=operand.narrowed, gathered=True,
                          declared=operand.declared - axes)
        if kind == "permute":
            if not axes & operand.axes:
                self.emit(call.lineno, "unsharded-collective", op, extra=(axis,))
            return AbsVal(axes=operand.axes | axes, narrowed=operand.narrowed, permuted=True,
                          declared=operand.declared)
        return operand

    # -- statements ---------------------------------------------------------
    def assign(self, target: ast.AST, value):
        if isinstance(target, ast.Name):
            self.env[target.id] = value
            self.views.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, TupleVal) and len(value.elts) == len(target.elts):
                for elt, v in zip(target.elts, value.elts):
                    self.assign(elt.value if isinstance(elt, ast.Starred) else elt, v)
            else:
                collapsed = _strip(_scalar(value))
                for elt in target.elts:
                    self.assign(elt.value if isinstance(elt, ast.Starred) else elt, collapsed)
        elif isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name):
            # a store into a container (and the buffer it is a view of): it
            # takes on the value's variance
            stored = _strip(_scalar(value)).join(_strip(_scalar(self.eval(target.slice))))
            name, seen = target.value.id, set()
            while name is not None and name not in seen:
                seen.add(name)
                self.env[name] = _strip(_scalar(self.env.get(name, UNIFORM))).join(stored)
                name = self.views.get(name)

    def run(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self.run_statement(stmt)

    def run_statement(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # interpreted where it is called
        if isinstance(stmt, ast.Return):
            self.returns.append((self.eval(stmt.value), stmt.lineno))
            return
        if isinstance(stmt, ast.Assign):
            value = self.eval(stmt.value)
            for target in stmt.targets:
                self.assign(target, value)
            base = _view_base(stmt.value)
            if base is not None:
                for target in stmt.targets:
                    for elt in (target.elts if isinstance(target, (ast.Tuple, ast.List))
                                else [target]):
                        if isinstance(elt, ast.Name) and elt.id != base:
                            self.views[elt.id] = base
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.assign(stmt.target, self.eval(stmt.value))
            return
        if isinstance(stmt, ast.AugAssign):
            value = _strip(_scalar(self.eval(stmt.value)))
            if isinstance(stmt.target, ast.Name):
                prev = _strip(_scalar(self.env.get(stmt.target.id, UNIFORM)))
                self.env[stmt.target.id] = prev.join(value)
            return
        if isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
            return
        if isinstance(stmt, ast.If):
            test = _scalar(self.eval(stmt.test))
            if test.const != NOCONST and not test.unknown:
                self.run(stmt.body if test.const else stmt.orelse)
                return
            single = self.one_rank_when(stmt.test)
            self.branch(stmt, test, "branch condition varies per rank",
                        lambda: self.arms(test, stmt.body, stmt.orelse, single))
            return
        if isinstance(stmt, ast.While):
            test = _scalar(self.eval(stmt.test))
            self.branch(stmt, test, "loop condition varies per rank",
                        lambda: self.loop(stmt.body, stmt.orelse))
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            iter_val = _strip(_scalar(self.eval(stmt.iter)))
            self.assign(stmt.target, iter_val)
            self.branch(stmt, iter_val, "loop iterates per-rank data",
                        lambda: self.loop(stmt.body, stmt.orelse))
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                val = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, val)
            self.run(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.run(stmt.body)
            for handler in stmt.handlers:
                if handler.name:
                    self.env[handler.name] = UNIFORM
                self.run(handler.body)
            self.run(stmt.orelse)
            self.run(stmt.finalbody)
            return

    def branch(self, stmt, test: AbsVal, reason: str, body) -> None:
        prev = self.divergent
        if test.axes and not test.unknown and prev is None:
            self.divergent = (stmt.lineno, reason)
        body()
        self.divergent = prev

    def one_rank_when(self, test: ast.AST, depth: int = 0) -> Optional[bool]:
        """Whether the test being True (or False) means a world of one rank:
        `mesh.size > 1`, `mesh.size <= 1`, `mesh.size == 1`, `not` of one,
        or a local name bound to one (`ranked = mesh.size > 1`). None when
        it says nothing of the rank count."""
        if depth > 3:
            return None
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = self.one_rank_when(test.operand, depth + 1)
            return None if inner is None else not inner
        if isinstance(test, ast.Name) and test.id in self.assigned:
            return self.one_rank_when(self.assigned[test.id], depth + 1)
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.left, ast.Attribute) and test.left.attr == "size"
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value == 1
                and _scalar(self.eval(test.left.value)).mesh):
            return None
        op = test.ops[0]
        if isinstance(op, (ast.LtE, ast.Eq)):
            return True
        if isinstance(op, (ast.Gt, ast.NotEq)):
            return False
        return None

    def arms(self, test: AbsVal, body, orelse, single: Optional[bool] = None) -> None:
        """Both arms of an `if` from the same entry state, merged after: where
        one arm left a value unknown and the other resolved it, the resolved
        one (the engine under-approximates: a restore arm that stages an
        unknown layout does not hide the fresh fit's); else the join. A value
        an arm sets under a rank-varying test varies with the test."""
        entry = dict(self.env)
        taken = self.run_arm(body, single is True, entry)
        self.env = dict(entry)
        other = self.run_arm(orelse, single is False, entry)
        merged = dict(entry)
        for name in set(taken) | set(other):
            a, b = taken.get(name, entry.get(name)), other.get(name, entry.get(name))
            if a is None or b is None or a is b:
                value = b if a is None else a
            elif _scalar(a).unknown and not _scalar(b).unknown:
                value = b
            elif _scalar(b).unknown and not _scalar(a).unknown:
                value = a
            else:
                value = _join(a, b)
            if test.axes and not test.unknown and value is not entry.get(name) \
                    and not isinstance(value, FuncRef):
                value = _indexed(_scalar(value), _strip(test))
            merged[name] = value
        self.env = merged

    def run_arm(self, body, one_rank: bool, entry) -> Dict[str, object]:
        """Run an arm; in a world of one rank (`one_rank`) it runs quietly and
        nothing it makes varies: there is no other rank to differ from."""
        if not one_rank:
            self.run(body)
            return self.env
        record, self.record = self.record, False
        try:
            self.run(body)
        finally:
            self.record = record
        for name, value in list(self.env.items()):
            if value is not entry.get(name) and not isinstance(value, FuncRef):
                v = _scalar(value)
                self.env[name] = AbsVal(**{**v.__dict__, "axes": frozenset(),
                                           "declared": frozenset()})
        return self.env

    def loop(self, body, orelse) -> None:
        """A Python loop of a ranked body: one quiet pass, its state joined
        into the entry state (what the second iteration sees), then the
        recording pass."""
        if self.record:
            entry = dict(self.env)
            self.record = False
            try:
                self.run(body)
            finally:
                self.record = True
            for name, value in entry.items():
                if name in self.env and self.env[name] is not value:
                    self.env[name] = _join(value, self.env[name])
        self.run(body)
        self.run(orelse)


def _freeze(v):
    return v if isinstance(v, (AbsVal, TupleVal)) else repr(v)


# ---------------------------------------------------------------------------
# module-level scans
# ---------------------------------------------------------------------------

def _assignment_env(scopes: List[ast.AST]) -> Dict[str, ast.AST]:
    """name -> value expression for the simple assignments of the enclosing
    scopes (outermost first, so inner scopes shadow)."""
    env: Dict[str, ast.AST] = {}
    for scope in scopes:
        for stmt in getattr(scope, "body", []):
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                env[stmt.targets[0].id] = stmt.value
    return env


def _scan_axis_literals(ctx: ModuleContext, events: List[SpmdEvent]) -> None:
    """Axis hygiene, independent of the ranked bodies: every collective
    call's axis, every `RankSharding` spec, `create_mesh(axis_names=)` /
    `Mesh(...)`, and `mesh.axis_index` / `axis_group` / `collectives.
    axis_index` arguments."""
    module = ctx.module
    if module.tree is None or module.path == MESH_PATH:
        return  # mesh.py DECLARES the constants: its literals are the truth

    def check(resolved, line_fallback: int):
        if resolved is None:
            return
        kind, value = resolved[0], resolved[1]
        line = resolved[2] if kind == "literal" else line_fallback
        if value not in ctx.axes.known_axes:
            events.append(SpmdEvent(module.path, line, "unknown-axis", value))
        elif kind == "literal":
            events.append(SpmdEvent(module.path, line, "axis-bypass", value,
                                    (ctx.axes.by_value.get(value, ""),)))

    def visit(node: ast.AST, scopes: List[ast.AST]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes = scopes + [node]
        for child in ast.iter_child_nodes(node):
            visit(child, scopes)
        if not isinstance(node, ast.Call):
            return
        env = _assignment_env(scopes)
        name = dotted_name(node.func)
        base = name.split(".")[-1] if name else ""
        collective = ctx.collective_for(node)
        if collective is not None:
            if collective[2] >= 0:
                axis_node = _axis_arg(node, collective[2])
                if axis_node is not None:
                    check(ctx.resolve_axis(axis_node, env), node.lineno)
            return
        mesh_fn = ctx.mesh_func(node.func)
        if mesh_fn == "RankSharding":
            spec = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "spec"), None)
            if isinstance(spec, (ast.Tuple, ast.List)):
                for elt in spec.elts:
                    if not (isinstance(elt, ast.Constant) and elt.value is None):
                        check(ctx.resolve_axis(elt, env), node.lineno)
            return
        if mesh_fn in ("create_mesh", "Mesh"):
            candidates = list(node.args[:1]) + [
                kw.value for kw in node.keywords if kw.arg == "axis_names"]
            for cand in candidates:
                if isinstance(cand, (ast.Tuple, ast.List)):
                    for elt in cand.elts:
                        check(ctx.resolve_axis(elt, env), node.lineno)
            return
        if base in ("axis_index", "axis_group") and isinstance(node.func, ast.Attribute) \
                and node.args and (dotted_name(node.func.value) or "").endswith("mesh"):
            check(ctx.resolve_axis(node.args[0], env), node.lineno)

    visit(module.tree, [module.tree])


def _scan_order_folds(ctx: ModuleContext, events: List[SpmdEvent]) -> None:
    """A Python loop whose body both calls a permute collective and
    accumulates into a loop-carried name reassociates the sum; the
    replica-order folds live only in collectives.py and overlap.py."""
    module = ctx.module
    if module.tree is None or module.path in SANCTIONED_FOLD_PATHS:
        return

    def loop_has_permute(loop: ast.AST) -> Optional[int]:
        for sub in ast.walk(loop):
            if isinstance(sub, ast.Call):
                collective = ctx.collective_for(sub)
                if collective is not None and collective[1] == "permute":
                    return sub.lineno
        return None

    def loop_accumulates(loop: ast.AST) -> bool:
        for sub in ast.walk(loop):
            if isinstance(sub, ast.AugAssign) and isinstance(sub.op, (ast.Add, ast.Sub)):
                return True
            if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)
                    and isinstance(sub.value, ast.BinOp)
                    and isinstance(sub.value.op, (ast.Add, ast.Sub))):
                target = sub.targets[0].id
                if any(isinstance(o, ast.Name) and o.id == target for o in ast.walk(sub.value)):
                    return True
        return False

    for node in ast.walk(module.tree):
        if isinstance(node, (ast.For, ast.While)):
            permute_line = loop_has_permute(node)
            if permute_line is not None and loop_accumulates(node):
                events.append(SpmdEvent(module.path, permute_line, "order-fold", "ppermute",
                                        (node.lineno,)))


# ---------------------------------------------------------------------------
# the interpretation (project-level, memoized)
# ---------------------------------------------------------------------------

@dataclass
class SpmdInterpretation:
    events: List[SpmdEvent] = field(default_factory=list)
    bodies: Dict[Tuple[str, str], RankedBody] = field(default_factory=dict)

    def of_kind(self, *kinds: str) -> List[SpmdEvent]:
        wanted = set(kinds)
        return [e for e in self.events if e.kind in wanted]

    def body(self, path: str, qualname: str) -> Optional[RankedBody]:
        return self.bodies.get((path, qualname))

    def counts(self) -> Dict[str, int]:
        """Events by kind."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return dict(sorted(out.items()))


def _roots(table: FunctionTable) -> Tuple[List[FuncInfo], List[FuncInfo]]:
    """The entries (defs outside the ranked bodies that call one: their
    parameters are uniform by the SPMD convention) and the ranked bodies no
    def of the package calls (their parameters are unknown)."""
    called: Set[Tuple[str, str]] = set()
    entries: List[FuncInfo] = []
    for key, info in table.funcs.items():
        callees = {(c.path, c.qualname) for c in table.callees(info)}
        called |= callees
        if key not in table.ranked and info.parent is None and callees & table.ranked:
            entries.append(info)
    orphans = [table.funcs[k] for k in sorted(table.ranked) if k not in called
               and table.funcs[k].parent is None]
    return entries, orphans


def _build_interpretation(project) -> SpmdInterpretation:
    out = SpmdInterpretation()
    run = Run(project)
    for module in project.modules:
        if module.tree is None:
            continue
        ctx = run.context(module.path)
        _scan_axis_literals(ctx, out.events)
        _scan_order_folds(ctx, out.events)
    entries, orphans = _roots(run.table)
    for info, unknown in [(i, False) for i in entries] + [(i, True) for i in orphans]:
        ctx = run.context(info.path)
        root = BodyInterpreter(run, ctx, None, info.node, {}, depth=0)
        params = list(info.node.args.posonlyargs) + list(info.node.args.args) + list(
            info.node.args.kwonlyargs)
        if info.cls is not None and params and params[0].arg in ("self", "cls"):
            params = params[1:]
        env = {p.arg: (MESH_VAL if _is_mesh_param(p) else (UNKNOWN_VAL if unknown else UNIFORM))
               for p in params}
        root.interpret(info, env, info.node.lineno, True)
    out.events.extend(run.events)
    out.bodies = run.bodies
    # one event per (path, line, kind, detail): a body interpreted at several
    # call sites would otherwise repeat itself
    seen: Set[Tuple] = set()
    unique: List[SpmdEvent] = []
    for e in out.events:
        key = (e.path, e.line, e.kind, e.detail)
        if key not in seen:
            seen.add(key)
            unique.append(e)
    out.events = unique
    return out


def interpretation(project) -> SpmdInterpretation:
    return project.index("spmd", _build_interpretation)


#: the per-rank loops the card's mesh phases drive (chip_smoke phases 16-17),
#: by (path in the package, qualname): the interpretation gate holds that the
#: interpreter reaches each of them with its collectives
RANKED_LOOPS = (
    ("ops/optimizer.py", "_sharded_epochs"),
    ("ops/optimizer.py", "_sgd_train_sharded"),
    ("ops/optimizer.py", "_fleet_sharded_masked_epoch"),
    ("parallel/overlap.py", "overlapped_sgd_train"),
    ("parallel/overlap.py", "overlapped_lloyd_train"),
    ("parallel/overlap.py", "sgd2d_chunk"),
    ("parallel/overlap.py", "sgd2d_finish"),
    ("parallel/overlap.py", "sgd2d_whole_fit"),
    ("models/clustering/kmeans.py", "_lloyd_train_sharded"),
    ("models/clustering/kmeans.py", "_lloyd_fleet_sharded"),
    ("ops/optimizer.py", "SGD.optimize_stream"),
    ("models/clustering/kmeans.py", "KMeans._lloyd_stream"),
    ("ops/losses.py", "_feature_sharded.fn"),
    ("ckpt/coordinator.py", "save_rank_cut"),
)


def gate(project) -> Dict[str, Tuple[int, int, bool]]:
    """The interpretation gate: for each of RANKED_LOOPS, `path:qualname`
    -> (call-site bindings, the most collectives one binding reached,
    whether some binding reached a collective whose operand was resolved and
    varies over its axis). A loop the interpreter never reached is (0, 0,
    False)."""
    interp = interpretation(project)
    out: Dict[str, Tuple[int, int, bool]] = {}
    for path, qualname in RANKED_LOOPS:
        body = interp.body(f"{PACKAGE}/{path}", qualname)
        out[f"{path}:{qualname}"] = (0, 0, False) if body is None else (
            len(body.bindings), body.collectives, body.resolved)
    return out
