"""The port's SPMD rules (flink_ml_tpu_torch/analysis/spmd.py and the seven
rules over it) against the JAX package's.

- **held against the JAX rules**: every case of the JAX package's tests of
  `mesh-axis`, `collective-divergence`, `spec-consistency` (the vmap cases
  too), `precision-determinism`, `sharding-tags`, `donation-after-use` (the
  interprocedural cases too) and the collective half of the accounting
  rules (tests/test_tpulint_rules.py). The JAX fixture goes through the JAX
  rule and its torch transliteration, a ranked body of the port's idiom,
  through the port's rule: both give the same rule id and `data[0]` on the
  same lines, and the negatives give nothing in either package. Two
  readings differ by design (ROADMAP C.37): `spec-arity` is pinned silent
  in the port, and the accounting rule names the torch primitive;
- **port-only cases**: C.30's scatter of gathered pairs through
  `sparse_grad`, C.36's replicated fit reduced over the flattened world, a
  reduce across a fleet's members, an unknown tag `sharding_for_tag` would
  place replicated, a `non_blocking` readback read before and after its
  sync, and the interpreter's reading of callbacks, views and one-rank
  branches;
- **the real tree**: the interpretation gate chip_smoke's phase 15 runs
  (every per-rank loop of phases 16-17 reached, with collectives and
  resolved operands), and one mutation canary a rule: a real module with a
  one-line planted fault, on which the rule fires at that line and nowhere
  else. The whole port linting clean under all 20 rules is held by
  tests/test_torch_tpulint.py.
"""

import textwrap
from pathlib import Path

import pytest

from flink_ml_tpu.analysis import engine as jax_engine
from flink_ml_tpu_torch.analysis import engine, spmd
from flink_ml_tpu_torch.analysis.source import SourceModule

REPO = Path(__file__).resolve().parent.parent
PORT = "flink_ml_tpu_torch"


def _tree(root, package, files):
    for rel, text in files.items():
        path = root / package / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return root


def _lint(tmp_path, pkg, files, rule_ids):
    eng, package = (jax_engine, "flink_ml_tpu") if pkg == "jax" else (engine, PORT)
    root = _tree(tmp_path / pkg, package, {"__init__.py": "", **files})
    project = eng.Project.load(root=str(root), scope=(package,))
    return eng.run(root=str(root), rules=[eng.get_rule(r) for r in rule_ids], project=project)


def _where(findings):
    """(rule, path inside the package, line, data[0]) of each finding."""
    return sorted((f.rule, f.path.split("/", 1)[1], f.line, f.data[0] if f.data else None)
                  for f in findings)


# ---------------------------------------------------------------------------
# the fixture stubs: the JAX package's (tests/test_tpulint_rules.py) and the
# port's, at the same relative paths
# ---------------------------------------------------------------------------

JAX_LAZYJIT = {
    "utils/lazyjit.py": """
        def lazy_jit(fn, **kw):
            return fn
        def keyed_jit(make, **kw):
            return make
    """,
    "utils/__init__.py": "",
    "models/__init__.py": "",
}

JAX_SPMD = {
    "parallel/__init__.py": "",
    "parallel/mesh.py": """
        DATA_AXIS = "data"
        MODEL_AXIS = "model"

        def create_mesh(axis_names=(DATA_AXIS,), shape=None, devices=None):
            pass
    """,
    "parallel/collectives.py": """
        from jax import lax

        from .mesh import DATA_AXIS, MODEL_AXIS

        def all_reduce_sum(x, axis_name=DATA_AXIS):
            return lax.psum(x, axis_name)

        def all_reduce_min(x, axis_name=DATA_AXIS):
            return lax.pmin(x, axis_name)

        def all_gather(x, axis_name=DATA_AXIS, axis=0, tiled=True):
            return lax.all_gather(x, axis_name, axis=axis, tiled=tiled)

        def ppermute_ring(x, axis_name=DATA_AXIS, shift=1):
            return lax.ppermute(x, axis_name, [(0, 0)])

        def axis_index(axis_name=DATA_AXIS):
            return lax.axis_index(axis_name)

        def axis_size(axis_name=DATA_AXIS):
            return 1

        def shard_map_over(mesh, in_specs, out_specs, fn=None, check_vma=False):
            return fn
    """,
    **JAX_LAZYJIT,
}

PORT_MESH = """
    DATA_AXIS = "data"
    MODEL_AXIS = "model"

    class Mesh:
        def axis_index(self, axis_name):
            return 0

    def create_mesh(axis_names=(DATA_AXIS,), shape=None, group=None):
        return Mesh()

    def create_mesh_2d(model_shards, num_hosts=None, group=None):
        return Mesh()

    def default_mesh():
        return Mesh()

    def flatten(mesh):
        return mesh

    class RankSharding:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec

        def take(self, array, pad_value=0):
            return array

    def data_sharding(mesh, ndim=1):
        return RankSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))

    def replicated_sharding(mesh):
        return RankSharding(mesh, ())

    def model_sharding(mesh, ndim=1):
        return RankSharding(mesh, (None,) * (ndim - 1) + (MODEL_AXIS,))

    def data_model_sharding(mesh, ndim=2):
        return RankSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 2) + (MODEL_AXIS,))

    def fleet_sharding(mesh, ndim=2):
        return RankSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))

    def shard_axis_for_tag(tag, ndim):
        if tag == "data":
            return 0
        if tag == "model":
            return ndim - 1
        return None

    def sharding_for_tag(tag, mesh, ndim):
        if tag == "data":
            return data_sharding(mesh, max(1, ndim))
        if tag == "model":
            return model_sharding(mesh, max(1, ndim))
        return replicated_sharding(mesh)
"""

PORT_COLLECTIVES = """
    import torch
    import torch.distributed as dist

    from .mesh import DATA_AXIS, MODEL_AXIS

    def all_reduce_sum(x, axis_name=DATA_AXIS, mesh=None):
        dist.all_reduce(x)
        return x

    def all_reduce_min(x, axis_name=DATA_AXIS, mesh=None):
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return x

    def all_gather(x, axis_name=DATA_AXIS, axis=0, tiled=True, mesh=None):
        out = torch.empty_like(x)
        dist.all_gather_into_tensor(out, x)
        return out

    def ppermute_ring(x, axis_name=DATA_AXIS, shift=1, mesh=None):
        return dist.batch_isend_irecv([])

    def axis_index(axis_name=DATA_AXIS, mesh=None):
        return 0

    def axis_size(axis_name=DATA_AXIS, mesh=None):
        return 1

    def scatter_pairs(indices, values, dim):
        out = values.new_zeros((dim,))
        return out.index_put_((indices.long(),), values, accumulate=True)
"""

PORT_SPMD = {
    "parallel/__init__.py": "",
    "parallel/mesh.py": PORT_MESH,
    "parallel/collectives.py": PORT_COLLECTIVES,
    "models/__init__.py": "",
}

JAX_SNAPSHOT = {
    "ckpt/snapshot.py": """
        _SPEC_TAGS = ("replicated", "data", "model", "host")

        def _sharding_for(tag, mesh, ndim):
            if tag == "data":
                return "D"
            if tag == "model":
                return "M"
            return "R"

        def save_job_snapshot(path, key, sections, specs=None, **kw):
            pass

        def stage_section(snap, name, mesh=None, specs=None):
            pass
    """,
    "ckpt/__init__.py": "",
    "parallel/mesh.py": """
        def replicated_sharding(mesh):
            pass

        def data_sharding(mesh, ndim=1):
            pass

        def model_sharding(mesh, ndim=1):
            pass
    """,
    "parallel/__init__.py": "",
    **JAX_LAZYJIT,
}

PORT_SNAPSHOT = {
    "ckpt/snapshot.py": """
        _SPEC_TAGS = ("replicated", "data", "model", "host")

        def save_job_snapshot(path, key, sections, specs=None, mesh=None, **kw):
            pass

        def stage_section(snap, name, device=None, specs=None, mesh=None):
            pass
    """,
    "ckpt/__init__.py": "",
    "parallel/mesh.py": PORT_MESH,
    "parallel/__init__.py": "",
    "models/__init__.py": "",
}

JAX_DONATING_PRELUDE = (
    "import jax\n"
    "\n"
    "def _impl(a, b):\n"
    "    return a + b\n"
    "\n"
    "_step = jax.jit(_impl)\n"
    "_step_donating = jax.jit(_impl, donate_argnums=(0,))\n"
)

#: the port's prelude, line for line: a pinned host buffer and a blocking copy
PORT_DONATING_PRELUDE = (
    "import torch\n"
    "\n"
    "def _host(like):\n"
    "    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)\n"
    "\n"
    "def _step(host, dev):\n"
    "    return host.copy_(dev)\n"
)


# ---------------------------------------------------------------------------
# the JAX cases and their transliterations
# ---------------------------------------------------------------------------

def _case(rule, jax, port, lines, suppressed=(), unused=()):
    return {"rule": rule, "jax": jax, "port": port, "lines": list(lines),
            "suppressed": list(suppressed), "unused": list(unused)}


CASES = {
    # -- mesh-axis (TestMeshAxis) --------------------------------------------
    "mesh-axis/unknown-axis-literal": _case("mesh-axis", {
        "models/bad.py": """
            from ..parallel.collectives import all_reduce_sum

            def reduce(x):
                return all_reduce_sum(x, "dta")
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel.collectives import all_reduce_sum

            def reduce(x, mesh):
                return all_reduce_sum(x, "dta", mesh)
        """, **PORT_SPMD}, [5]),
    "mesh-axis/constant-bypass-literal": _case("mesh-axis", {
        "models/bad.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives

            def reduce(x):
                return collectives.all_reduce_sum(x, "data")

            def spec():
                return P("model", None)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel.mesh import RankSharding
            from ..parallel import collectives

            def reduce(x, mesh):
                return collectives.all_reduce_sum(x, "data", mesh)

            def spec(mesh):
                return RankSharding(mesh, ("model", None))
        """, **PORT_SPMD}, [6, 9]),
    "mesh-axis/gather-over-unsharded-axis": _case("mesh-axis", {
        "models/bad.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            def build(mesh):
                def body(x):
                    return collectives.all_gather(x, MODEL_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(DATA_AXIS), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            def build(X):
                def body(mesh, x):
                    return collectives.all_gather(x, MODEL_AXIS, mesh=mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [8]),
    "mesh-axis/negative-constants-and-known-axes": _case("mesh-axis", {
        "models/good.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.collectives import DATA_AXIS, all_reduce_sum
            from ..parallel.mesh import MODEL_AXIS

            def reduce(x):
                return all_reduce_sum(x, DATA_AXIS)

            def reduce_feature(x):
                return collectives.all_reduce_sum(x, axis_name=MODEL_AXIS)

            def spec():
                return P(DATA_AXIS, MODEL_AXIS)
        """, **JAX_SPMD}, {
        "models/good.py": """
            from ..parallel.mesh import RankSharding
            from ..parallel import collectives
            from ..parallel.collectives import DATA_AXIS, all_reduce_sum
            from ..parallel.mesh import MODEL_AXIS

            def reduce(x, mesh):
                return all_reduce_sum(x, DATA_AXIS, mesh)

            def reduce_feature(x, mesh):
                return collectives.all_reduce_sum(x, axis_name=MODEL_AXIS, mesh=mesh)

            def spec(mesh):
                return RankSharding(mesh, (DATA_AXIS, MODEL_AXIS))
        """, **PORT_SPMD}, []),
    "mesh-axis/suppression-and-unused": _case("mesh-axis", {
        "models/mixed.py": """
            from ..parallel.collectives import all_reduce_sum

            def reduce(x):
                # tpulint: disable=mesh-axis -- exercising a foreign mesh in a compat shim
                return all_reduce_sum(x, "data")

            def clean(x):
                # tpulint: disable=mesh-axis -- nothing here
                return x
        """, **JAX_SPMD}, {
        "models/mixed.py": """
            from ..parallel.collectives import all_reduce_sum

            def reduce(x, mesh):
                # tpulint: disable=mesh-axis -- exercising a foreign mesh in a compat shim
                return all_reduce_sum(x, "data", mesh)

            def clean(x):
                # tpulint: disable=mesh-axis -- nothing here
                return x
        """, **PORT_SPMD}, [], suppressed=[6], unused=[9]),

    # -- collective-divergence (TestCollectiveDivergence) ----------------------
    "collective-divergence/axis-index-branch": _case("collective-divergence", {
        "models/bad.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    i = collectives.axis_index(DATA_AXIS)
                    if i == 0:
                        x = collectives.all_reduce_sum(x, DATA_AXIS)
                    return x
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(DATA_AXIS), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    i = collectives.axis_index(DATA_AXIS, mesh)
                    if i == 0:
                        x = collectives.all_reduce_sum(x, DATA_AXIS, mesh)
                    return x
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [10]),
    "collective-divergence/data-dependent-branch": _case("collective-divergence", {
        "models/bad.py": """
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    if jnp.sum(x) > 0:
                        x = collectives.all_gather(x, DATA_AXIS)
                    return x
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(DATA_AXIS), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    if torch.sum(x) > 0:
                        x = collectives.all_gather(x, DATA_AXIS, mesh=mesh)
                    return x
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [10]),
    "collective-divergence/negative-uniform-branch-masked": _case("collective-divergence", {
        "models/good.py": """
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh, epochs):
                def body(x):
                    total = collectives.all_reduce_sum(jnp.sum(x), DATA_AXIS)
                    if total > 0:
                        scale = 2.0
                    else:
                        scale = 1.0
                    if epochs > 1:
                        scale = scale + 1.0
                    mask = x > 0
                    return collectives.all_reduce_sum(
                        jnp.where(mask, x, 0.0), DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/good.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X, epochs):
                def body(mesh, x):
                    total = collectives.all_reduce_sum(torch.sum(x), DATA_AXIS, mesh)
                    if total > 0:
                        scale = 2.0
                    else:
                        scale = 1.0
                    if epochs > 1:
                        scale = scale + 1.0
                    mask = x > 0
                    return collectives.all_reduce_sum(
                        torch.where(mask, x, 0.0), DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, []),
    "collective-divergence/suppression": _case("collective-divergence", {
        "models/mixed.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    i = collectives.axis_index(DATA_AXIS)
                    if i == 0:
                        # tpulint: disable=collective-divergence -- single-host probe, documented
                        x = collectives.all_reduce_sum(x, DATA_AXIS)
                    return x
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(DATA_AXIS), fn=body)
        """, **JAX_SPMD}, {
        "models/mixed.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    i = collectives.axis_index(DATA_AXIS, mesh)
                    if i == 0:
                        # tpulint: disable=collective-divergence -- single-host probe, documented
                        x = collectives.all_reduce_sum(x, DATA_AXIS, mesh)
                    return x
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [], suppressed=[11]),

    # -- spec-consistency (TestSpecConsistency, TestSpecConsistencyVmap) -------
    "spec-consistency/replicated-output-never-reduced": _case("spec-consistency", {
        "models/bad.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    return x * 2.0
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    return x * collectives.axis_size(DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [8]),
    "spec-consistency/double-reduce": _case("spec-consistency", {
        "models/bad.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    y = collectives.all_reduce_sum(x, DATA_AXIS)
                    return collectives.all_reduce_sum(y, DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    y = collectives.all_reduce_sum(x, DATA_AXIS, mesh)
                    return collectives.all_reduce_sum(y, DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [9]),
    "spec-consistency/negative-reduced-output-and-carry-loop": _case("spec-consistency", {
        "models/good.py": """
            import jax.numpy as jnp
            from jax import lax
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                axis = DATA_AXIS

                def body(X, coeff):
                    def cond(state):
                        c, g, epoch = state
                        return epoch < 3

                    def step(state):
                        c, g, epoch = state
                        c = c - collectives.all_reduce_sum(g, axis)
                        g = X.T @ (X @ c)
                        return (c, g, epoch + 1)

                    init = (coeff, jnp.zeros_like(coeff), 0)
                    c, g, _ = lax.while_loop(cond, step, init)
                    return c - collectives.all_reduce_sum(g, axis)

                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS, None), P()), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/good.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X, coeff):
                axis = DATA_AXIS

                def body(mesh, X, coeff):
                    c, g = coeff, torch.zeros_like(coeff)
                    for epoch in range(3):
                        c = c - collectives.all_reduce_sum(g, axis, mesh)
                        g = X.T @ (X @ c)
                    return c - collectives.all_reduce_sum(g, axis, mesh)

                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh, 2).take(X), coeff)
        """, **PORT_SPMD}, []),
    "spec-consistency/2d-model-axis-unreduced": _case("spec-consistency", {
        "models/bad2d.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            def build(mesh):
                def body(X, coeff):
                    grad = collectives.all_reduce_sum(X @ coeff, DATA_AXIS)
                    return grad
                return collectives.shard_map_over(
                    mesh,
                    (P(DATA_AXIS, MODEL_AXIS), P(MODEL_AXIS)),
                    P(), fn=body)
        """, **JAX_SPMD}, {
        "models/bad2d.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            def build(X, coeff):
                def body(mesh, X, coeff):
                    grad = collectives.all_reduce_sum(X @ coeff, DATA_AXIS, mesh)
                    return grad
                mesh = mesh_lib.create_mesh_2d(2)
                return body(
                    mesh, mesh_lib.data_model_sharding(mesh).take(X),
                    mesh_lib.RankSharding(mesh, (MODEL_AXIS,)).take(coeff))
        """, **PORT_SPMD}, [9]),
    "spec-consistency/negative-2d-sharded-carry-out": _case("spec-consistency", {
        "models/good2d.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            def build(mesh):
                def body(X, coeff):
                    act = collectives.all_reduce_sum(
                        X @ coeff, MODEL_AXIS)
                    grad = collectives.all_reduce_sum(
                        X.T @ act, DATA_AXIS)
                    loss = collectives.all_reduce_sum(act, DATA_AXIS)
                    return coeff - grad, loss
                return collectives.shard_map_over(
                    mesh,
                    (P(DATA_AXIS, MODEL_AXIS), P(MODEL_AXIS)),
                    (P(MODEL_AXIS), P()), fn=body)
        """, **JAX_SPMD}, {
        "models/good2d.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            def build(X, coeff):
                def body(mesh, X, coeff):
                    act = collectives.all_reduce_sum(
                        X @ coeff, MODEL_AXIS, mesh)
                    grad = collectives.all_reduce_sum(
                        X.T @ act, DATA_AXIS, mesh)
                    loss = collectives.all_reduce_sum(act, DATA_AXIS, mesh)
                    return coeff - grad, loss
                mesh = mesh_lib.create_mesh_2d(2)
                return body(mesh, mesh_lib.data_model_sharding(mesh).take(X),
                            mesh_lib.model_sharding(mesh).take(coeff))
        """, **PORT_SPMD}, []),
    "spec-consistency/unknown-layout-suppresses": _case("spec-consistency", {
        "models/opaque.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives

            def build(mesh, in_specs):
                def body(x):
                    return x
                return collectives.shard_map_over(mesh, in_specs, P(), fn=body)
        """, **JAX_SPMD}, {
        "models/opaque.py": """
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh, X):
                def body(mesh, x):
                    return x * collectives.axis_size(DATA_AXIS, mesh)
                return body(mesh, X)
        """, **PORT_SPMD}, []),
    "spec-consistency/suppression": _case("spec-consistency", {
        "models/mixed.py": """
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    # tpulint: disable=spec-consistency -- shard 0's value IS the result here, documented
                    return x * 2.0
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/mixed.py": """
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    # tpulint: disable=spec-consistency -- rank 0's value IS the result here, documented
                    return x * collectives.axis_size(DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [], suppressed=[9]),
    "spec-consistency/unreduced-output-behind-vmap": _case("spec-consistency", {
        "models/fleetbad.py": """
            import jax
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def member(x):
                    return x * 2.0
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=jax.vmap(member))
        """, **JAX_SPMD}, {
        "models/fleetbad.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def member(mesh, x):
                    return x * collectives.axis_size(DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                xs = mesh_lib.RankSharding(mesh, (None, DATA_AXIS)).take(X)
                return torch.stack([member(mesh, xs[m]) for m in range(xs.shape[0])])
        """, **PORT_SPMD}, [9]),
    "spec-consistency/negative-reduced-vmapped-body": _case("spec-consistency", {
        "models/fleetgood.py": """
            import jax
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def member(x):
                    return collectives.all_reduce_sum(x, DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=jax.vmap(member))
        """, **JAX_SPMD}, {
        "models/fleetgood.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def member(mesh, x):
                    return collectives.all_reduce_sum(x, DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                xs = mesh_lib.RankSharding(mesh, (None, DATA_AXIS)).take(X)
                return torch.stack([member(mesh, xs[m]) for m in range(xs.shape[0])])
        """, **PORT_SPMD}, []),

    # -- precision-determinism (TestPrecisionDeterminism) ----------------------
    "precision-determinism/downcast-before-reduce": _case("precision-determinism", {
        "models/bad.py": """
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    return collectives.all_reduce_sum(
                        x.astype(jnp.bfloat16), DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    return collectives.all_reduce_sum(
                        x.to(torch.bfloat16), DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [9]),
    "precision-determinism/downcast-through-assignment": _case("precision-determinism", {
        "models/bad.py": """
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    small = x.astype(jnp.float16)
                    return collectives.all_reduce_sum(small, DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/bad.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    small = x.half()
                    return collectives.all_reduce_sum(small, DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [10]),
    "precision-determinism/negative-f32-accumulator": _case("precision-determinism", {
        "models/good.py": """
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    return collectives.all_reduce_sum(
                        jnp.sum(x).astype(jnp.float32), DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/good.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    return collectives.all_reduce_sum(
                        torch.sum(x).to(torch.float32), DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, []),
    "precision-determinism/manual-ring-fold": _case("precision-determinism", {
        "models/bad.py": """
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def fold(x, n):
                acc = x
                for _ in range(n - 1):
                    x = collectives.ppermute_ring(x, DATA_AXIS)
                    acc = acc + x
                return acc
        """, **JAX_SPMD}, {
        "models/bad.py": """
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def fold(x, n, mesh):
                acc = x
                for _ in range(n - 1):
                    x = collectives.ppermute_ring(x, DATA_AXIS, mesh=mesh)
                    acc = acc + x
                return acc
        """, **PORT_SPMD}, [8]),
    "precision-determinism/negative-fold-in-collectives": _case("precision-determinism", {
        **JAX_SPMD,
        "parallel/collectives.py": JAX_SPMD["parallel/collectives.py"] + (
            "\n"
            "def ring_fold(x, n, axis_name=DATA_AXIS):\n"
            "    acc = x\n"
            "    for _ in range(n - 1):\n"
            "        x = ppermute_ring(x, axis_name)\n"
            "        acc = acc + x\n"
            "    return acc\n"),
    }, {
        **PORT_SPMD,
        "parallel/collectives.py": PORT_COLLECTIVES + (
            "\n"
            "def ring_fold(x, n, axis_name=DATA_AXIS, mesh=None):\n"
            "    acc = x\n"
            "    for _ in range(n - 1):\n"
            "        x = ppermute_ring(x, axis_name, mesh=mesh)\n"
            "        acc = acc + x\n"
            "    return acc\n"),
    }, []),
    "precision-determinism/suppression": _case("precision-determinism", {
        "models/mixed.py": """
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(mesh):
                def body(x):
                    # tpulint: disable=precision-determinism -- wire-format bf16, error budget documented
                    return collectives.all_reduce_sum(
                        x.astype(jnp.bfloat16), DATA_AXIS)
                return collectives.shard_map_over(
                    mesh, (P(DATA_AXIS),), P(), fn=body)
        """, **JAX_SPMD}, {
        "models/mixed.py": """
            import torch
            from ..parallel import mesh as mesh_lib
            from ..parallel import collectives
            from ..parallel.mesh import DATA_AXIS

            def build(X):
                def body(mesh, x):
                    # tpulint: disable=precision-determinism -- wire-format bf16, budget documented
                    return collectives.all_reduce_sum(
                        x.to(torch.bfloat16), DATA_AXIS, mesh)
                mesh = mesh_lib.default_mesh()
                return body(mesh, mesh_lib.data_sharding(mesh).take(X))
        """, **PORT_SPMD}, [], suppressed=[10]),

    # -- sharding-tags (TestShardingTags) --------------------------------------
    "sharding-tags/unknown-tag-at-call-site": _case("sharding-tags", {
        **JAX_SNAPSHOT,
        "models/bad.py": """
            from ..ckpt.snapshot import save_job_snapshot

            def checkpoint(path, carry):
                save_job_snapshot(
                    path, "job", {"model": carry},
                    specs={"model": "fully_sharded"},
                )
        """}, {
        **PORT_SNAPSHOT,
        "models/bad.py": """
            from ..ckpt.snapshot import save_job_snapshot

            def checkpoint(path, carry, mesh):
                save_job_snapshot(
                    path, "job", {"model": carry},
                    specs={"model": "fully_sharded"}, mesh=mesh,
                )
        """}, [7]),
    "sharding-tags/negative-known-tags-and-local-indirection": _case("sharding-tags", {
        **JAX_SNAPSHOT,
        "models/good.py": """
            from ..ckpt.snapshot import save_job_snapshot, stage_section

            def checkpoint(path, carry, shard):
                carry_specs = (
                    ("model", "replicated") if shard else "replicated"
                )
                save_job_snapshot(
                    path, "job", {"model": carry},
                    specs={"model": carry_specs, "rng": "host"},
                )
                stage_section(None, "model", specs=carry_specs)
        """}, {
        **PORT_SNAPSHOT,
        "models/good.py": """
            from ..ckpt.snapshot import save_job_snapshot, stage_section

            def checkpoint(path, carry, shard, mesh):
                carry_specs = (
                    ("model", "replicated") if shard else "replicated"
                )
                save_job_snapshot(
                    path, "job", {"model": carry},
                    specs={"model": carry_specs, "rng": "host"}, mesh=mesh,
                )
                stage_section(None, "model", specs=carry_specs, mesh=mesh)
        """}, []),
    "sharding-tags/suppression": _case("sharding-tags", {
        **JAX_SNAPSHOT,
        "models/bad.py": """
            from ..ckpt.snapshot import save_job_snapshot

            def checkpoint(path, carry):
                save_job_snapshot(
                    path, "job", {"model": carry},
                    # tpulint: disable=sharding-tags -- forward-compat tag, staged by a plugin
                    specs={"model": "fully_sharded"},
                )
        """}, {
        **PORT_SNAPSHOT,
        "models/bad.py": """
            from ..ckpt.snapshot import save_job_snapshot

            def checkpoint(path, carry, mesh):
                save_job_snapshot(
                    path, "job", {"model": carry},
                    # tpulint: disable=sharding-tags -- forward-compat tag, staged by a plugin
                    specs={"model": "fully_sharded"}, mesh=mesh,
                )
        """}, [], suppressed=[8]),

    # -- donation-after-use (TestDonationAfterUse, TestInterproceduralDonation) --
    "donation-after-use/read-after-donate": _case("donation-after-use", {
        "models/bad.py": JAX_DONATING_PRELUDE + (
            "def fit(carry, other):\n"
            "    out = _step_donating(carry, other)\n"
            "    return out + carry  # carry's buffer was donated\n"),
        **JAX_LAZYJIT}, {
        "models/bad.py": PORT_DONATING_PRELUDE + (
            "def fit(dev, other):\n"
            "    carry = _host(dev); carry.copy_(dev, non_blocking=True)\n"
            "    return other + carry.numpy()  # the copy may not have landed\n"),
        "models/__init__.py": ""}, [10]),
    "donation-after-use/through-gating-alias": _case("donation-after-use", {
        "models/bad.py": JAX_DONATING_PRELUDE + (
            "def fit(carry, other, ok):\n"
            "    step = _step_donating if ok else _step\n"
            "    out = step(carry, other)\n"
            "    return out + carry\n"),
        **JAX_LAZYJIT}, {
        "models/bad.py": PORT_DONATING_PRELUDE + (
            "def fit(dev, other, ok):\n"
            "    carry = _host(dev) if ok else torch.empty_like(dev, pin_memory=True)\n"
            "    carry.copy_(dev, non_blocking=True)\n"
            "    return other + carry.numpy()\n"),
        "models/__init__.py": ""}, [11]),
    "donation-after-use/negative-pingpong-rebind": _case("donation-after-use", {
        "models/good.py": JAX_DONATING_PRELUDE + (
            "def fit(carry, other):\n"
            "    carry = _step_donating(carry, other)  # rebound: fine\n"
            "    keep = _step(carry, other)            # borrowing: fine\n"
            "    return carry + keep + other\n"),
        **JAX_LAZYJIT}, {
        "models/good.py": PORT_DONATING_PRELUDE + (
            "def fit(dev, other):\n"
            "    carry = _host(dev); carry.copy_(dev, non_blocking=True)\n"
            "    carry = _step(torch.empty_like(dev), dev)  # rebound: a blocking copy\n"
            "    return carry.numpy() + other\n"),
        "models/__init__.py": ""}, []),
    "donation-after-use/suppression": _case("donation-after-use", {
        "models/bad.py": JAX_DONATING_PRELUDE + (
            "def fit(carry, other):\n"
            "    out = _step_donating(carry, other)\n"
            "    # tpulint: disable=donation-after-use -- CPU-only debug helper\n"
            "    return out + carry\n"),
        **JAX_LAZYJIT}, {
        "models/bad.py": PORT_DONATING_PRELUDE + (
            "def fit(dev, other):\n"
            "    carry = _host(dev); carry.copy_(dev, non_blocking=True)\n"
            "    # tpulint: disable=donation-after-use -- CPU-only debug helper\n"
            "    return other + carry.numpy()\n"),
        "models/__init__.py": ""}, [], suppressed=[11]),
    "donation-after-use/wrapper-poisons-caller": _case("donation-after-use", {
        "models/bad.py": """
            import jax

            def _impl(a, b):
                return a + b

            _step_donating = jax.jit(_impl, donate_argnums=(0,))

            def wrapper(carry, other):
                return _step_donating(carry, other)

            def fit(carry, other):
                out = wrapper(carry, other)
                return out + carry
        """, **JAX_LAZYJIT}, {
        "models/bad.py": """
            import torch

            def _host(like):
                return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)



            def wrapper(dev):
                host = _host(dev); host.copy_(dev, non_blocking=True); return host

            def fit(dev, other):
                carry = wrapper(dev)
                return other + carry.numpy()
        """, "models/__init__.py": ""}, [14]),
    "donation-after-use/negative-wrapper-result-use": _case("donation-after-use", {
        "models/good.py": """
            import jax

            def _impl(a, b):
                return a + b

            _step_donating = jax.jit(_impl, donate_argnums=(0,))

            def wrapper(carry, other):
                return _step_donating(carry, other)

            def fit(carry, other):
                carry = wrapper(carry, other)  # ping-pong rebind
                return carry
        """, **JAX_LAZYJIT}, {
        "models/good.py": """
            import torch

            def _host(like):
                return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

            def wrapper(dev):
                host = _host(dev); host.copy_(dev, non_blocking=True); return host

            def fit(dev, other):
                carry = wrapper(dev)
                torch.cuda.synchronize()
                return other + carry.numpy()
        """, "models/__init__.py": ""}, []),

    # -- collective-accounting (TestAccountingRules, the collective half) ------
    "collective-accounting/raw-collective-and-docstring": _case("collective-accounting", {
        "models/bad.py": """
            '''lax.psum(x, axis) in a docstring is fine.'''
            from jax import lax

            # lax.psum(x) in a comment is fine
            def f(x):
                return lax.psum(x, "data")
        """, **JAX_LAZYJIT}, {
        "models/bad.py": """
            '''dist.all_reduce(x) in a docstring is fine.'''
            import torch.distributed as dist

            # dist.all_reduce(x) in a comment is fine
            def f(x):
                return dist.all_reduce(x)
        """, "models/__init__.py": ""}, [7]),
    "collective-accounting/negative-out-of-scope-dir": _case("collective-accounting", {
        "parallel/infra.py": """
            from jax import lax

            def f(x):
                return lax.psum(x, "data")
        """, "parallel/__init__.py": "", **JAX_LAZYJIT}, {
        "parallel/infra.py": """
            import torch.distributed as dist

            def f(x):
                return dist.all_reduce(x)
        """, "parallel/__init__.py": ""}, []),
}

#: where the two packages' `data[0]` name different things by design: the
#: accounting rule's primitive (ROADMAP C.37)
PRIMITIVES = {"psum": "all_reduce"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_rule_flags_what_the_jax_rule_flags(tmp_path, case):
    spec = CASES[case]
    rule = spec["rule"]
    port = _lint(tmp_path, "port", spec["port"], [rule])
    ref = _lint(tmp_path, "jax", spec["jax"], [rule])
    ref_where = [(r, p, line, PRIMITIVES.get(d, d)) for r, p, line, d in _where(ref.findings)]
    assert _where(port.findings) == ref_where
    assert _where(port.suppressed) == _where(ref.suppressed)
    assert sorted({f.line for f in port.findings if f.rule == rule}) == spec["lines"]
    assert [f.line for f in port.suppressed] == spec["suppressed"]
    assert [f.line for f in port.findings if f.rule == "unused-suppression"] == spec["unused"]
    for f in port.findings + port.suppressed:  # the reading the JAX rule's message gives
        assert f.rule in (rule, "unused-suppression")


def test_messages_name_what_the_jax_messages_name(tmp_path):
    """The finding's message carries the facts the JAX tests read: the
    branch's line, the axis left varying, the constant bypassed, the
    wrapper of an interprocedural chain."""
    def one(case):
        spec = CASES[case]
        (finding,) = _lint(tmp_path / case.replace("/", "_"), "port", spec["port"],
                           [spec["rule"]]).findings
        return finding
    divergent = one("collective-divergence/axis-index-branch")
    assert divergent.data == ("divergent", "all_reduce_sum", 9) and "line 9" in divergent.message
    assert "data" in one("spec-consistency/replicated-output-never-reduced").message
    assert "model" in one("spec-consistency/2d-model-axis-unreduced").message
    assert one("spec-consistency/double-reduce").data[2] == "data"
    assert one("mesh-axis/gather-over-unsharded-axis").data[2] == "model"
    assert one("mesh-axis/unknown-axis-literal").data == ("unknown-axis", "dta")
    assert one("precision-determinism/downcast-before-reduce").data == (
        "downcast", "all_reduce_sum", "bfloat16")
    assert one("precision-determinism/downcast-through-assignment").data[2] == "float16"
    assert one("sharding-tags/unknown-tag-at-call-site").data == ("fully_sharded",)
    chain = one("donation-after-use/wrapper-poisons-caller")
    assert chain.data[0] == "carry" and "wrapper" in chain.message \
        and "non_blocking" in chain.message


def test_spec_arity_is_pinned_silent(tmp_path):
    """The JAX `spec-arity` finding has no counterpart: a ranked body's
    parameters are bound at its call sites, where Python checks the count
    (ROADMAP C.37). The JAX fixture still raises it; the port's
    transliteration, a call that leaves a parameter unbound, raises
    nothing."""
    jax_files = {"models/bad.py": """
        from jax.sharding import PartitionSpec as P
        from ..parallel import collectives
        from ..parallel.mesh import DATA_AXIS

        def build(mesh):
            def body(x, y):
                return collectives.all_reduce_sum(x + y, DATA_AXIS)
            return collectives.shard_map_over(
                mesh, (P(DATA_AXIS),), P(), fn=body)
    """, **JAX_SPMD}
    port_files = {"models/bad.py": """
        from ..parallel import mesh as mesh_lib
        from ..parallel import collectives
        from ..parallel.mesh import DATA_AXIS

        def build(X):
            def body(mesh, x, y):
                return collectives.all_reduce_sum(x + y, DATA_AXIS, mesh)
            mesh = mesh_lib.default_mesh()
            return body(mesh, mesh_lib.data_sharding(mesh).take(X))
    """, **PORT_SPMD}
    ref = _lint(tmp_path, "jax", jax_files, ["spec-consistency"])
    assert [f.data[0] for f in ref.findings] == ["spec-arity"]
    assert _lint(tmp_path, "port", port_files, ["spec-consistency"]).findings == []


def test_a_table_tag_without_constructor_or_dispatch(tmp_path):
    """TestShardingTags' table case: a tag in _SPEC_TAGS that no mesh
    constructor places and no dispatcher compares is flagged on the same
    lines in both packages (the port has two dispatchers, so the snapshot
    line is flagged for each)."""
    old = '"replicated", "data", "model", "host"'
    new = '"replicated", "data", "model", "host", "striped"'
    jax_files = {**JAX_SNAPSHOT,
                 "ckpt/snapshot.py": JAX_SNAPSHOT["ckpt/snapshot.py"].replace(old, new)}
    port_files = {**PORT_SNAPSHOT,
                  "ckpt/snapshot.py": PORT_SNAPSHOT["ckpt/snapshot.py"].replace(old, new)}
    ref = _lint(tmp_path, "jax", jax_files, ["sharding-tags"])
    port = _lint(tmp_path, "port", port_files, ["sharding-tags"])
    assert set(_where(port.findings)) == set(_where(ref.findings)) == {
        ("sharding-tags", "ckpt/snapshot.py", 2, "striped"),
        ("sharding-tags", "parallel/mesh.py", 1, "striped")}


# ---------------------------------------------------------------------------
# port-only cases
# ---------------------------------------------------------------------------

PORT_SPARSE = {
    "ops/__init__.py": "",
    "ops/sparsekernels.py": """
        def sparse_grad(indices, values, multiplier, coeff):
            return coeff
    """,
}

PORT_ONLY = {
    # ROADMAP C.30: every rank scatters the same gathered pairs through the
    # atomics kernel, and each gets other last bits
    "c30-gathered-pairs-through-sparse-grad": ("precision-determinism", """
        from ..ops import sparsekernels
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def step(mesh, idx, vals, mult, coeff):
            gi = collectives.all_gather(idx, DATA_AXIS, mesh=mesh)
            gv = collectives.all_gather(vals, DATA_AXIS, mesh=mesh)
            return sparsekernels.sparse_grad(gi, gv, mult, coeff)

        def fit(I, V, M, coeff):
            mesh = mesh_lib.default_mesh()
            sh = mesh_lib.data_sharding(mesh, 2)
            return step(mesh, sh.take(I), sh.take(V), M, coeff)
    """, [("precision-determinism", 10, "atomic-scatter")]),
    "c30-sanctioned-scatter-pairs": ("precision-determinism", """
        from ..ops import sparsekernels
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def step(mesh, idx, vals, mult, coeff):
            gi = collectives.all_gather(idx, DATA_AXIS, mesh=mesh)
            gv = collectives.all_gather(vals, DATA_AXIS, mesh=mesh)
            local = sparsekernels.sparse_grad(idx, vals, mult, coeff)
            summed = collectives.all_reduce_sum(local, DATA_AXIS, mesh)
            return collectives.scatter_pairs(gi, gv, 8) + summed

        def fit(I, V, M, coeff):
            mesh = mesh_lib.default_mesh()
            sh = mesh_lib.data_sharding(mesh, 2)
            return step(mesh, sh.take(I), sh.take(V), M, coeff)
    """, []),
    # ROADMAP C.36: rows split over `data` alone on a 2D mesh, the gradient
    # reduced over the flattened world: counted once per model shard
    "c36-replicated-fit-reduced-over-the-world": ("spec-consistency", """
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def step(mesh, x):
            g = x.sum(0)
            return collectives.all_reduce_sum(g, DATA_AXIS, mesh_lib.flatten(mesh))

        def fit(X):
            mesh = mesh_lib.create_mesh_2d(2)
            return step(mesh, mesh_lib.data_sharding(mesh, 2).take(X))
    """, [("spec-consistency", 8, "double-reduce")]),
    "c36-rows-over-the-flattened-world": ("spec-consistency", """
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def step(mesh, x):
            g = x.sum(0)
            return collectives.all_reduce_sum(g, DATA_AXIS, mesh)

        def fit(X):
            mesh = mesh_lib.flatten(mesh_lib.create_mesh_2d(2))
            return step(mesh, mesh_lib.data_sharding(mesh, 2).take(X))
    """, []),
    "cross-member-reduce-of-a-fleet": ("spec-consistency", """
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def members(mesh, state):
            total = collectives.all_reduce_sum(state * 2.0, DATA_AXIS, mesh)
            return collectives.all_gather(total, DATA_AXIS, mesh=mesh)

        def fit(state):
            mesh = mesh_lib.default_mesh()
            return members(mesh, mesh_lib.fleet_sharding(mesh).take(state))
    """, [("spec-consistency", 7, "cross-member-reduce")]),
    "fleet-members-gathered": ("spec-consistency", """
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def members(mesh, state):
            return collectives.all_gather(state * 2.0, DATA_AXIS, mesh=mesh)

        def fit(state):
            mesh = mesh_lib.default_mesh()
            return members(mesh, mesh_lib.fleet_sharding(mesh).take(state))
    """, []),
    "fleet-members-returned-as-placed": ("spec-consistency", """
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def members(mesh, state):
            return state * collectives.axis_size(DATA_AXIS, mesh)

        def fit(state):
            mesh = mesh_lib.default_mesh()
            return members(mesh, mesh_lib.fleet_sharding(mesh).take(state))
    """, []),
    # a rank-0 branch around a collective, and its repair: the outcome
    # broadcast outside the branch (coordinator.save_rank_cut)
    "rank-zero-broadcast-inside-its-branch": ("collective-divergence", """
        import torch.distributed as dist

        def commit(mesh, write):
            outcome = [None]
            if mesh.rank == 0:
                outcome = [write()]
                dist.broadcast_object_list(outcome, src=0)
            return outcome[0]
    """, [("collective-divergence", 8, "divergent")]),
    "rank-zero-broadcast-after-its-branch": ("collective-divergence", """
        import torch.distributed as dist

        def commit(mesh, write):
            outcome = [None]
            if mesh.rank == 0:
                outcome = [write()]
            dist.broadcast_object_list(outcome, src=0)
            return outcome[0]
    """, []),
    # a value a rank-0 branch sets varies, and the broadcast makes it uniform
    "rank-zero-value-claimed-before-its-broadcast": ("spec-consistency", """
        import torch.distributed as dist

        def commit(mesh, write):
            outcome = [None]
            if mesh.rank == 0:
                outcome = [write()]
            dist.barrier()
            return outcome[0]

        def run(write):
            from ..parallel import mesh as mesh_lib
            return commit(mesh_lib.default_mesh(), write)
    """, [("spec-consistency", 9, "unreduced-output")]),
    # an unknown tag that sharding_for_tag would place replicated in silence
    "unknown-tag-for-sharding-for-tag": ("sharding-tags", """
        from ..parallel import mesh as mesh_lib

        def restore(leaf, mesh):
            return mesh_lib.sharding_for_tag("fully_sharded", mesh, 2).take(leaf)
    """, [("sharding-tags", 5, "fully_sharded")]),
    # the port's donation hazard: a non_blocking readback read before its
    # sync, and after it; a pinned source refilled in a loop
    "non-blocking-read-before-sync": ("donation-after-use", """
        import torch

        def pull(dev):
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            return host.numpy().copy()
    """, [("donation-after-use", 7, "host")]),
    "non-blocking-read-after-sync": ("donation-after-use", """
        import torch

        def pull(dev):
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            torch.cuda.current_stream(dev.device).synchronize()
            return host.numpy().copy()
    """, []),
    "pinned-source-refilled-before-its-event": ("donation-after-use", """
        import torch

        def push(chunks, out):
            pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            for chunk in chunks:
                pinned.copy_(chunk)
                out.copy_(pinned, non_blocking=True)
            return out
    """, [("donation-after-use", 7, "pinned")]),
    "pinned-source-refilled-after-its-event": ("donation-after-use", """
        import torch

        def push(chunks, out):
            pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            for chunk in chunks:
                pinned.copy_(chunk)
                out.copy_(pinned, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            return out
    """, []),
    "readback-stored-by-one-method-read-by-another": ("donation-after-use", """
        import torch

        class Readback:
            def __init__(self, dev):
                self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
                self.host.copy_(dev, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()

            def peek(self):
                return self.host.numpy()

            def wait(self):
                self.event.synchronize()
                return self.host.numpy()
    """, [("donation-after-use", 12, "self.host")]),
}


@pytest.mark.parametrize("case", sorted(PORT_ONLY))
def test_port_only_cases(tmp_path, case):
    rule, text, expected = PORT_ONLY[case]
    report = _lint(tmp_path, "port", {"models/m.py": text, **PORT_SPMD, **PORT_SNAPSHOT,
                                      **PORT_SPARSE}, [rule])
    assert [(f.rule, f.line, f.data[0]) for f in report.findings] == expected


def test_the_interpreter_reads_callbacks_views_and_one_rank_arms(tmp_path):
    """A lambda handed to a callee runs on the callee's arguments; a store
    through a view reaches its buffer; the arm of a one-rank world makes
    nothing vary; an `if` arm that leaves a value unknown does not hide the
    arm that resolved it."""
    text = """
        import torch
        from ..parallel import collectives
        from ..parallel import mesh as mesh_lib
        from ..parallel.mesh import DATA_AXIS

        def run_epochs(state, epochs):
            return epochs(state)

        def step(mesh, X, state):
            grad = X.sum(0) + state
            return collectives.all_reduce_sum(grad, DATA_AXIS, mesh)

        def fit(mesh, X, resume):
            state = torch.zeros(4)
            if resume is not None:
                state = resume.restore()
            rows = mesh_lib.data_sharding(mesh, 2).take(X)
            buf = torch.zeros(8)
            view = buf[:4]
            view[:] = rows.sum(0)
            summed = collectives.all_reduce_sum(buf, DATA_AXIS, mesh)
            if mesh.size > 1:
                out = run_epochs(state, lambda st: step(mesh, rows, st))
            else:
                out = rows.sum(0)
            return out + summed

        def entry(X):
            return fit(mesh_lib.default_mesh(), X, None)
    """
    root = _tree(tmp_path, PORT, {"__init__.py": "", "models/m.py": text, **PORT_SPMD})
    project = engine.Project.load(root=str(root), scope=(PORT,))
    interp = spmd.interpretation(project)
    assert interp.of_kind("double-reduce", "unreduced-output", "divergent-collective") == []
    step = interp.body(f"{PORT}/models/m.py", "step")
    assert step is not None and step.resolved
    (binding,) = step.bindings
    assert binding.params["X"].axes == frozenset({"data"})
    assert binding.params["state"].axes == frozenset() and not binding.params["state"].unknown
    fit = interp.body(f"{PORT}/models/m.py", "fit")
    assert fit.collectives == 2 and fit.resolved


def test_the_collective_index_reads_the_wrappers_body():
    """The real collectives.py: every wrapper classified by its name or by
    the torch.distributed call its body reaches, axis and mesh positions
    from its signature."""
    index = spmd.collective_index(engine.Project.load())
    kinds = {name: w.kind for name, w in index.items()}
    assert kinds == {
        "all_reduce_sum": "reduce", "all_reduce_mean": "reduce", "all_reduce_max": "reduce",
        "all_reduce_min": "reduce", "all_gather": "gather", "reduce_scatter": "reduce",
        "ppermute_ring": "permute", "all_reduce_sum_chunked": "reduce",
        "sparse_all_reduce_sum": "reduce", "axis_size": "size", "axis_index": "index"}
    assert index["sparse_all_reduce_sum"].operand_params == (0, 1)
    assert all(w.default_axis == "data" for w in index.values())
    assert index["all_gather"].axis_param == 1 and index["all_gather"].mesh_param == 4


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_project():
    return engine.Project.load()


def test_the_interpretation_gate_reaches_every_ranked_loop(real_project):
    """chip_smoke's phase 15 gate, on the CPU: every per-rank loop phases
    16-17 drive is a ranked body the interpreter reached, with collective
    events and, at one call site or more, a collective whose operand it
    resolved to vary over the collective's axis."""
    report = spmd.gate(real_project)
    assert len(report) == len(spmd.RANKED_LOOPS) == 14
    missed = {name: row for name, row in report.items() if not (row[0] and row[1] and row[2])}
    assert missed == {}
    assert spmd.interpretation(real_project).counts().get("collective", 0) >= 20


def test_save_rank_cut_broadcasts_its_outcome_on_every_rank(real_project):
    """The repair of save_rank_cut: rank 0 keeps a commit failure, every
    rank reaches the one outcome broadcast, and rank 0 re-raises after it."""
    interp = spmd.interpretation(real_project)
    path = f"{PORT}/ckpt/coordinator.py"
    assert [e for e in interp.of_kind("divergent-collective") if e.path == path] == []
    broadcasts = [e for e in interp.of_kind("collective")
                  if e.path == path and e.detail == "broadcast_object_list"]
    assert len(broadcasts) == 2


CANARIES = {
    "collective-accounting": (
        "models/clustering/kmeans.py",
        "        summed = collectives.all_reduce_sum(torch.cat([sums.reshape(-1), counts]), "
        "mesh=mesh)",
        "        summed = torch.distributed.all_reduce(torch.cat([sums.reshape(-1), counts]))",
        0, "all_reduce"),
    "mesh-axis": (
        "parallel/overlap.py",
        "    return collectives.all_gather(block, mesh_lib.MODEL_AXIS, mesh=mesh)",
        '    return collectives.all_gather(block, "model", mesh=mesh)',
        0, "axis-bypass"),
    # a reduce under `if mesh.axis_index(DATA_AXIS) == 0:`;
    # the finding is the collective's line, the message names the branch's
    "collective-divergence": (
        "parallel/overlap.py",
        "    if sparse_pairs:\n        return collectives.sparse_all_reduce_sum(",
        "    if mesh.axis_index(mesh_lib.DATA_AXIS) == 0:\n"
        "        return collectives.sparse_all_reduce_sum(",
        1, "divergent"),
    "spec-consistency": (
        "models/clustering/kmeans.py",
        "        summed = collectives.all_reduce_sum(torch.cat([sums.reshape(-1), counts]), "
        "mesh=mesh)",
        "        summed = collectives.all_reduce_sum(collectives.all_reduce_sum(torch.cat("
        "[sums.reshape(-1), counts]), mesh=mesh), mesh=mesh)",
        0, "double-reduce"),
    "precision-determinism": (
        "models/clustering/kmeans.py",
        "        summed = collectives.all_reduce_sum(torch.cat([sums.reshape(-1), counts]), "
        "mesh=mesh)",
        "        summed = collectives.all_reduce_sum(torch.cat([sums.reshape(-1), counts])"
        ".half(), mesh=mesh)",
        0, "downcast"),
    "sharding-tags": (
        "models/clustering/kmeans.py",
        'epoch=epoch + 1, specs={"rng": "host"}, meta={"numBatches": nb},',
        'epoch=epoch + 1, specs={"rng": "hosted"}, meta={"numBatches": nb},',
        0, "hosted"),
    "donation-after-use": (
        "utils/packing.py",
        "        host_t.copy_(flat, non_blocking=True)\n",
        "        host_t.copy_(flat, non_blocking=True); early = host_t.numpy()\n",
        0, "host_t"),
}


@pytest.mark.parametrize("rule", sorted(CANARIES))
def test_each_rule_fires_on_its_planted_fault_and_nowhere_else(tmp_path, rule):
    """A copy of a real module with a one-line planted fault, linted in the
    real tree in place of the module: the rule fires on that line and
    nowhere else (the rest of the tree is clean, tests/test_torch_tpulint.py)."""
    rel, old, new, offset, data0 = CANARIES[rule]
    project = engine.Project.load()
    original = project.module_at(f"{PORT}/{rel}")
    assert original.source.count(old) == 1
    text = original.source.replace(old, new)
    line = text[:text.index(new)].count("\n") + 1 + offset
    copy = tmp_path / Path(rel).name
    copy.write_text(text)
    mutated = SourceModule.load(str(copy), original.path)
    project.modules[project.modules.index(original)] = mutated
    project._by_path[mutated.path] = mutated
    project._by_module_name[mutated.module_name] = mutated
    report = engine.run(rules=[engine.get_rule(rule)], project=project)
    assert [(f.path, f.line, f.data[0]) for f in report.findings if f.rule == rule] == [
        (mutated.path, line, data0)]
    if rule == "collective-divergence":
        assert f"line {line - 1}" in report.findings[0].message
