"""The mesh of ranks and its data-axis layout helpers.

Port of flink_ml_tpu/parallel/mesh.py. The JAX package drives every device
from one process: a `jax.sharding.Mesh` over the devices, arrays placed
with a `NamedSharding`, and XLA inserting the collectives. The port runs
SPMD the way torch.distributed does: one process per rank, each running
the same fit on its own rows, and a `Mesh` here is this rank's view of
that world: the process group, the axis names, the shape, this rank and
the device it computes on.

- `create_mesh` (JAX `:28`) and `default_mesh` (`:48`): the initialized
  world (every rank on the `data` axis), else a one-rank mesh of the local
  device; `set_default_mesh`, `use_mesh` (`:56-70`);
- `num_data_shards`, `num_model_shards` (`:120-126`);
- `pad_to_multiple`, `shard_batch`, `replicate` (`:191-230`): a rank takes
  exactly the rows the JAX layout gives its device, so the port's R-rank
  fit can be held against the JAX fit on an R-device mesh;
- `host_slice_bounds` (`:270`);
- `init_distributed` (`:286`, `jax.distributed.initialize`): joins this
  process to a world with an explicit address, world size and rank.
  Nothing on a card's machine tells a program of its cluster.

The backend rule (`choose_backend`), with no fallback: `backend=None` is
NCCL when every rank has a card of its own and gloo for ranks on the CPU.
NCCL refuses two ranks of one communicator on the same card, so a world
whose ranks share a card names `backend="gloo"` itself; NCCL asked for in
such a world raises, naming the cause. The port never switches backend on
its own.

`parallel/launcher.py` starts the R processes of a world on one machine
(the JAX package needs none: one process drives all its devices).

The 2D `(data, model)` layout (JAX `:72-118`): `create_mesh_2d(m)` lays
the world out as (R / m) x m with the `model` axis innermost, so rank
r = i * m + j has data index i and model index j, and a host's contiguous
slab of ranks owns whole data rows. Each axis reduces over its own
sub-group: one `model` group a data row, one `data` group a model column,
made by every rank with `torch.distributed.new_group` in one fixed order
(a rank that skips a group, even one it is not in, deadlocks the world
until the collective timeout). `Mesh.axis_group`, `Mesh.axis_index`.

A sharding here is what a JAX `NamedSharding` means for one rank: the
block of each dimension this rank holds (`RankSharding.bounds`, `take`),
the sharded dimension zero-padded to a multiple of its axis. So
`model_sharding` is the contiguous trailing slice [j * d_local,
(j + 1) * d_local) a rank of model index j owns, `data_model_sharding`
its rows by that slice, `fleet_sharding` the whole members it owns (the
member axis riding `data`: N / R members a rank, over replicated data).

The shrink helpers work over ranks where the JAX ones work over devices:
`host_groups` cuts the ranks into contiguous hosts, `form_mesh_over` is
the mesh of a world relaunched over the surviving hosts' ranks (a
torch.distributed group cannot drop a dead member: parallel/
supervisor.py relaunches), `shard_axis_for_tag` the axis a snapshot tag
splits.
"""

from __future__ import annotations

import datetime
import math
import socket
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0

#: the timeout `init_distributed` gave this process's collectives
_timeout_s = DEFAULT_TIMEOUT_S


def collective_timeout_s() -> float:
    """Seconds a collective of this process waits for the other ranks."""
    return _timeout_s


class Mesh:
    """This rank's view of an SPMD world: `group` (a torch.distributed
    process group, or None for a mesh of one rank), `axis_names`, `shape`
    (axis -> size, in axis order), `rank` (this process's index in the
    mesh, row-major over `shape`: on a 2D mesh r = data * m + model),
    `axis_groups` (axis -> its sub-group holding this rank, for a mesh with
    more than one axis of size > 1) and `device` (where it computes: the
    one given, else `config.device()` when asked)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], group=None,
                 rank: int = 0, device: Optional[torch.device] = None,
                 axis_groups: Optional[Dict[str, object]] = None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.group = group
        self.rank = int(rank)
        self.axis_groups = dict(axis_groups or {})
        self._device = None if device is None else torch.device(device)

    @property
    def device(self) -> torch.device:
        from .. import config

        return self._device if self._device is not None else config.device()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self) -> Dict[str, int]:
        """This rank's index on every axis (row-major, last axis innermost)."""
        out, rest = {}, self.rank
        for name in reversed(self.axis_names):
            rest, out[name] = divmod(rest, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def axis_index(self, axis_name: str) -> int:
        """This rank's index on `axis_name` (0 for an axis it lacks)."""
        return self.coords().get(axis_name, 0)

    def axis_group(self, axis_name: str):
        """The process group that reduces over `axis_name` for this rank:
        None for an axis of one, the mesh's group when every other axis is
        of one, else the axis's sub-group."""
        if self.shape.get(axis_name, 1) <= 1:
            return None
        if self.group is None:
            raise ValueError(
                f"{self} spans {self.size} ranks but has no process group: a mesh of ranks is "
                "made over an initialized world (create_mesh, create_mesh_2d)")
        if all(self.shape[a] == 1 for a in self.axis_names if a != axis_name):
            return self.group
        if axis_name not in self.axis_groups:
            raise ValueError(f"{self} has no process group for its {axis_name!r} axis")
        return self.axis_groups[axis_name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


_default_mesh: Optional[Mesh] = None


def _world():
    """(group, size, rank) of the initialized world, or (None, 1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def create_mesh(axis_names: Sequence[str] = (DATA_AXIS,), shape: Optional[Sequence[int]] = None,
                group=None) -> Mesh:
    """A mesh over the ranks of `group` (default: the initialized world,
    else this process alone). Without `shape` every rank goes on the first
    axis and the others get size 1, as the JAX package lays devices out. A
    shape with two axes of size > 1 makes their sub-groups (`_subgroups`):
    every rank of `group` must call this with the same shape."""
    import torch.distributed as dist

    if group is None:
        group, size, rank = _world()
    else:
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    if shape is None:
        shape = [size] + [1] * (len(axis_names) - 1)
    if math.prod(shape) != size:
        raise ValueError(f"Mesh shape {list(shape)} does not match {size} ranks")
    wide = [s for s in shape if s > 1]
    axis_groups = _subgroups(group, tuple(axis_names), tuple(int(s) for s in shape), rank) \
        if len(wide) > 1 else None
    return Mesh(axis_names, shape, group if size > 1 else None, rank, axis_groups=axis_groups)


#: (group, axis names, shape) -> every sub-group of that layout, made once
_SUBGROUPS: Dict[Tuple, Dict[str, List]] = {}


def _subgroups(group, axis_names: Tuple[str, ...], shape: Tuple[int, ...], rank: int):
    """This rank's sub-group of each axis of a multi-axis layout of
    `group`. Every rank creates every sub-group, in one order (axis by
    axis, group by group), members it is not in included: torch.distributed
    makes a group only when all ranks of the world call `new_group`."""
    import torch.distributed as dist

    key = (id(group), axis_names, shape)
    if key not in _SUBGROUPS:
        grid = np.arange(math.prod(shape)).reshape(shape)
        timeout = datetime.timedelta(seconds=_timeout_s)
        backend = dist.get_backend(group)
        made: Dict[str, List] = {}
        for a, name in enumerate(axis_names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
            made[name] = [(set(int(r) for r in line),
                           dist.new_group([_group_to_global(group, int(r)) for r in line],
                                          timeout=timeout, backend=backend))
                          for line in lines]
        _SUBGROUPS[key] = made
    return {name: next(g for members, g in lines if rank in members)
            for name, lines in _SUBGROUPS[key].items()}


def _group_to_global(group, rank: int) -> int:
    import torch.distributed as dist

    return rank if group is None or group is dist.group.WORLD else \
        dist.get_global_rank(group, rank)


def create_mesh_2d(model_shards: int, num_hosts: Optional[int] = None, group=None) -> Mesh:
    """The 2D `(data, model)` training mesh over the initialized world (or
    `group`): (R / model_shards) x model_shards with the `model` axis
    innermost, so every host slab of contiguous ranks owns whole data rows
    (a feature-axis reduce stays inside a host, the data-axis reduce is
    the one that crosses hosts). With `num_hosts` every host slab must
    hold a multiple of `model_shards` ranks. Collective over the world:
    every rank calls it with the same arguments."""
    import torch.distributed as dist

    size = _world()[1] if group is None else dist.get_world_size(group)
    model_shards = int(model_shards)
    if model_shards < 1:
        raise ValueError(f"model_shards must be >= 1, got {model_shards}")
    if size % model_shards:
        raise ValueError(f"model_shards={model_shards} does not divide {size} ranks")
    if num_hosts is not None:
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        for h, ranks in enumerate(np.array_split(np.arange(size), num_hosts)):
            if len(ranks) % model_shards:
                raise ValueError(
                    f"host {h} owns {len(ranks)} of {size} ranks — not a multiple of "
                    f"model_shards={model_shards}; a data-axis row would straddle hosts "
                    "(re-factor the grid or change the host count)")
    return create_mesh((DATA_AXIS, MODEL_AXIS), shape=(size // model_shards, model_shards),
                       group=group)


def default_mesh() -> Mesh:
    """The process-wide default mesh: every rank of the world on `data`."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = create_mesh()
    return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


@contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    global _default_mesh
    prev = _default_mesh
    _default_mesh = mesh
    try:
        yield mesh
    finally:
        _default_mesh = prev


def num_data_shards(mesh: Mesh) -> int:
    return int(mesh.shape.get(DATA_AXIS, 1))


def num_model_shards(mesh: Mesh) -> int:
    return int(mesh.shape.get(MODEL_AXIS, 1))


def flatten(mesh: Mesh) -> Mesh:
    """The ranks of `mesh` as one `data` axis over its group: the layout of
    a fit whose coefficient every rank holds whole (a dense fit,
    `sparse_2d="off"`, a stream fit, a fleet). On a mesh with a model axis
    such a fit splits its rows over every rank and reduces once over the
    world, so no two ranks repeat the same work and every rank ends with
    the same bits (ROADMAP C.36). `mesh` itself when it has no model axis."""
    if num_model_shards(mesh) <= 1:
        return mesh
    return Mesh((DATA_AXIS,), (mesh.size,), mesh.group, mesh.rank, device=mesh._device)


class RankSharding(NamedTuple):
    """What a JAX `NamedSharding(mesh, spec)` places on this rank: `spec`
    names, per dimension, the mesh axis that splits it (None: whole). A
    split dimension is zero-padded to a multiple of its axis and cut into
    equal contiguous blocks, block i on the ranks of axis index i."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def bounds(self, shape: Sequence[int]) -> List[Tuple[int, int]]:
        """[start, stop) of this rank's block of each dimension of an array
        of `shape` (stop may pass the length: those are padding)."""
        out = []
        for dim, length in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            n = self.mesh.shape.get(axis, 1) if axis is not None else 1
            if n <= 1:
                out.append((0, int(length)))
                continue
            block = -(-int(length) // n)
            start = self.mesh.axis_index(axis) * block
            out.append((start, start + block))
        return out

    def take(self, array, pad_value=0):
        """This rank's block of a host array or a tensor (on its device),
        padded with `pad_value` where it passes the array's end."""
        bounds = self.bounds(np.shape(array))
        block = array[tuple(slice(start, min(stop, length)) for (start, stop), length
                            in zip(bounds, np.shape(array)))]
        short = [(0, stop - start - min(stop - start, max(0, length - start)))
                 for (start, stop), length in zip(bounds, np.shape(array))]
        if not any(after for _, after in short):
            return block
        if isinstance(block, torch.Tensor):
            pad = [p for _, after in reversed(short) for p in (0, after)]
            return torch.nn.functional.pad(block, pad, value=pad_value)
        return np.pad(np.asarray(block), short, constant_values=pad_value)


def data_sharding(mesh: Mesh, ndim: int = 1) -> RankSharding:
    """The leading (batch) dimension over `data`, the rest whole: the
    layout of training examples."""
    return RankSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> RankSharding:
    """Every rank holds the whole array."""
    return RankSharding(mesh, ())


def model_sharding(mesh: Mesh, ndim: int = 1) -> RankSharding:
    """The trailing (feature) dimension over `model`: the contiguous slice
    [j * d_local, (j + 1) * d_local) of a rank of model index j, d padded
    to a multiple of the model shards. Replicated without a model axis."""
    if MODEL_AXIS not in mesh.axis_names:
        return replicated_sharding(mesh)
    return RankSharding(mesh, (None,) * (ndim - 1) + (MODEL_AXIS,))


def data_model_sharding(mesh: Mesh, ndim: int = 2) -> RankSharding:
    """The 2D layout of rank >= 2 operands: the leading dimension over
    `data`, the trailing one over `model`, the middle ones whole. The data
    layout on a mesh without a model axis."""
    if ndim < 2:
        raise ValueError(
            f"data_model_sharding needs ndim >= 2 (got {ndim}); rank-1 operands are either "
            "data_sharding or model_sharding")
    if MODEL_AXIS not in mesh.axis_names:
        return data_sharding(mesh, ndim)
    return RankSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 2) + (MODEL_AXIS,))


def fleet_sharding(mesh: Mesh, ndim: int = 2) -> RankSharding:
    """The leading FLEET axis of per-member state ([N, ...] carries and
    results) over `data`: a rank owns N / shards whole members, and the
    training data is replicated (each member sees every example). The
    spec is `data_sharding`'s; the two axes mean different things: a
    reduce over `data` in the fleet regime would add across members,
    which no fleet path may ever do."""
    return RankSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def fleet_axis_shardable(mesh: Mesh, fleet_size: int) -> bool:
    """Whether a fleet of `fleet_size` members can shard its member axis
    over this mesh's data axis: more than one shard, dividing the fleet
    evenly (the JAX rule)."""
    shards = num_data_shards(mesh)
    return shards > 1 and fleet_size % shards == 0


def pad_to_multiple(array, multiple: int, axis: int = 0, pad_value=0):
    """Pad `axis` of a host array up to a multiple of `multiple`, so it
    divides evenly across shards. Returns (padded, original_length)."""
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(np.asarray(array), pad_width, constant_values=pad_value), n


def shard_bounds(rows: int, mesh: Mesh) -> Tuple[int, int]:
    """[start, stop) of this rank's block of `rows` padded to a multiple of
    the data shards: the rows its device holds under the JAX package's
    `data_sharding` (stop may pass `rows`: those are padding)."""
    return data_sharding(mesh).bounds((rows,))[0]


def shard_batch(mesh: Mesh, array, pad_value=0) -> Tuple[torch.Tensor, int]:
    """This rank's block of `array` padded to a multiple of the data shards,
    on the mesh's device: the rows its device holds under the JAX package's
    `shard_batch`. A host array is sliced on the host and uploaded once; a
    tensor is sliced on its own device. Returns (block, original_row_count);
    the padding rows must be masked by the caller (weight 0)."""
    from ..data.devicecache import stage_rank_rows

    n = int(array.shape[0])
    start, stop = shard_bounds(n, mesh)
    return stage_rank_rows(array, np.arange(start, stop), n, pad_value, mesh.device), n


def replicate(mesh: Mesh, array) -> torch.Tensor:
    """A host array on this rank's device: every rank holds the whole."""
    from .prefetch import to_device

    return to_device(np.asarray(array), mesh.device)


def host_slice_bounds(length: int, num_hosts: int) -> List[Tuple[int, int]]:
    """Per-host [start, stop) bounds splitting `length` rows across
    `num_hosts` (np.array_split semantics: uneven lengths allowed, empty
    trailing slices when hosts outnumber elements)."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    base, extra = divmod(int(length), int(num_hosts))
    bounds = []
    start = 0
    for h in range(num_hosts):
        stop = start + base + (1 if h < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def host_groups(mesh: Mesh, num_hosts: int) -> List[List[int]]:
    """The mesh's ranks as `num_hosts` contiguous groups (host i owns group
    i; np.array_split semantics: trailing groups may be one rank short,
    and hosts beyond the rank count own none). On a 2D mesh built for
    `num_hosts` hosts every group is whole data rows."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    return [[int(r) for r in g] for g in np.array_split(np.arange(mesh.size), num_hosts)]


def form_mesh_over(groups: Sequence[Sequence[int]], axis_names: Sequence[str] = (DATA_AXIS,),
                   model_shards: int = 1) -> Mesh:
    """The survivor mesh after the supervisor quarantines a host: the mesh
    over the concatenation of the surviving hosts' rank groups (from
    `host_groups`; empty groups contribute nothing). A torch.distributed
    group cannot drop a member, so the survivors run in a world relaunched
    with exactly their rank count (parallel/supervisor.py), and this is
    that world's mesh, its ranks renumbered in group order."""
    ranks = [r for g in groups for r in g]
    if not ranks:
        raise ValueError("cannot form a mesh over zero surviving ranks")
    size = _world()[1]
    if size != len(ranks):
        raise ValueError(
            f"the surviving hosts hold {len(ranks)} ranks but this world has {size}: "
            "a mesh over survivors is formed in a world relaunched over exactly them")
    if MODEL_AXIS in axis_names or model_shards > 1:
        return create_mesh_2d(model_shards)
    return create_mesh(axis_names)


def shard_axis_for_tag(tag: str, ndim: int) -> Optional[int]:
    """The array axis a sharding-spec tag splits, or None for whole-array
    tags (`replicated` / `host`): `data` the leading dimension, `model` the
    trailing one (`data_sharding`, `model_sharding`)."""
    if ndim <= 0:
        return None
    if tag == "data":
        return 0
    if tag == "model":
        return ndim - 1
    return None


def sharding_for_tag(tag: str, mesh: Mesh, ndim: int) -> RankSharding:
    """The placement of a leaf tagged `tag` on this rank of `mesh`: `data`
    its block of the leading dimension, `model` its trailing slice,
    anything else the whole leaf."""
    if tag == "data":
        return data_sharding(mesh, max(1, ndim))
    if tag == "model":
        return model_sharding(mesh, max(1, ndim))
    return replicated_sharding(mesh)


def device_key(device: torch.device) -> str:
    """What makes two ranks' devices the same card: the host and the card's
    UUID (its index where the properties carry none); "cpu" for the CPU."""
    if device.type != "cuda":
        return f"{socket.gethostname()}:cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    return f"{socket.gethostname()}:cuda:{uuid if uuid is not None else index}"


def choose_backend(requested: Optional[str], device_type: str, keys: Sequence[str]) -> str:
    """The backend rule, with no fallback. `keys` are every rank's
    `device_key`. None picks NCCL when every rank has a card of its own and
    gloo on the CPU; NCCL on the CPU or on a card two ranks share raises,
    as does a card world that asks for nothing while its ranks share a card
    (it must name gloo itself)."""
    shared = len(set(keys)) < len(keys)
    if requested not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {requested!r}; one of 'nccl', 'gloo'")
    if device_type != "cuda":
        if requested == "nccl":
            raise ValueError("backend 'nccl' needs a CUDA device; ranks on the CPU use 'gloo'")
        return "gloo"
    if shared and requested != "gloo":
        raise ValueError(
            f"{len(keys)} ranks share {len(set(keys))} card(s): NCCL refuses two ranks of one "
            "communicator on the same card; name backend='gloo' for a world whose ranks share "
            "a card")
    return requested or "nccl"


def init_distributed(coordinator_address: Optional[str] = None, *, world_size: int = 1,
                     rank: int = 0, backend: Optional[str] = None,
                     device: Optional[torch.device] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[str]:
    """Join this process to a world of `world_size` ranks as `rank`, through
    the rendezvous at `coordinator_address` (`tcp://host:port` or
    `file:///path`). No-op when the address is None (one process), as in
    the JAX package. `device` is this rank's device (default
    `config.device()`); on a card it becomes the current device. The ranks
    exchange their `device_key`s through the rendezvous store before the
    process group exists, and `choose_backend` decides. Every collective
    waits at most `timeout_s` for the other ranks. Returns the backend."""
    import torch.distributed as dist

    global _timeout_s
    if coordinator_address is None:
        return None
    from .. import config

    device = torch.device(device) if device is not None else config.device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    store, rank, world_size = next(dist.rendezvous(
        coordinator_address, rank=int(rank), world_size=int(world_size), timeout=timeout))
    store.set(f"flink_ml_tpu_torch/device/{rank}", device_key(device))
    keys = [store.get(f"flink_ml_tpu_torch/device/{r}").decode() for r in range(world_size)]
    chosen = choose_backend(backend, device.type, keys)
    kwargs = {"device_id": device} if chosen == "nccl" else {}
    dist.init_process_group(chosen, store=store, rank=rank, world_size=world_size,
                            timeout=timeout, **kwargs)
    _timeout_s = float(timeout_s)
    _SUBGROUPS.clear()
    set_default_mesh(None)
    return chosen
