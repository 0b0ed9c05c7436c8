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

The 2D `(data, model)` layout, the fleet-sharded regime and the
supervisor's shrink over fewer devices are ROADMAP A.10b:
`create_mesh_2d`, `model_sharding`, `data_model_sharding`,
`fleet_sharding`, `host_groups`, `form_mesh_over` and
`shard_axis_for_tag` raise NotImplementedError naming it.
`fleet_axis_shardable` keeps the one answer the port's fleet relies on
(no mesh of one rank can shard a fleet) and raises for a wider mesh.
"""

from __future__ import annotations

import datetime
import math
import socket
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0

_A10B = "ROADMAP A.10b"

#: the timeout `init_distributed` gave this process's collectives
_timeout_s = DEFAULT_TIMEOUT_S


def collective_timeout_s() -> float:
    """Seconds a collective of this process waits for the other ranks."""
    return _timeout_s


class Mesh:
    """This rank's view of an SPMD world: `group` (a torch.distributed
    process group, or None for a mesh of one rank), `axis_names`, `shape`
    (axis -> size, in axis order), `rank` (this process's index on the
    data axis) and `device` (where it computes: the one given, else
    `config.device()` when asked)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], group=None,
                 rank: int = 0, device: Optional[torch.device] = None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.group = group
        self.rank = int(rank)
        self._device = None if device is None else torch.device(device)

    @property
    def device(self) -> torch.device:
        from .. import config

        return self._device if self._device is not None else config.device()

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
    axis and the others get size 1, as the JAX package lays devices out."""
    import torch.distributed as dist

    if group is None:
        group, size, rank = _world()
    else:
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    if shape is None:
        shape = [size] + [1] * (len(axis_names) - 1)
    if math.prod(shape) != size:
        raise ValueError(f"Mesh shape {list(shape)} does not match {size} ranks")
    return Mesh(axis_names, shape, group if size > 1 else None, rank)


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


def check_data_parallel(mesh: Mesh, what: str) -> None:
    """Refuse a mesh whose `model` axis splits the features: that layout is
    A.10b."""
    if num_model_shards(mesh) > 1:
        raise NotImplementedError(
            f"{what} on a mesh with a {MODEL_AXIS!r} axis of {num_model_shards(mesh)} shards "
            f"(the feature-sharded 2D layout) is not ported yet ({_A10B})")


def _a10b(name: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"mesh.{name}: the 2D feature-sharded layout, the fleet-sharded regime and the "
            f"supervisor's shrink over devices are not ported yet ({_A10B})")
    missing.__name__ = name
    missing.__doc__ = f"JAX `mesh.{name}`; not ported yet ({_A10B})."
    return missing


create_mesh_2d = _a10b("create_mesh_2d")
model_sharding = _a10b("model_sharding")
data_model_sharding = _a10b("data_model_sharding")
fleet_sharding = _a10b("fleet_sharding")
host_groups = _a10b("host_groups")
form_mesh_over = _a10b("form_mesh_over")
shard_axis_for_tag = _a10b("shard_axis_for_tag")


def fleet_axis_shardable(mesh: Mesh, fleet_size: int) -> bool:
    """Whether a fleet can shard its member axis over this mesh: never on
    one rank (the JAX rule, `shards > 1`); the regime itself is A.10b."""
    if num_data_shards(mesh) <= 1:
        return False
    raise NotImplementedError(f"the fleet-sharded regime is not ported yet ({_A10B})")


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
    shards = num_data_shards(mesh)
    block = -(-int(rows) // shards)
    start = mesh.rank * block
    return start, start + block


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
    set_default_mesh(None)
    return chosen
